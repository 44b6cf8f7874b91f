"""The traffic generator: deterministic from the seed, the mix files'
distributions, and the same work block by block for every seed."""
from collections import Counter

import numpy as np
import pytest

from perfbench.harness import spec, traffic


def take(mix, seed, vocab, n, slots=0):
    it = traffic.generate(mix, seed, vocab, slots)
    return [next(it) for _ in range(n)]


def mix(name):
    import json
    path = spec.BENCH_DIR / "traffic" / f"{name}.json"
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", ["chat", "decode"])
def test_same_seed_same_inputs(name):
    a = take(mix(name), 2 ** 31 + 77, 49155, 200, slots=128)
    b = take(mix(name), 2 ** 31 + 77, 49155, 200, slots=128)
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_new == y.max_new
        assert x.contract == y.contract
        assert np.array_equal(x.prompt, y.prompt)
    c = take(mix(name), 2 ** 31 + 78, 49155, 200, slots=128)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["chat", "decode"])
def test_lengths_and_ids_in_range(name):
    m = mix(name)
    V = 65536
    for s in take(m, 5, V, 640):
        assert m["prompt"]["min"] <= len(s.prompt) <= m["prompt"]["max"]
        assert 1 <= s.max_new <= m["output"]["max"]
        assert s.prompt.min() >= 1 and s.prompt.max() < V


def test_chat_lognormal_medians():
    m = mix("chat")
    specs = take(m, 11, 49155, 64 * 40)
    assert abs(np.median([len(s.prompt) for s in specs]) / 256 - 1) < 0.1
    assert abs(np.median([s.max_new for s in specs]) / 128 - 1) < 0.1
    gaps = np.diff([0.0] + [s.due for s in specs])
    assert abs(gaps.mean() * m["rate_rps"] - 1) < 0.05


@pytest.mark.parametrize("name", ["chat", "decode"])
def test_every_seed_offers_the_same_blocks(name):
    m = mix(name)
    n = m["block"]
    a = take(m, 1, 49155, 3 * n)
    b = take(m, 2 ** 31 + 5, 49155, 3 * n)
    for k in range(3):
        blk_a, blk_b = a[k * n:(k + 1) * n], b[k * n:(k + 1) * n]
        key = lambda s: (len(s.prompt), s.max_new,
                         tuple(sorted(s.contract.items())))
        assert Counter(map(key, blk_a)) == Counter(map(key, blk_b))
        if m["kind"] == "open_loop":
            assert blk_a[-1].due == pytest.approx(blk_b[-1].due)


@pytest.mark.parametrize("name", ["chat", "decode"])
def test_contract_shares_exact_per_block(name):
    m = mix(name)
    n = m["block"]
    specs = take(m, 3, 49155, n)
    counts = Counter(s.greedy for s in specs)
    greedy_share = [c["share"] for c in m["contracts"] if c.get("greedy")][0]
    assert counts[True] == round(greedy_share * n)


def test_first_batch_takes_residual_lengths():
    m = mix("decode")
    slots = 128
    base = take(m, 9, 49155, slots, slots=0)
    res = take(m, 9, 49155, slots + 64, slots=slots)
    changed = sum(a.max_new != b.max_new for a, b in zip(base, res))
    assert changed >= slots * 0.9
    assert all(1 <= b.max_new <= m["output"]["max"] for b in res[:slots])
    assert min(b.max_new for b in res[:slots]) < m["output"]["min"]
    assert all(b.max_new >= m["output"]["min"] for b in res[slots:])
