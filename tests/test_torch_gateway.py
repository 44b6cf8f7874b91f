"""The port's gateway (``repro_torch.gateway``) and the serve surface of
disaggregation (``launch/serve.py --gateway / --disaggregate``), held to
the reference on the CPU.

* The stdlib parts mirror the reference's tests under their names: the
  byte codec and its pool, goodput under an SLO, the router's policy
  (least-loaded, affinity, backpressure, draining, the decode placement
  of a split fleet) and the fleet's role validation.
* Wire identity over live sockets — kept to three: seeded streams over
  HTTP/SSE from a fleet of 1 and of 2 single-stage port replicas equal
  the reference engine's in-process streams (the reference's smoke model,
  its weights bridged across); and ``serve --gateway --disaggregate`` (1
  prefill + 1 decode paged replica, every request migrating at its first
  token) serves, over the port's own client, the port's in-process
  streams.
* ``serve --disaggregate`` serves its batch through the handoff scheduler
  with the single engine's streams; both flags ask for the card by
  default and raise without one.
"""
import asyncio
import os
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.config import get_arch
from repro.gateway import smoke as jsmoke
from repro.models.model import Model as JModel
from repro_torch.config import SamplingConfig as TS, SHVSConfig as TSH
from repro_torch.engine import Engine as TEngine, EngineConfig as TECfg
from repro_torch.engine import Request as TRequest
from repro_torch.gateway import (ByteCodec, CodecPool, GatewayServer,
                                 ReplicaFleet, Router, WireTrace, get_codec,
                                 goodput_under_slo, smoke as tsmoke)
from repro_torch.gateway.client import stream_completion
from repro_torch.launch import serve as tserve
from repro_torch.models.bridge import from_jax_params, save_npz

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"
MAX_NEW = 8


# -- codec -------------------------------------------------------------------

def test_byte_codec_roundtrip():
    codec = ByteCodec()
    for text in ("hello world", "naïve café ☕", ""):
        toks = codec.encode(text)
        assert all(1 <= t <= 256 for t in toks)
        assert codec.decode(toks) == text
    assert codec.vocab_limit == 257
    assert isinstance(get_codec("byte"), ByteCodec)


def test_byte_codec_out_of_range_ids_are_replaced():
    codec = ByteCodec()
    toks = [300] + [ord(c) + 1 for c in "hi"]
    assert codec.decode(toks) == "�hi"


def test_codec_pool_async():
    pool = CodecPool(ByteCodec(), workers=2)

    async def roundtrip():
        loop = asyncio.get_running_loop()
        toks = await pool.encode_async(loop, "quartz")
        return await pool.decode_async(loop, toks)

    try:
        assert asyncio.run(roundtrip()) == "quartz"
    finally:
        pool.close()


# -- goodput math ------------------------------------------------------------

def _trace(ttft_s, tpot_s, n_tokens=4, finished=True):
    tr = WireTrace(request_id=0, arrival=100.0)
    tr.first_event = 100.0 + ttft_s
    tr.n_tokens = n_tokens
    tr.token_times = [tr.first_event + i * tpot_s for i in range(n_tokens)]
    tr.finish = tr.token_times[-1] if finished else None
    return tr


def test_goodput_under_slo_counts_only_requests_meeting_both_targets():
    traces = [_trace(0.050, 0.010), _trace(0.500, 0.010),
              _trace(0.050, 0.200), _trace(0.050, 0.010, finished=False)]
    g = goodput_under_slo(traces, slo_ttft_ms=250, slo_tpot_ms=100,
                          window_s=2.0)
    assert g["requests_met"] == 1 and g["requests_total"] == 4
    assert g["attainment"] == pytest.approx(0.25)
    assert g["goodput_rps"] == pytest.approx(0.5)


def test_goodput_single_token_requests_judged_on_ttft_alone():
    g = goodput_under_slo([_trace(0.050, 0.0, n_tokens=1)], slo_ttft_ms=250,
                          slo_tpot_ms=1e-9, window_s=1.0)
    assert g["requests_met"] == 1


# -- router policy (fake replicas: pure policy, no engines) ------------------

class FakeReplica:
    def __init__(self, name, capacity=2, load=0):
        self.name = name
        self.capacity = capacity
        self.load = load
        self.admitted = []
        self.handoff = None

    def try_submit(self, request, sink, on_done=None, session_id=None):
        if self.load >= self.capacity:
            return False
        self.load += 1
        self.admitted.append(request)
        return True

    def reserve(self):
        if self.load >= self.capacity:
            return False
        self.load += 1
        return True

    def unreserve(self):
        self.load -= 1

    def set_handoff(self, hook):
        self.handoff = hook


def test_router_least_loaded_choice():
    reps = [FakeReplica("a", load=2, capacity=9),
            FakeReplica("b", load=0, capacity=9),
            FakeReplica("c", load=1, capacity=9)]
    res = Router(reps).submit("req", sink=None)
    assert res.status == "ok" and res.replica is reps[1]


def test_router_tie_breaks_by_index():
    reps = [FakeReplica("a"), FakeReplica("b")]
    assert Router(reps).submit("req", sink=None).replica is reps[0]


def test_router_affinity_stickiness():
    reps = [FakeReplica("a", capacity=9), FakeReplica("b", capacity=9)]
    router = Router(reps)
    reps[0].load = 5
    assert router.submit("r1", None, session_id="s1").replica is reps[1]
    reps[0].load = 0
    for _ in range(3):
        assert router.submit("rn", None, session_id="s1").replica is reps[1]
    assert router.submit("r2", None, session_id="s2").replica is reps[0]


def test_router_strict_affinity_refuses_instead_of_migrating():
    reps = [FakeReplica("a", capacity=9), FakeReplica("b", capacity=1)]
    router = Router(reps)
    reps[0].load = 5
    assert router.submit("r1", None, session_id="s1").replica is reps[1]
    reps[0].load = 0
    res = router.submit("r2", None, session_id="s1")
    assert res.status == "busy" and res.replica is None
    assert router.rejected_busy == 1
    assert not reps[0].admitted


def test_router_busy_when_every_replica_full():
    reps = [FakeReplica("a", capacity=1, load=1),
            FakeReplica("b", capacity=1, load=1)]
    router = Router(reps, retry_after=2.5)
    res = router.submit("req", None)
    assert res.status == "busy" and res.retry_after == 2.5
    assert router.rejected_busy == 1


def test_router_draining_after_stop_accepting():
    router = Router([FakeReplica("a")])
    router.stop_accepting()
    assert router.submit("req", None).status == "draining"
    assert router.rejected_draining == 1


def test_router_affinity_table_is_bounded():
    router = Router([FakeReplica("a", capacity=10_000)], max_sessions=4)
    for i in range(10):
        router.submit(f"r{i}", None, session_id=f"s{i}")
    assert len(router._affinity) <= 4


def test_place_decode_least_loaded_and_pins_session():
    dec = [FakeReplica("d0", capacity=9, load=3),
           FakeReplica("d1", capacity=9, load=1)]
    router = Router([FakeReplica("p0", capacity=9)], decode_replicas=dec)
    assert router.place_decode("sess") is dec[1]
    dec[0].load = 0
    assert router.place_decode("sess") is dec[1]
    assert router.place_decode(None) is dec[0]


def test_place_decode_strict_affinity_refuses_when_sticky_full():
    dec = [FakeReplica("d0", capacity=9), FakeReplica("d1", capacity=1)]
    router = Router([FakeReplica("p0", capacity=9)], decode_replicas=dec)
    dec[0].load = 5
    assert router.place_decode("s1") is dec[1]
    dec[0].load = 0
    dec[1].load = dec[1].capacity
    assert router.place_decode("s1") is None
    assert not dec[0].admitted


def test_place_decode_none_without_decode_pool_or_while_draining():
    assert Router([FakeReplica("a")]).place_decode("s") is None
    dis = Router([FakeReplica("p")],
                 decode_replicas=[FakeReplica("d", capacity=9)])
    dis.stop_accepting()
    assert dis.place_decode("s") is None


def test_disaggregated_admission_skips_sticky_and_targets_prefill():
    pre = [FakeReplica("p0", capacity=9, load=2),
           FakeReplica("p1", capacity=9, load=0)]
    dec = [FakeReplica("d0", capacity=9)]
    router = Router(pre, decode_replicas=dec)
    assert router.place_decode("s1") is dec[0]
    res = router.submit("req", None, session_id="s1")
    assert res.status == "ok" and res.replica is pre[1]
    assert not dec[0].admitted


def test_router_for_fleet_installs_handoff_hooks():
    pre, dec = [FakeReplica("p0"), FakeReplica("p1")], [FakeReplica("d0")]
    router = Router.for_fleet(SimpleNamespace(prefill_replicas=pre,
                                              decode_replicas=dec))
    assert all(r.handoff == router.place_decode for r in pre)
    colo = Router.for_fleet(SimpleNamespace(
        prefill_replicas=[FakeReplica("a")], decode_replicas=[]))
    assert colo.decode_replicas is None


class _FakeEngine:
    def close(self):
        pass


def test_fleet_role_validation():
    with pytest.raises(AssertionError):
        ReplicaFleet([_FakeEngine(), _FakeEngine()],
                     roles=["prefill", "prefill"])
    with pytest.raises(AssertionError):
        ReplicaFleet([_FakeEngine()], roles=["decode"])
    fleet = ReplicaFleet([_FakeEngine(), _FakeEngine(), _FakeEngine()],
                         roles=["prefill", "decode", "decode"])
    assert fleet.disaggregated
    assert [r.name for r in fleet.prefill_replicas] == ["replica0"]
    assert [r.name for r in fleet.decode_replicas] == ["replica1",
                                                       "replica2"]
    colo = ReplicaFleet([_FakeEngine()])
    assert not colo.disaggregated and colo.prefill_replicas == colo.replicas


# -- wire identity over live sockets -----------------------------------------

def _payload(i, prompt):
    return {"prompt": prompt, "max_tokens": MAX_NEW, "temperature": 0.9,
            "top_k": 40, "top_p": 0.95, "repetition_penalty": 1.1,
            "seed": 7000 + i, "session_id": f"s{i}"}


async def _wire(host, port):
    return await asyncio.gather(*[
        stream_completion(host, port, _payload(i, p))
        for i, p in enumerate(jsmoke.PROMPTS)])


def _check_wire(results, want):
    for p, res in zip(jsmoke.PROMPTS, results):
        assert res.status == 200 and res.error is None, (p, res.error)
        assert res.finish_reason == "length"
        assert res.tokens == want[p], f"wire stream for {p!r} diverged"


@pytest.fixture(scope="module")
def smoke_weights():
    """The reference's smoke model at its seed, and the same weights on
    the port's side."""
    p = JModel(jsmoke.smoke_model()).init(jax.random.PRNGKey(0))
    return from_jax_params(jax.tree_util.tree_map(np.asarray, p))


@pytest.fixture(scope="module")
def smoke_reference():
    """The reference engine's in-process streams of the smoke prompts."""
    return jsmoke.reference_streams(MAX_NEW)


def _smoke_engine(params):
    """``gateway.smoke.smoke_engine``'s engine over the bridged weights."""
    return TEngine(tsmoke.smoke_model(), params, TECfg(
        max_batch=4, max_seq_len=96, algorithm="reference",
        shvs=TSH(hot_size=tsmoke.VOCAB // 4), k_cap=256, overlap=True,
        sampler_mode="device"), device="cpu")


@pytest.mark.parametrize("replicas", (1, 2))
def test_wire_identity_over_http(smoke_weights, smoke_reference, replicas):
    """Seeded streams over live HTTP/SSE from 1 and 2 port replicas equal
    in-process generation (the reference engine's, which the port's equals
    too); every replica engine is closed by the drain."""
    eng = _smoke_engine(smoke_weights)
    codec = ByteCodec()
    reqs = [TRequest(request_id=900 + i, prompt=codec.encode(p),
                     max_new_tokens=MAX_NEW, sampling=TS(
                         temperature=0.9, top_k=40, top_p=0.95,
                         repetition_penalty=1.1, seed=7000 + i))
            for i, p in enumerate(jsmoke.PROMPTS)]
    list(eng.generate(reqs))
    eng.close()
    assert {p: r.output for p, r in zip(jsmoke.PROMPTS, reqs)} == \
        smoke_reference
    fleet = ReplicaFleet([_smoke_engine(smoke_weights)
                          for _ in range(replicas)], capacity=4)

    async def drive():
        gw = GatewayServer(fleet)
        await gw.serve(port=0)
        try:
            return await _wire(gw.host, gw.port)
        finally:
            await gw.shutdown()

    _check_wire(asyncio.run(drive()), smoke_reference)
    assert all(r.engine._closed for r in fleet.replicas)
    if replicas == 2:
        assert all(r.served > 0 for r in fleet.replicas)


@pytest.fixture(scope="module")
def arch_weights(tmp_path_factory):
    """Reduced smollm-360m at the seed of the reference's ``serve.py``, as
    an npz for ``serve --weights``."""
    p = JModel(get_arch(ARCH).reduced()).init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("weights") / "smollm_reduced.npz"
    save_npz(path, jax.tree_util.tree_map(np.asarray, p))
    return str(path)


def _serve_streams(build_engine, Request, Sampling, **kw):
    """The serve script's engine streaming the smoke prompts in process,
    with the sampling contract the gateway gives ``_payload``."""
    eng = build_engine(arch=ARCH, reduced=True, algorithm="shvs", batch=8,
                       max_seq=256, **kw)
    codec = ByteCodec()
    reqs = [Request(request_id=i, prompt=codec.encode(p),
                    max_new_tokens=MAX_NEW, sampling=Sampling(
                        temperature=0.9, top_k=40, top_p=0.95,
                        repetition_penalty=1.1, seed=7000 + i))
            for i, p in enumerate(jsmoke.PROMPTS)]
    list(eng.generate(reqs))
    eng.close()
    return {p: r.output for p, r in zip(jsmoke.PROMPTS, reqs)}


def test_serve_gateway_disaggregated_wire_identity(arch_weights):
    """``serve --gateway --disaggregate`` on the CPU: one prefill and one
    decode replica on the paged cache; every request migrates at its
    first token; the wire streams (the port's own client) equal the port
    engine's in-process streams (held to the reference's by
    ``test_torch_serve.py``). SIGINT drains and exits 0."""
    want = _serve_streams(tserve.build_engine, TRequest, TS,
                           weights=arch_weights, device="cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--weights", arch_weights,
         "--gateway", "--disaggregate", "--replicas", "2", "--cache",
         "paged", "--http-port", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "gateway listening on http://127.0.0.1:" in line, line
        port = int(line.split("127.0.0.1:")[1].split()[0])
        results = asyncio.run(_wire("127.0.0.1", port))
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    _check_wire(results, want)
    assert "1 prefill + 1 decode replicas on cpu" in line
    assert "'migrations_out': 3" in out and "'migrations_in': 3" in out, out


def test_serve_disaggregate_batch_matches_single_engine(arch_weights):
    """``serve --disaggregate`` (no gateway): every request of the batch
    migrates through the handoff scheduler and the streams equal the
    single engine's; chunked prefill (8) on the paged cache."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--weights",
            arch_weights, "--requests", "6", "--max-new", "6", "--seed", "3",
            "--cache", "paged", "--prompt-chunk", "8"]
    reqs, rep, stats = tserve.run_disaggregated_batch(
        tserve.parse_args(argv + ["--disaggregate"]))
    assert rep["migrated"] == 6 and all(r.handoff_count == 1 for r in reqs)
    assert stats[0]["migrations_out"] == 6 == stats[1]["migrations_in"]
    eng = tserve.build_engine(**tserve._engine_kwargs(tserve.parse_args(argv)))
    single = tserve.synth_requests(6, eng.cfg.vocab_size, 6, seed=3)
    list(eng.generate(single))
    eng.close()
    assert [(r.output, r.finish_reason) for r in reqs] == \
        [(r.output, r.finish_reason) for r in single]


@pytest.mark.parametrize("flag", ["--gateway", "--disaggregate"])
def test_serve_flags_default_to_the_card(flag):
    """Both entry points build on ``--device cuda`` unless told otherwise,
    and raise where torch sees no card (nothing falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--reduced", flag, "--http-port", "0"])
