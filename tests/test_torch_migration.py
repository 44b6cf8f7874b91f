"""KV migration of the port (``engine/migration.py``, the engine's
export/import seam, ``engine/handoff.py``) against the reference, on
reduced smollm-360m (f32, V = 512) with the reference's weights bridged
across.

What must hold: a request that prefills on one engine and decodes on
another gives the stream — tokens and finish reasons — of a run that
never moved, for every exporter/importer pair of caches (contiguous,
paged), loops (overlapped, sequential), sampler placements (device, host
pool) and packages: a payload the reference writes is resumed by the
port, and one the port writes is resumed by the reference. The payload
round-trips through bytes bitwise, bf16 included, in both directions.
The mirrored tests of the reference's suite (malformed payloads, stats
counters, the handoff scheduler, the pipeline's refusal) keep their
names. The reference's never-migrated streams are computed once.
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import SamplingConfig as JS, SHVSConfig as JSH, get_arch
from repro.engine import (Engine as JEngine, EngineConfig as JECfg,
                          KVPayload as JPayload, Request as JRequest)
from repro.models.model import Model as JModel
from repro_torch.config import (SamplingConfig as TS, SHVSConfig as TSH,
                                get_arch as tget)
from repro_torch.engine import (Engine as TEngine, EngineConfig as TECfg,
                                HandoffScheduler, KVPayload, PipelineConfig,
                                PipelineEngine, Request as TRequest)
from repro_torch.models.bridge import from_jax_params

ARCH = "smollm-360m"
ENGINE = dict(max_batch=4, max_seq_len=96, algorithm="shvs", k_cap=64,
              block_size=16)


@pytest.fixture(scope="module")
def weights():
    cfg = get_arch(ARCH).reduced()
    p = JModel(cfg).init(jax.random.PRNGKey(0))
    return cfg, p, from_jax_params(jax.tree_util.tree_map(np.asarray, p))


def _sampling(S, seeded):
    # the penalties read the histograms that travel in the payload
    return (S(temperature=0.9, top_k=40, seed=123, repetition_penalty=1.1,
              presence_penalty=0.3, frequency_penalty=0.2) if seeded
            else S(greedy=True, repetition_penalty=1.1,
                   presence_penalty=0.3))


def _requests(R, S, seeded=True, n=3, max_new=12):
    return [R(request_id=10 + i, prompt=[7 + i, 8, 9, 3 * i + 1] * (i + 1),
              max_new_tokens=max_new, sampling=_sampling(S, seeded))
            for i in range(n)]


def _jax_engine(weights, cache="paged", overlap=True):
    cfg, p, _ = weights
    return JEngine(cfg, p, JECfg(shvs=JSH(hot_size=128), cache=cache,
                                 overlap=overlap, **ENGINE))


def _port_engine(weights, cache="paged", overlap=True, telemetry=None,
                 **kw):
    _, _, tp = weights
    return TEngine(tget(ARCH).reduced(), tp,
                   TECfg(shvs=TSH(hot_size=128), cache=cache,
                         overlap=overlap, **ENGINE, **kw), device="cpu",
                   telemetry=telemetry)


def _streams(reqs):
    return {r.request_id: (list(r.output), r.finish_reason) for r in reqs}


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's never-migrated streams, seeded and greedy."""
    out = {}
    for seeded in (True, False):
        eng = _jax_engine(weights)
        reqs = _requests(JRequest, JS, seeded)
        list(eng.generate(reqs))
        eng.close()
        out[seeded] = _streams(reqs)
    return out


def _prefill_on(a, reqs, min_out=2):
    """Prefill + a few decode steps on ``a``, then the flush boundary."""
    a.submit(reqs)
    for _ in range(50):
        a.step()
        if all(len(r.output) >= min_out for r in reqs):
            break
    a.flush()


def _decode_on(b, landed):
    for _ in range(200):
        if not (b.scheduler.has_work or b.in_flight):
            break
        b.step()
    b.flush()
    assert all(r.should_stop() for r in landed)
    return _streams(landed)


def _migrate(a, b, reqs, to_payload=lambda p: p):
    """Export every request from ``a`` at the flush boundary, import into
    ``b`` through ``to_payload``, decode to completion on ``b``."""
    try:
        _prefill_on(a, reqs)
        landed = [b.import_request(to_payload(a.export_request(r.request_id)))
                  for r in reqs]
        return _decode_on(b, landed)
    finally:
        a.close()
        b.close()


# -- migration identity (port -> port) ----------------------------------------

@pytest.mark.parametrize("cache_a,cache_b,overlap,seeded,via_bytes", [
    ("paged", "paged", True, True, False),
    ("paged", "paged", True, False, False),
    ("paged", "paged", False, True, False),
    ("paged", "paged", False, False, False),
    ("paged", "contiguous", True, True, False),
    ("contiguous", "paged", True, True, False),
    ("contiguous", "contiguous", False, False, True),
    ("paged", "paged", True, True, True),
])
def test_migration_identity(weights, reference, cache_a, cache_b, overlap,
                            seeded, via_bytes):
    """A request that prefills on one port engine and decodes on another
    gives the reference's never-migrated stream — under both loops,
    seeded and greedy, across layouts, and through ``to_bytes`` (the live
    request discarded) — and so does the port engine that never moved."""
    if not via_bytes:
        eng = _port_engine(weights, cache_a, overlap)
        reqs = _requests(TRequest, TS, seeded)
        list(eng.generate(reqs))
        eng.close()
        assert _streams(reqs) == reference[seeded]
    conv = (lambda p: KVPayload.from_bytes(p.to_bytes())) if via_bytes \
        else (lambda p: p)
    got = _migrate(_port_engine(weights, cache_a, overlap),
                   _port_engine(weights, cache_b, overlap),
                   _requests(TRequest, TS, seeded), conv)
    assert got == reference[seeded]


@pytest.mark.parametrize("mode_a,mode_b", [("host", "device"),
                                           ("device", "host")])
def test_migration_across_sampler_placements(weights, reference, mode_a,
                                             mode_b):
    """The histograms live on the host under host placement and on the
    device otherwise: an export from one placement imports into the other
    and resumes the never-migrated stream."""
    got = _migrate(
        _port_engine(weights, "paged", sampler_mode=mode_a, samplers=2),
        _port_engine(weights, "contiguous", sampler_mode=mode_b, samplers=2),
        _requests(TRequest, TS, True))
    assert got == reference[True]


# -- payloads across the two packages ----------------------------------------

@pytest.mark.parametrize("cache,seeded", [("contiguous", False),
                                          ("paged", True)])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_cross_framework_payloads(weights, reference, direction, cache,
                                  seeded):
    """The reference exports and the port imports through the bytes, and
    the reverse; the resumed stream is the never-migrated one."""
    jax_first = direction == "jax_to_torch"
    a = _jax_engine(weights, cache) if jax_first else \
        _port_engine(weights, cache)
    b = _port_engine(weights, cache) if jax_first else \
        _jax_engine(weights, cache)
    Reader = KVPayload if jax_first else JPayload
    reqs = _requests(JRequest, JS, seeded) if jax_first else \
        _requests(TRequest, TS, seeded)
    got = _migrate(a, b, reqs, lambda p: Reader.from_bytes(p.to_bytes()))
    assert got == reference[seeded]


def test_payload_bf16_roundtrip_is_bitwise():
    """bf16 K/V widen to f32 for the wire (exact) and narrow back on load:
    the port's own round trip, and both packages reading each other's
    bytes, give the exported bits (numpy needs no bfloat16 here)."""
    rng = np.random.default_rng(0)
    k = rng.normal(0, 3, (2, 5, 2, 8)).astype(ml_dtypes.bfloat16)
    v = rng.normal(0, 3, (2, 5, 2, 8)).astype(ml_dtypes.bfloat16)
    bits = lambda a: torch.from_numpy(a.view(np.int16))
    meta = dict(request_id=1, prompt=[1, 2, 3], output=[4, 5],
                max_new_tokens=8, eos_token=None, prompt_offset=0,
                arrival_time=0.0, kv_len=5, last_token=5, next_pos=2)
    tk, tv = (bits(a).view(torch.bfloat16) for a in (k, v))
    tp = KVPayload(sampling=TS(seed=9), k=tk, v=tv,
                   prompt_counts=torch.zeros(16, dtype=torch.int32),
                   output_counts=torch.zeros(16, dtype=torch.int32), **meta)
    assert tp.nbytes == 2 * k.size * 2
    q = KVPayload.from_bytes(tp.to_bytes())
    assert q.k.dtype == torch.bfloat16 and q.v.dtype == torch.bfloat16
    assert torch.equal(q.k.view(torch.int16), tk.view(torch.int16))
    assert torch.equal(q.v.view(torch.int16), tv.view(torch.int16))
    # reference -> port
    jp = JPayload(sampling=JS(seed=9), k=k, v=v,
                  prompt_counts=np.zeros(16, np.int32),
                  output_counts=np.zeros(16, np.int32), **meta)
    q = KVPayload.from_bytes(jp.to_bytes())
    assert torch.equal(q.k.view(torch.int16), bits(k))
    assert torch.equal(q.v.view(torch.int16), bits(v))
    assert q.sampling == TS(seed=9)
    # port -> reference
    r = JPayload.from_bytes(tp.to_bytes())
    assert r.k.dtype == k.dtype
    assert np.array_equal(r.k.view(np.uint16), k.view(np.uint16))
    assert np.array_equal(r.v.view(np.uint16), v.view(np.uint16))
    assert r.sampling == JS(seed=9)


# -- payload format and error surface (mirrors of the reference's) -----------

def test_payload_bytes_roundtrip(weights):
    a = _port_engine(weights, "paged")
    try:
        rs = _requests(TRequest, TS, True, n=1)
        _prefill_on(a, rs, min_out=1)
        p = a.export_request(rs[0].request_id)
        blob = p.to_bytes()
        assert isinstance(blob, bytes) and len(blob) > 0
        assert p.nbytes == 2 * p.k.numel() * 4 > 0
        q = KVPayload.from_bytes(blob)
        for name in ("k", "v", "prompt_counts", "output_counts"):
            assert torch.equal(getattr(q, name), getattr(p, name)), name
        assert q.k.dtype == p.k.dtype
        assert (q.request_id, q.prompt, q.output, q.kv_len, q.last_token,
                q.next_pos) == (p.request_id, p.prompt, p.output, p.kv_len,
                                p.last_token, p.next_pos)
        assert q.sampling == p.sampling
        assert q.request is None       # bytes never carry the live object
        assert p.request is rs[0] and rs[0].kv_payload is p
    finally:
        a.close()


def test_export_unknown_or_finished_request_raises(weights):
    eng = _port_engine(weights, "paged")
    try:
        with pytest.raises(KeyError):
            eng.export_request(424242)
        rs = _requests(TRequest, TS, True, n=1, max_new=2)
        for _ in eng.generate(rs):
            pass
        assert rs[0].should_stop()
        # a finished request has left its slot — nothing to export
        with pytest.raises(KeyError):
            eng.export_request(rs[0].request_id)
    finally:
        eng.close()


def test_import_rejects_malformed_payloads(weights):
    a = _port_engine(weights, "paged")
    b = _port_engine(weights, "paged", overlap=False)
    try:
        rs = _requests(TRequest, TS, True, n=1)
        _prefill_on(a, rs, min_out=1)
        p = a.export_request(rs[0].request_id)
        with pytest.raises(ValueError):
            b.import_request(dataclasses.replace(p, k=p.k[:, :-1]))
        long_kv = p.k.new_zeros((p.k.shape[0], 1000) + tuple(p.k.shape[2:]))
        with pytest.raises(ValueError):
            b.import_request(dataclasses.replace(p, kv_len=1000, k=long_kv,
                                                 v=long_kv))
        with pytest.raises(ValueError):
            b.import_request(dataclasses.replace(p, next_pos=p.next_pos + 3))
        with pytest.raises(ValueError):
            b.import_request(dataclasses.replace(
                p, prompt_counts=p.prompt_counts[:-1]))
        assert not b.scheduler.waiting
    finally:
        a.close()
        b.close()


def test_export_refuses_caches_with_other_leaves(weights):
    """Only the plain attention leaves {k, v, len, pos} migrate, as in the
    reference."""
    eng = _port_engine(weights, "contiguous")
    try:
        rs = _requests(TRequest, TS, True, n=1)
        _prefill_on(eng, rs, min_out=1)
        eng.cache["conv_state"] = torch.zeros(1)
        with pytest.raises(RuntimeError, match="plain attention caches"):
            eng.export_request(rs[0].request_id)
        del eng.cache["conv_state"]
    finally:
        eng.close()


def test_pipeline_engine_refuses_migrations(weights):
    _, _, tp = weights
    eng = PipelineEngine(tget(ARCH).reduced(), tp, PipelineConfig(
        stages=2, max_batch=4, max_seq_len=96, algorithm="shvs",
        shvs=TSH(hot_size=128), k_cap=64, sampler_mode="host", samplers=2),
        device="cpu")
    try:
        r = _requests(TRequest, TS, True, n=1)[0]
        r.kv_payload = object()
        with pytest.raises(ValueError, match="single-stage"):
            eng.submit([r])
    finally:
        eng.close()


def test_migration_stats_counters(weights):
    a, b = _port_engine(weights, "paged"), _port_engine(weights, "paged")
    try:
        free0 = a.migration_stats()["free_blocks"]
        rs = _requests(TRequest, TS, True, n=2)
        _prefill_on(a, rs, min_out=1)
        for r in rs:
            b.import_request(a.export_request(r.request_id))
        sa, sb = a.migration_stats(), b.migration_stats()
        assert sa["migrations_out"] == 2 and sa["migrations_in"] == 0
        # the exporter's pool is whole again: export released every block
        assert sa["free_blocks"] == free0
        # imports are queued, not yet installed (install rides admission)
        assert sb["pending_imports"] == 2 and sb["migrations_in"] == 0
        _decode_on(b, rs)
        sb = b.migration_stats()
        assert sb["migrations_in"] == 2 and sb["migrations_out"] == 0
        assert sb["pending_imports"] == 0
        assert sb["free_blocks"] == free0
        assert all(r.handoff_count == 1 for r in rs)
    finally:
        a.close()
        b.close()


def test_contiguous_engine_reports_no_block_pool(weights):
    eng = _port_engine(weights, "contiguous")
    try:
        assert eng.migration_stats()["free_blocks"] is None
    finally:
        eng.close()


def test_migration_spans_are_traced(weights):
    """Export and import each record a ``kv_migrate`` span with the KV
    bytes, and the install a ``handoff_wait`` span from the export stamp."""
    from repro_torch.obs import StepTracer, Telemetry
    tel = Telemetry(tracer=StepTracer(capacity=1024, enabled=True))
    _migrate(_port_engine(weights, "paged", telemetry=tel),
             _port_engine(weights, "contiguous", telemetry=tel),
             _requests(TRequest, TS, True, n=1))
    spans = [(e.kind, dict(e.args)) for e in tel.tracer.events()
             if e.kind in ("kv_migrate", "handoff_wait")]
    assert sorted((k, a.get("direction")) for k, a in spans) == [
        ("handoff_wait", None), ("kv_migrate", "in"), ("kv_migrate", "out")]
    assert all(a["bytes"] > 0 for k, a in spans if k == "kv_migrate")


# -- the handoff scheduler ----------------------------------------------------

@pytest.mark.parametrize("cache,chunk", [("paged", 0), ("paged", 8),
                                         ("contiguous", 0)])
def test_handoff_scheduler_identity(weights, reference, cache, chunk):
    """The in-process two-engine scheduler migrates every request at its
    first committed token and the streams stay the never-migrated ones
    (with chunked prefill on the prefill engine too)."""
    hs = HandoffScheduler(_port_engine(weights, cache, prompt_chunk=chunk),
                          _port_engine(weights, cache, prompt_chunk=chunk))
    try:
        rs = _requests(TRequest, TS, True)
        out = {r.request_id: [] for r in rs}
        for ev in hs.generate(rs):
            if ev.token is not None:
                out[ev.request_id].append(ev.token)
        assert hs.migrated == len(rs)
        assert all(r.handoff_count == 1 for r in rs)
        assert {k: (v, "length") for k, v in out.items()} == \
            reference[True]
    finally:
        hs.close()
