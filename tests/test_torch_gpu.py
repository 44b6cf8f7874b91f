"""Card-only tests of the PyTorch port (marker ``gpu``): each CUDA kernel
against its plain version, and the engine on CUDA against the engine on
the CPU. They skip where torch sees no CUDA device; this file imports
neither JAX nor the reference package, so it runs on a machine without
them:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import SHVSConfig, get_arch
from repro_torch.engine.engine import Engine, EngineConfig
from repro_torch.kernels import fused_kernel, penalty_kernel, ref, shvs_kernel
from repro_torch.launch.serve import synth_requests
from repro_torch.models.model import Model

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(B, V, seed, dev, hot):
    """Seeded inputs at a logit scale where the top-K mass stays clear of
    1.0 in f32 (ROADMAP 'Faults')."""
    rs = np.random.default_rng(seed)
    sparse = lambda: (rs.integers(0, 3, (B, V)) *
                      (rs.random((B, V)) < 0.1)).astype(np.int32)
    temp = rs.uniform(0.5, 1.5, B).astype(np.float32)
    temp[rs.random(B) < 0.2] = 0.0
    x = dict(z=rs.normal(0, 1.5, (B, V)).astype(np.float32), cp=sparse(),
             co=sparse(), rep=rs.uniform(1, 2, B).astype(np.float32),
             pres=rs.uniform(0, 1, B).astype(np.float32),
             freq=rs.uniform(0, 0.5, B).astype(np.float32), temp=temp,
             top_k=rs.choice([0, 0, 1, 40, 300], B).astype(np.int32),
             top_p=rs.choice([1.0, 1.0, 0.95, 0.5], B).astype(np.float32),
             min_p=rs.choice([0.0, 0.0, 0.05], B).astype(np.float32),
             u=rs.random(B).astype(np.float32),
             hot={"all": np.ones(V, bool), "none": np.zeros(V, bool),
                  "random": rs.random(V) < 0.3}[hot])
    return {k: torch.from_numpy(v).to(dev) for k, v in x.items()}


_PEN = ("z", "cp", "co", "rep", "pres", "freq", "temp")
_FUSED = _PEN + ("top_k", "top_p", "min_p", "u", "hot")


@pytest.mark.parametrize("B,V,hot", [(1, 300, "random"), (3, 700, "all"),
                                     (8, 49152, "random"), (5, 50021, "none")])
def test_kernels_match_plain_versions(B, V, hot):
    dev = _cuda()
    x = _inputs(B, V, V, dev, hot)
    pen = [x[k] for k in _PEN]
    zs = ref.penalty_ref(*pen)
    assert torch.equal(penalty_kernel.penalty_scale(*pen), zs)
    got = shvs_kernel.shvs_masses(zs, x["hot"])
    want = ref.shvs_mass_ref(zs, x["hot"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    f = [x[k] for k in _FUSED]
    got = fused_kernel.fused_sample(*f, k_cap=256, block_v=2048)
    want = ref.fused_sample_ref(*f, k_cap=256, block_v=2048)
    for i in (0, 1, 3):                  # tokens, exact, kept
        assert torch.equal(got[i], want[i])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    z = torch.zeros((2, 64), device=dev)
    hot = torch.zeros(64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        shvs_kernel.shvs_masses(z.t().contiguous().t(), hot)
    with pytest.raises(ValueError, match="float32"):
        shvs_kernel.shvs_masses(z.double(), hot)
    with pytest.raises(ValueError, match="CUDA"):
        shvs_kernel.shvs_masses(z.cpu(), hot.cpu())


@pytest.mark.parametrize("algorithm", ["shvs", "fused"])
def test_engine_on_cuda_matches_engine_on_cpu(algorithm):
    dev = _cuda()
    cfg = get_arch("smollm-360m").reduced()
    params = Model(cfg).init(seed=1, device="cpu")
    to = lambda t: {k: to(v) if isinstance(v, dict) else v.to(dev)
                    for k, v in t.items()}
    streams = []
    for device, p in (("cpu", params), (dev, to(params))):
        eng = Engine(cfg, p, EngineConfig(
            max_batch=4, max_seq_len=64, algorithm=algorithm,
            shvs=SHVSConfig(hot_size=128), k_cap=64), device=device)
        reqs = synth_requests(3, cfg.vocab_size, 6, seed=5) + \
            synth_requests(3, cfg.vocab_size, 6, rng_seed=1, greedy=True)
        for i, r in enumerate(reqs):
            r.request_id = i
        list(eng.generate(reqs))
        eng.close()
        streams.append([(r.output, r.finish_reason) for r in reqs])
    assert streams[0] == streams[1]
