"""The PyTorch port's configuration mirror and its import hygiene.

``repro_torch`` keeps its own copies of the reference's stdlib-only modules
and must never import JAX or the reference package.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.config as jcfg
import repro_torch.config as tcfg
from repro_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("name", jcfg.ARCH_IDS)
def test_arch_config_mirrors_reference(name):
    ref, port = jcfg.get_arch(name), tcfg.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()


def test_registries_and_service_configs_mirror_reference():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert sorted(tcfg.all_archs()) == sorted(jcfg.all_archs())
    assert dataclasses.asdict(tcfg.SamplingConfig()) == \
        dataclasses.asdict(jcfg.SamplingConfig())
    kw = dict(seed=-3, logit_bias={5: 1.0, 2: -1.0}, stop_sequences=[[1, 2]])
    a, b = jcfg.SamplingConfig(**kw), tcfg.SamplingConfig(**kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.seed_u32 == b.seed_u32
    for V in (100, 512, 49152, 202048):
        for h in (0, 64, 10 ** 6):
            assert tcfg.SHVSConfig(hot_size=h).resolve_hot_size(V) == \
                jcfg.SHVSConfig(hot_size=h).resolve_hot_size(V)


def test_import_loads_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.kernels.ops\n"
            "import repro_torch.models.bridge\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or\n"
            "       m.startswith(('jax.', 'repro.'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_port_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_torch)|from\s+repro\.|from\s+repro\s+import)",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
