"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

At first use every source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -fmad=false \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o lib...so *.o

``-fmad=false`` keeps nvcc from contracting ``a - b*c`` into an ``fma``, so
the kernels round like the separate elementwise ops of their plain
versions (``penalty_scale`` is then bit-equal to ``ref.penalty_ref``). No
fast-math: ``expf``/``logf`` are the accurate ones.

The library goes to ``build/repro_torch_kernels/`` at the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the sources
and flags, so an edited source is rebuilt. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("penalty.cu", "shvs.cu", "fused.cu", "gumbel.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-O3", "-std=c++17", "-fmad=false",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the commands of the last build and what nvcc/ptxas printed
BUILD_LOG: List[str] = []

_LIB: Optional[ctypes.CDLL] = None
#: serialises the first build and load: engines on several threads (the
#: gateway's replicas) may reach their first launch together
_LIB_LOCK = threading.Lock()
#: guards the wrappers' launch counters (read-modify-write from threads)
COUNT_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    repo = Path(__file__).resolve().parents[3]
    return repo / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from kernels/csrc at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless the library for these sources
    exists already. Returns its path; raises if nvcc fails."""
    out = build_dir() / f"librepro_torch_kernels_{_digest()}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    BUILD_LOG.clear()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            BUILD_LOG.append(" ".join(cmd))
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            text, _ = p.communicate()
            BUILD_LOG.extend(line for line in text.splitlines() if line)
            if p.returncode != 0:
                failed.append(f"{src}:\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib_tmp = Path(tmp) / out.name
        cmd = [nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
               *(str(obj) for _, obj, _ in procs)]
        BUILD_LOG.append(" ".join(cmd))
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
        os.replace(lib_tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use (once, whichever
    thread gets there first; the others wait for it)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check_rc(name: str, rc: int) -> None:
    """Raise if a launch reported a CUDA error (the C entry points return
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def ptr(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
        device: torch.device) -> int:
    """The device pointer of a kernel argument, after checking that it is a
    contiguous tensor of the expected dtype and shape on ``device``."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def shape_only(t: torch.Tensor) -> bool:
    """Whether ``t`` holds shapes and no data: a fake tensor (a trace under
    ``FakeTensorMode``, as the dry-run runs its programs) or a tensor on
    the meta device. A wrapper given one returns empty outputs of the
    kernel's shapes and dtypes and launches nothing: there is nothing to
    compute. A real tensor never takes that path."""
    from torch._subclasses.fake_tensor import is_fake
    return t.device.type == "meta" or is_fake(t)


def cuda_device(t: torch.Tensor) -> torch.device:
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
    return t.device


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
