"""Build the port's CUDA kernels from the repository's sources, and the
checks every kernel wrapper makes before it hands pointers to one.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  The library's name carries a hash of its source and
flags (and of the shared headers ``csrc/*.cuh``), so an edited source is
rebuilt and a stale library never loads.
Each ``nvcc`` run is counted by ``obs.metrics.record_build`` (the
``kernel_builds`` and ``kernel_build_seconds`` counters).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..obs import metrics as obs_metrics

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path.  The compiler's ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside it as ``.log``."""
    src, lib = _target(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    obs_metrics.record_build(time.perf_counter() - t0, source=name)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the last build of ``csrc/<name>.cu``."""
    log = _target(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def supported() -> Tuple[bool, str]:
    """Whether the CUDA kernels can run on this host, and how."""
    if not torch.cuda.is_available():
        return False, "torch.cuda.is_available() is False"
    return True, ("hand-written sm_90a kernels on "
                  f"{torch.cuda.get_device_name(0)}")


def require_cuda(dev: torch.device, name: str) -> None:
    """Raise unless ``dev`` is a CUDA device: a wrapper given tensors on
    any device but the CPU (plain version) and the card has no kernel."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel takes
    and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device pointer for ctypes (None: a null pointer)."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
