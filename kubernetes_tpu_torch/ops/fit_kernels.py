"""Resource-fit mask: the hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``kubernetes_tpu/ops/pallas_ops.py::fit_mask``
(Pallas body ``_mask_kernel``), which the wave kernel's Stage A runs once
per launch (``fits0``). Template t fits node n iff every resource r has
``req[t, r] == 0 or req[t, r] <= free[n, r]``; ``free`` may be negative.

* ``fit_mask_plain(req, free)`` — the PyTorch broadcast, on any device.
* ``fit_mask(req, free)`` — the wrapper the wave kernel calls. For CPU
  tensors it returns ``fit_mask_plain``; for CUDA tensors it launches the
  CUDA C++ kernel in ``csrc/fit_mask.cu`` or raises. It never falls back
  to the plain version on the card, and it takes any N and any TPL (the
  reference's jnp fallback for untileable shapes does not carry over).
  ``fit_mask.launches`` counts its kernel launches.

Source note: the kernel is bound by memory — it moves ``N·R·4 + TPL·N +
TPL·R·4`` bytes for ``TPL·N·R`` integer compares — and, at the wave
path's sizes (N = 8192, R = 6, TPL ≤ 64: under 1 MB), by launch latency.
One thread owns one node: its R free values are read once into registers
and reused for every template, the block keeps the requests in shared
memory, and adjacent threads write adjacent mask bytes, so one coalesced
pass with no intermediate writes the whole ``[TPL, N]`` mask.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
named by the source's content hash under ``build/kernels/`` at the repo
root, at first use; loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fit_mask.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class KernelLibrary(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    build_log: str  # nvcc's output (ptxas register/shared-memory report)
    r_max: int


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def library() -> KernelLibrary:
    """Build (once per source content) and load the kernel library."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        digest = hashlib.sha256(
            SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        path = BUILD_DIR / f"fit_mask_{digest}.so"
        log = ""
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{log}"
                )
            os.replace(tmp, path)
        cdll = ctypes.CDLL(str(path))
        cdll.fit_mask_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        cdll.fit_mask_launch.restype = ctypes.c_int
        cdll.fit_mask_r_max.argtypes = []
        cdll.fit_mask_r_max.restype = ctypes.c_int
        _loaded = KernelLibrary(cdll, path, log, int(cdll.fit_mask_r_max()))
        return _loaded


def fit_mask_plain(req: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """[TPL, N] bool: the broadcast the kernel replaces (materializes the
    [TPL, N, R] intermediate)."""
    reqb = req[:, None, :]
    return ((reqb == 0) | (reqb <= free[None])).all(dim=-1)


def fit_mask(req: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """[TPL, N] bool resource-fit mask for req [TPL, R] int32 and free
    [N, R] int32. CPU tensors take ``fit_mask_plain``; CUDA tensors launch
    the kernel (or raise)."""
    if req.device.type == "cpu" and free.device.type == "cpu":
        return fit_mask_plain(req, free)
    if req.device != free.device or req.device.type != "cuda":
        raise ValueError(
            f"fit_mask: req on {req.device} and free on {free.device}; both "
            "must be on one CUDA device (or both on the CPU)"
        )
    if req.dtype != torch.int32 or free.dtype != torch.int32:
        raise TypeError(
            f"fit_mask takes int32 tensors, got {req.dtype} and {free.dtype}"
        )
    if req.dim() != 2 or free.dim() != 2 or req.shape[1] != free.shape[1]:
        raise ValueError(
            f"fit_mask: shapes {tuple(req.shape)} and {tuple(free.shape)} "
            "are not [TPL, R] and [N, R]"
        )
    if not (req.is_contiguous() and free.is_contiguous()):
        raise ValueError("fit_mask takes contiguous tensors")
    lib = library()
    tpl, r = req.shape
    n = free.shape[0]
    if r > lib.r_max:
        raise ValueError(f"fit_mask: R = {r} exceeds the kernel's {lib.r_max}")
    out = torch.empty((tpl, n), dtype=torch.bool, device=free.device)
    with torch.cuda.device(free.device):
        stream = torch.cuda.current_stream(free.device).cuda_stream
        rc = lib.cdll.fit_mask_launch(
            req.data_ptr(), free.data_ptr(), out.data_ptr(), tpl, n, r, stream
        )
    if rc != 0:
        raise RuntimeError(f"fit_mask kernel launch failed: CUDA error {rc}")
    if tpl and n:  # the C entry launches nothing for an empty mask
        fit_mask.launches += 1
    return out


fit_mask.launches = 0
