"""Resource-fit kernels: the hand-written Hopper kernels and their plain
versions.

K1 replaces the TPU kernel ``kubernetes_tpu/ops/pallas_ops.py::fit_mask``
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

K2 replaces ``kubernetes_tpu/ops/pallas_ops.py::fit_mask_least_alloc``
(Pallas body ``_kernel``): K1's mask fused with a least-allocated score,
the mean over requested resources of ``f32(free - req) / f32(max(alloc,
1))``. No path of the system runs it (the reference wires it nowhere);
it is a standalone kernel held against its plain version.

* ``fit_mask_least_alloc_plain(req, free, alloc)`` — the same arithmetic
  in PyTorch, the sum over resources written out in order.
* ``fit_mask_least_alloc(req, free, alloc)`` — CPU tensors take the plain
  version; CUDA tensors launch ``csrc/fit_least_alloc.cu`` or raise.
  ``fit_mask_least_alloc.launches`` counts its launches. ``free`` and
  ``alloc`` are the snapshot's natural ``[N, R]`` (the reference's
  ``[8, N]`` transposed, 512-padded layout is a TPU lane layout).

Source note: both kernels are bound by launch latency and one exposed
memory round trip, not by bytes — K1 moves ``N·R·4 + TPL·N + TPL·R·4``
bytes for ``TPL·N·R`` integer compares, K2 ``2·N·R·4 + TPL·R·4 + TPL·N·5``
for ``TPL·N·(R + 1)`` IEEE divisions, about 0.2 and 1 MB at the wave
path's sizes. So both spread the work over the SMs: K1 gives each thread
one node in 64-thread blocks and tiles the template axis over the grid's
y dimension, with no shared memory and no barrier; K2 runs one thread per
(template, node) output over a 2-D grid, the block's node tile of
``free`` and denominators read once, as int4 vectors, into shared memory.
Each source says more, and each also exports ``<name>_floor_launch``, an
empty kernel with its grid, for ``chip_smoke.py`` to time the launch
floor.

The host call: after the first build a wrapper reads the loaded library
from a module-level dict without the build lock, and it enters a
``torch.cuda.device`` context only when the tensors' device is not the
current one. K2's ``free`` and ``alloc`` must be 16-byte aligned: it reads
them as int4 vectors, and a misaligned view raises.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
per source, named by the source's content hash under ``build/kernels/`` at
the repo root, at first use (``build_all`` starts every missing build at
once); loaded with ``ctypes``. K2 builds with ``-fmad=false`` so it can be
compared with its plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class KernelSource(NamedTuple):
    name: str  # library stem and the C symbols' prefix
    path: Path
    flags: Tuple[str, ...]
    launch_args: Tuple  # ctypes argtypes of <name>_launch


_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES: Dict[str, KernelSource] = {
    "fit_mask": KernelSource(
        "fit_mask", _PKG / "csrc" / "fit_mask.cu", NVCC_FLAGS,
        (_P, _P, _P, _I, _I, _I, _P),
    ),
    "fit_least_alloc": KernelSource(
        "fit_least_alloc", _PKG / "csrc" / "fit_least_alloc.cu",
        NVCC_FLAGS + ("-fmad=false",),
        (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    ),
}


class KernelLibrary(NamedTuple):
    cdll: ctypes.CDLL
    path: Path
    build_log: str  # nvcc's output (ptxas register/shared-memory report)
    r_max: int
    launch: Callable[..., int]  # <name>_launch, argtypes set


_lock = threading.Lock()
_loaded: Dict[str, KernelLibrary] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in csrc/")


def _lib_path(src: KernelSource) -> Path:
    digest = hashlib.sha256(
        src.path.read_bytes() + " ".join(src.flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{src.name}_{digest}.so"


def _load(src: KernelSource, path: Path, log: str) -> KernelLibrary:
    cdll = ctypes.CDLL(str(path))
    launch = getattr(cdll, f"{src.name}_launch")
    launch.argtypes = list(src.launch_args)
    launch.restype = ctypes.c_int
    r_max = getattr(cdll, f"{src.name}_r_max")
    r_max.argtypes = []
    r_max.restype = ctypes.c_int
    return KernelLibrary(cdll, path, log, int(r_max()), launch)


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, KernelLibrary]:
    """Build (once per source content) and load the named kernel libraries
    (default: every source). The missing builds run as concurrent nvcc
    processes, one per source; a failed build raises with nvcc's output."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        procs = {}
        for name in names:
            if name in _loaded:
                continue
            src = SOURCES[name]
            path = _lib_path(src)
            if path.exists():
                _loaded[name] = _load(src, path, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *src.flags, "-o", str(tmp), str(src.path)]
            procs[name] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp, path,
            )
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{SOURCES[name].path}:\n{log}"
                )
                continue
            os.replace(tmp, path)
            _loaded[name] = _load(SOURCES[name], path, log)
        if failed:
            raise RuntimeError("\n".join(failed))
        return {name: _loaded[name] for name in names}


def library(name: str = "fit_mask") -> KernelLibrary:
    """Build (once per source content) and load one kernel library."""
    return build_all([name])[name]


def _check_cuda(fn: str, tensors: Sequence[torch.Tensor], shapes_ok: bool,
                aligned: Sequence[torch.Tensor] = ()) -> None:
    """Raises unless every tensor is a contiguous int32 tensor on one CUDA
    device, the shapes fit, and each of `aligned` starts on 16 bytes."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{fn}: tensors on {[str(t.device) for t in tensors]}; all "
                "must be on one CUDA device (or all on the CPU)"
            )
        if t.dtype != torch.int32:
            raise TypeError(
                f"{fn} takes int32 tensors, got {[t.dtype for t in tensors]}"
            )
    if not shapes_ok:
        raise ValueError(
            f"{fn}: shapes {[tuple(t.shape) for t in tensors]} are not "
            "[TPL, R] and [N, R] with one N and one R"
        )
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{fn} takes contiguous tensors")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(
                f"{fn}: an [N, R] input starts at byte {t.data_ptr() % 16} "
                "of a 16-byte vector (a view from inside a row); the kernel "
                "reads it as int4 vectors: pass a fresh tensor"
            )


def _launch(device: torch.device, fn, *args) -> int:
    """fn(*args, stream) on `device`'s current stream, inside a
    torch.cuda.device context only when `device` is not the current one
    (a kernel launches on the current device)."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


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
    _check_cuda(
        "fit_mask", (req, free),
        req.dim() == 2 and free.dim() == 2 and req.shape[1] == free.shape[1],
    )
    lib = _loaded.get("fit_mask") or library("fit_mask")
    tpl, r = req.shape
    n = free.shape[0]
    if r > lib.r_max:
        raise ValueError(f"fit_mask: R = {r} exceeds the kernel's {lib.r_max}")
    out = torch.empty((tpl, n), dtype=torch.bool, device=free.device)
    rc = _launch(
        free.device, lib.launch,
        req.data_ptr(), free.data_ptr(), out.data_ptr(), tpl, n, r,
    )
    if rc != 0:
        raise RuntimeError(f"fit_mask kernel launch failed: CUDA error {rc}")
    if tpl and n:  # the C entry launches nothing for an empty mask
        fit_mask.launches += 1
    return out


fit_mask.launches = 0


def fit_mask_least_alloc_plain(
    req: torch.Tensor, free: torch.Tensor, alloc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([TPL, N] bool mask, [TPL, N] float32 score) in the kernel's order:
    per resource the int32 difference as f32 over f32(max(alloc, 1)),
    times the 0/1 weight, summed over r = 0..R-1 one term at a time from
    0; then over max(count, 1). Eager PyTorch rounds every product and sum
    separately (no contraction), like the kernel."""
    mask = fit_mask_plain(req, free)
    tpl, r = req.shape
    n = free.shape[0]
    acc = torch.zeros((tpl, n), dtype=torch.float32, device=free.device)
    cnt = torch.zeros((tpl, 1), dtype=torch.float32, device=free.device)
    a = alloc.clamp(min=1).to(torch.float32)  # [N, R]
    for k in range(r):
        q = req[:, k : k + 1]  # [TPL, 1]
        frac = (free[None, :, k] - q).to(torch.float32) / a[None, :, k]
        w = (q > 0).to(torch.float32)
        acc = acc + frac * w
        cnt = cnt + w
    return mask, acc / cnt.clamp(min=1.0)


def fit_mask_least_alloc(
    req: torch.Tensor, free: torch.Tensor, alloc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ([TPL, N] bool mask, [TPL, N] float32 least-allocated score) for
    req [TPL, R], free and alloc [N, R], all int32. CPU tensors take
    ``fit_mask_least_alloc_plain``; CUDA tensors launch the kernel (or
    raise)."""
    if all(t.device.type == "cpu" for t in (req, free, alloc)):
        return fit_mask_least_alloc_plain(req, free, alloc)
    _check_cuda(
        "fit_mask_least_alloc", (req, free, alloc),
        req.dim() == 2 and free.dim() == 2
        and free.shape == alloc.shape and req.shape[1] == free.shape[1],
        (free, alloc),
    )
    lib = _loaded.get("fit_least_alloc") or library("fit_least_alloc")
    tpl, r = req.shape
    n = free.shape[0]
    if r > lib.r_max:
        raise ValueError(
            f"fit_mask_least_alloc: R = {r} exceeds the kernel's {lib.r_max}"
        )
    mask = torch.empty((tpl, n), dtype=torch.bool, device=free.device)
    score = torch.empty((tpl, n), dtype=torch.float32, device=free.device)
    rc = _launch(
        free.device, lib.launch,
        req.data_ptr(), free.data_ptr(), alloc.data_ptr(),
        mask.data_ptr(), score.data_ptr(), tpl, n, r,
    )
    if rc != 0:
        raise RuntimeError(
            f"fit_mask_least_alloc kernel launch failed: CUDA error {rc}"
        )
    if tpl and n:  # the C entry launches nothing for an empty output
        fit_mask_least_alloc.launches += 1
    return mask, score


fit_mask_least_alloc.launches = 0
