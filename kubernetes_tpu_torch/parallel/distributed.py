"""Process groups for a mesh that spans processes (the port's counterpart
of what the reference takes from ``jax.distributed``).

The reference's multi-host story (``kubernetes_tpu/parallel/sharded.py``,
DCN): every process calls ``jax.distributed.initialize``, ``jax.devices()``
lists every process's devices, and the sharded kernels' psums and top-k
gathers cross the process boundary. Here every process calls
:func:`initialize` (a ``torch.distributed`` process group), a mesh made
under the group lists every process's entries in rank order
(``parallel/mesh.make_mesh``), and ``parallel/sharded.py`` answers each
merge with :func:`all_gather_packed`: every process's shards' requests
gathered in rank order, then the single-process merge run on every
process. The SPMD contract is the reference's: every process holds
identical host state, owns the row blocks of its own mesh entries, and
computes the same replicated outputs.

The backend is the caller's choice, ``"gloo"`` or ``"nccl"``, and nothing
here switches it. gloo moves host tensors; a CUDA tensor is staged
through host memory by the helpers themselves (one packed ``.cpu()``, the
collective, one copy back). NCCL moves CUDA tensors and refuses two ranks
on one card ("Duplicate GPU detected"); that error is raised as it is.

Every collective is counted in ``utils/metrics``:
``distributed_collectives_total`` and ``distributed_bytes_total`` (the
bytes a collective returns to this process, its own included).
"""

from __future__ import annotations

import datetime
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..utils.metrics import metrics

BACKENDS = ("gloo", "nccl")

# packed segments start on 8 bytes, so every dtype's view of one is aligned
_ALIGN = 8


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str,
    timeout_s: float = 60.0,
) -> None:
    """Join the process group: `world_size` processes, this one `rank`,
    meeting at `init_method` (``"file:///path"`` or ``"tcp://host:port"``).
    A collective that waits longer than `timeout_s` (a peer that died)
    raises instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The processes in the group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def _count(nbytes: int) -> None:
    metrics.inc("distributed_collectives_total")
    metrics.inc("distributed_bytes_total", by=float(nbytes))


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every process's `t` in rank order, on `t`'s
    device. Every rank passes the same shape and dtype. Under gloo a CUDA
    tensor is staged through host memory (one ``.cpu()``, the collective,
    one copy back)."""
    world = dist.get_world_size()
    stage = t.device.type == "cuda" and dist.get_backend() == "gloo"
    src = t.contiguous()
    if stage:
        src = src.cpu()
    out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src)
    _count(out.numel() * out.element_size())
    return out.to(t.device) if stage else out


def all_gather_object(obj) -> list:
    """Every process's picklable `obj` in rank order (small descriptions:
    the mesh entries)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    _count(0)
    return out


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """`t`'s bytes as a flat uint8 tensor, zero-padded to _ALIGN."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    pad = -b.numel() % _ALIGN
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat uint8 buffer holding every tensor's bytes, each segment
    starting on 8 bytes; all tensors on one device."""
    if not tensors:
        raise ValueError("nothing to pack")
    return torch.cat([_flat_bytes(t) for t in tensors])


def packed_size(like: Sequence[torch.Tensor]) -> int:
    """The bytes :func:`pack` gives for tensors shaped like `like`."""
    return sum(-(-t.numel() * t.element_size() // _ALIGN) * _ALIGN for t in like)


def unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of a :func:`pack` buffer, shaped and typed like `like`
    (views into `buf`)."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(t.dtype).reshape(t.shape))
        off += -(-n // _ALIGN) * _ALIGN
    return out


def all_gather_packed(
    tensors: Sequence[torch.Tensor], pad_to: int = 0
) -> torch.Tensor:
    """Every process's `tensors`, packed into one uint8 buffer (zero-padded
    to `pad_to` bytes) and gathered in ONE collective: ``[world, bytes]``
    on the tensors' device; :func:`unpack` reads a row back."""
    buf = pack(tensors)
    if buf.numel() < pad_to:
        buf = torch.cat([buf, buf.new_zeros(pad_to - buf.numel())])
    return all_gather(buf)
