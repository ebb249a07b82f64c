"""Device mesh and node-axis placement for the scheduling data plane
(PyTorch port of ``kubernetes_tpu/parallel/mesh.py``).

The scaling axis of a cluster scheduler is node count: every ``[N, ...]``
snapshot tensor shards over the mesh's "nodes" axis, and the per-pod
reductions (the feasible count, score maxima, the candidate top-M, the
topology-domain segment sums) become merges across shards. Pod batches
and the vocabulary-indexed metadata are replicated (small).

Where the reference's mesh is ``jax.sharding.Mesh`` over ``jax.devices()``
and XLA's partitioner inserts the collectives, here a :class:`Mesh` is an
ordered list of :class:`MeshDevice` entries that ONE process drives: the
snapshot's row-major fields are split into contiguous row blocks, one per
entry (``ops/encoding.ShardedSnapshot``), and ``parallel/sharded.py``
writes each merge out (sums, ``amax``, a concatenation plus a stable sort,
an ``index_add_`` on the owning block). One controller over many devices
is the reference's own design, and it is what lets the device-loss ladder
probe the entries and re-shard inside one process.

``virtual_devices(device, n)`` gives ``n`` entries with distinct ids on
one ``torch.device``: the port's counterpart of XLA's
``--xla_force_host_platform_device_count``, with which the tests run a
mesh on the CPU and ``chip_smoke.py`` runs one on a single card. Because
every virtual entry shares its ``torch.device``, placement is read from
the entry (``ShardedSnapshot.mesh``), never from ``tensor.device``.

The placement descriptions (``snapshot_shardings``, ``replicated``,
``single_device_shardings``) keep the reference's split of fields: every
row-major field shards on nodes; ``eterm_topo_key``, ``eterm_kind`` and
``band_prio`` replicate. ``SnapshotEncoder.set_sharding`` takes them.

A mesh can span processes (the reference's ``jax.distributed`` mesh over
DCN): under a process group (``parallel/distributed.initialize``),
``make_mesh`` lists every process's entries in rank order, each entry
carrying its owning process, and every process builds the same
:class:`Mesh`. A process holds the row blocks of its own entries
(``Mesh.local``) and computes the replicated outputs on its first one
(``Mesh.first``); ``parallel/sharded.py`` answers the merges with
collectives over the group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops.encoding import _GLOBAL_FIELDS, DeviceSnapshot
from . import distributed

NODES_AXIS = "nodes"

# the snapshot fields that replicate; every other field is row-major
REPLICATED_FIELDS = _GLOBAL_FIELDS


class MeshDevice(NamedTuple):
    """One mesh entry: a distinct id (what a probe and a placement test
    read) on a ``torch.device`` (where its tensors live) of the owning
    `process` (its rank; 0 without a process group)."""

    id: int
    device: torch.device
    process: int = 0


class Mesh:
    """An ordered list of mesh entries over the one ``nodes`` axis (the
    reference's ``Mesh(np.asarray(devices), (NODES_AXIS,))``). A process
    drives its own entries (:attr:`local`: every entry of a mesh in one
    process); its first one (:attr:`first`) holds pod batches, the
    merges' results and every output the host reads. A mesh made under a
    process group (``distributed``) lists the entries rank-major and
    merges through the group's collectives."""

    __slots__ = ("devices", "distributed", "local")

    def __init__(self, devices: Sequence[MeshDevice], distributed: bool = False):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        ids = [d.id for d in devices]
        if len(set(ids)) != len(ids):
            raise ValueError(f"mesh entries need distinct ids, got {ids}")
        procs = [d.process for d in devices]
        if procs != sorted(procs):
            raise ValueError(f"mesh entries must be rank-major, got processes {procs}")
        if len(set(procs)) > 1 and not distributed:
            raise ValueError(
                f"entries of processes {sorted(set(procs))} need a mesh made "
                "under a process group (make_mesh after distributed.initialize)"
            )
        self.devices = tuple(devices)
        self.distributed = distributed
        me = _distributed_index() if distributed else procs[0]
        self.local = tuple(d for d in self.devices if d.process == me)
        if not self.local:
            raise ValueError(f"process {me} owns no entry of {self!r}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.local[0].device

    def is_local(self, s: int) -> bool:
        return self.devices[s] in self.local

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Mesh)
            and self.devices == other.devices
            and self.distributed == other.distributed
        )

    def __hash__(self) -> int:
        return hash((self.devices, self.distributed))

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(
            f"{d.id}@{d.device}" + (f"/p{d.process}" if self.distributed else "")
            for d in self.devices
        ) + ")"


def _distributed_index() -> int:
    if not distributed.is_initialized():
        raise RuntimeError("a mesh over processes needs distributed.initialize first")
    return distributed.process_index()


def _entry(d, i: int) -> MeshDevice:
    if isinstance(d, MeshDevice):
        return d
    dev = torch.device(d)
    return MeshDevice(dev.index if dev.type == "cuda" and dev.index is not None else i, dev)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (mesh entries, or ``torch.device``s / strings,
    which get their CUDA index as id). None means every visible CUDA
    device; there is no CPU default — a CPU mesh is named explicitly, as
    ``make_mesh(virtual_devices("cpu", 8))``.

    Under a process group `devices` are this process's entries (None: its
    CUDA devices); every process's are all-gathered, rank-major, which is
    ``jax.devices()``'s order, and a plain device of rank r's k local ones
    gets the global id ``r * k + i``. Every process must call it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() with no devices means every CUDA device and "
                "none is available; pass virtual_devices(\"cpu\", n) to run "
                "a mesh on the CPU explicitly"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not distributed.is_initialized():
        return Mesh([_entry(d, i) for i, d in enumerate(devices)])
    rank, k = distributed.process_index(), len(devices)
    mine = []
    for i, d in enumerate(devices):
        if isinstance(d, MeshDevice):
            if d.process != rank:
                raise ValueError(f"process {rank} was given {d}, an entry of process {d.process}")
            mine.append((d.id, str(d.device)))
        else:
            mine.append((rank * k + i, str(torch.device(d))))
    return Mesh(
        [
            MeshDevice(i, torch.device(dev), p)
            for p, entries in enumerate(distributed.all_gather_object(mine))
            for i, dev in entries
        ],
        distributed=True,
    )


def virtual_devices(device, n: int) -> list:
    """`n` mesh entries all on one ``torch.device``: the port's
    counterpart of the XLA host-platform device-count flag. Ids 0..n-1;
    under a process group this process's entries, ids ``rank * n + i``
    (each worker's ``--xla_force_host_platform_device_count``)."""
    dev = torch.device(device)
    rank = distributed.process_index()
    return [MeshDevice(rank * n + i, dev, rank) for i in range(n)]


class NodeSharding(NamedTuple):
    """Row-major placement: contiguous row blocks, block s on entry s
    (the reference's ``NamedSharding(mesh, P(NODES_AXIS, ...))``)."""

    mesh: Mesh


class Replicated(NamedTuple):
    """A full copy on every entry (``NamedSharding(mesh, P())``)."""

    mesh: Mesh


class SingleDevice(NamedTuple):
    """Everything on one entry (``SingleDeviceSharding``)."""

    device: MeshDevice


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def _default_probe(device) -> bool:
    """One tiny put/get round-trip: the cheapest 'is this device alive'
    signal that exercises both transfer directions. device=None probes
    the current CUDA device; a mesh entry probes its ``torch.device``.
    The synchronize makes a sticky error (a lost device, an
    uncorrectable ECC error) surface here as an exception rather than
    later in an unrelated call."""
    if isinstance(device, MeshDevice):
        device = device.device
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    x = torch.zeros(1, dtype=torch.float32).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tuple(x.cpu().shape) == (1,)


def surviving_devices(devices: Sequence, probe=None) -> list:
    """Probe each device and return the ones that still respond — the
    device-loss ride-through's mesh-shrink input. `probe` is injectable
    so chaos tests can declare deaths deterministically."""
    probe = probe or _default_probe
    out = []
    for d in devices:
        try:
            if probe(d):
                out.append(d)
        except Exception:  # noqa: BLE001 — a dead device throws anything
            continue
    return out


def largest_pow2_prefix(devices: Sequence) -> list:
    """The usable shrink target: snapshot row counts are power-of-two
    padded, so the node axis only divides evenly over a power-of-two
    device count. 5 survivors → a 4-device mesh; 0 survivors → []."""
    n = len(devices)
    if n == 0:
        return []
    k = 1
    while k * 2 <= n:
        k *= 2
    return list(devices[:k])


def single_device_shardings(device) -> tuple:
    """Pin every snapshot field (and the replicated update scatters) to ONE
    specific device: the shrink-to-one-survivor target. ``set_sharding(None,
    None)`` would fall back to the encoder's own device — which after a
    device loss may be exactly the dead one."""
    one = SingleDevice(_entry(device, 0))
    snap = DeviceSnapshot(**{f: one for f in DeviceSnapshot._fields})
    return snap, one


def snapshot_shardings(mesh: Mesh) -> DeviceSnapshot:
    """Placement of every DeviceSnapshot field: row-major arrays shard on
    the node axis; the ``[T]``/``[PB]``-shaped metadata replicates."""
    row, rep = NodeSharding(mesh), replicated(mesh)
    return DeviceSnapshot(
        **{
            f: (rep if f in REPLICATED_FIELDS else row)
            for f in DeviceSnapshot._fields
        }
    )
