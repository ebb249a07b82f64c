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
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops.encoding import _GLOBAL_FIELDS, DeviceSnapshot

NODES_AXIS = "nodes"

# the snapshot fields that replicate; every other field is row-major
REPLICATED_FIELDS = _GLOBAL_FIELDS


class MeshDevice(NamedTuple):
    """One mesh entry: a distinct id (what a probe and a placement test
    read) on a ``torch.device`` (where its tensors live)."""

    id: int
    device: torch.device


class Mesh:
    """An ordered list of mesh entries over the one ``nodes`` axis (the
    reference's ``Mesh(np.asarray(devices), (NODES_AXIS,))``). Entry 0 is
    the first device: pod batches, the merges' results and every output
    the host reads live there."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence[MeshDevice]):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        ids = [d.id for d in devices]
        if len(set(ids)) != len(ids):
            raise ValueError(f"mesh entries need distinct ids, got {ids}")
        self.devices = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0].device

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{d.id}@{d.device}" for d in self.devices) + ")"


def _entry(d, i: int) -> MeshDevice:
    if isinstance(d, MeshDevice):
        return d
    dev = torch.device(d)
    return MeshDevice(dev.index if dev.type == "cuda" and dev.index is not None else i, dev)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (mesh entries, or ``torch.device``s / strings,
    which get their CUDA index as id). None means every visible CUDA
    device; there is no CPU default — a CPU mesh is named explicitly, as
    ``make_mesh(virtual_devices("cpu", 8))``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() with no devices means every CUDA device and "
                "none is available; pass virtual_devices(\"cpu\", n) to run "
                "a mesh on the CPU explicitly"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh([_entry(d, i) for i, d in enumerate(devices)])


def virtual_devices(device, n: int) -> list:
    """`n` mesh entries with ids 0..n-1, all on one ``torch.device``: the
    port's counterpart of the XLA host-platform device-count flag."""
    dev = torch.device(device)
    return [MeshDevice(i, dev) for i in range(n)]


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
