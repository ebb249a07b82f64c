"""Node-axis sharded scheduling kernels, and device-loss classification
with bounded retry (PyTorch port of ``kubernetes_tpu/parallel/sharded.py``).

The reference jit-compiles its single-device kernels with the snapshot
sharded over the mesh's "nodes" axis and lets XLA's SPMD partitioner
insert the collectives. Here one process drives the mesh's entries in
turn and writes every collective out as a merge:

* the per-node filter and score math runs on each shard's rows (K1,
  ``ops/fit_kernels.fit_mask``, launches once per shard per fit call);
* the topology-domain segment sums are per-shard partial sums, summed
  (domain ids are global); their presence is OR-ed;
* the score normalizations' maxima are an ``amax`` across shards, the
  feasible counts a sum;
* the wave kernel's per-template top-M is each shard's stable descending
  list, concatenated in shard order and stably sorted again, which orders
  ties by GLOBAL row (shard order, then local order, is global order);
  the serial kernel's argmax takes the first shard holding the maximum,
  so ties go to the lower global row;
* the wave loop runs on the merged ``[TPL, M]`` candidates on the mesh's
  first device, reading each candidate's node columns (free resources,
  ports, domain ids, Stage-A counts) gathered from the shard that owns
  the row;
* every commit (``index_add_``) goes to the shard that owns its row.

Pod batches, pair tables, weights and noise live on the first device and
are copied to each shard's device; every result the host reads
(``chosen``, ``placed``, ``deferred``, ``feasible_count``, ``score``) lands
on the first device, as the reference's replicated outputs do. The
``[TPL, N]``/``[P, N]`` masks stay split (:class:`NodeSharded`), as the
reference's ``P(None, NODES_AXIS)`` outputs do. The results equal the
single-device kernels' exactly (the merges are exact: sums of integral
float32 weights under 2**24, maxima, sorts).

A mesh made under a process group (``Mesh.distributed``, the reference's
mesh over ``jax.distributed``) keeps the SPMD contract: every process
holds the same host state and the same pod-side tensors, drives only the
shards of its own entries (``Mesh.local``), and computes every replicated
output on its own first device. Each merge all-gathers the shards'
request values, packed into one buffer, so that every process runs the
unchanged single-process merge on all shards in global order: sums in
shard order, ties at the lower global row, each process's outputs equal
to one process's bit for bit. A read of node rows (a candidate's
columns, a chosen row's score) is filled on the process that owns each
row and combined by an all-gather and a select by owner (a select leaves
-0.0 and NaN as they are, where a sum would not). Commits go to the
process's own blocks only.

The device-loss classifier: the reference's markers are XLA runtime and
tunnel messages; they stay as they are. On a CUDA card a lost device
shows as a CUDA runtime error, which torch raises as
``torch.AcceleratorError`` (a ``RuntimeError``) with the runtime's
``cudaGetErrorString`` text in its message. The markers below add the
strings of the runtime errors that mean the card itself is gone or
unusable: ``cudaErrorNoDevice`` (100), ``cudaErrorDevicesUnavailable``
(46), ``cudaErrorECCUncorrectable`` (214) and ``cudaErrorLaunchTimeout``
(702), each also by its enum name (the form a wrapper that reports
``cudaGetErrorName`` uses). Program faults — an illegal memory access, a
device-side assert, an invalid launch configuration, out of memory, and
the K1/K2 wrappers' own launch errors — are NOT device loss: retrying
them and then latching the card off would hide a kernel bug behind the
host path.
"""

from __future__ import annotations

import functools
import random
import time
from types import SimpleNamespace
from typing import Callable, List, Optional

import torch

from ..ops.encoding import (
    RES_CPU,
    RES_MEM,
    DeviceSnapshot,
    RemoteBlock,
    ShardedSnapshot,
    _block_of,
)
from ..ops.lattice import (
    SC_BALANCED,
    SC_LEAST_ALLOC,
    SC_MOST_ALLOC,
    SC_REQ_TO_CAP,
    BatchResult,
    ScheduleBatch,
)
from ..ops.wavelattice import (
    DEFAULT_RTC_SHAPE,
    WaveKernel,
    _candidates,
    _commit,
    _pod_rows,
    _result,
)
from . import distributed
from .mesh import Mesh


# -- device-loss classification + bounded retry ------------------------------


class DeviceLossError(RuntimeError):
    """Raised (or re-classified) when a kernel launch/readback failed
    because the device itself is gone or unreachable — as opposed to a
    program bug. The fault injector (testing/device_faults.py) raises this
    directly; a real CUDA runtime error is matched below."""


# substrings (lowercased) that mark a runtime error as device loss rather
# than a program error; deliberately conservative — a false negative
# costs a wave (requeued, zero pod loss), a false positive would retry
# and latch the device off on a genuine kernel bug and mask it
_DEVICE_LOSS_MARKERS = (
    # the reference's (XLA runtime, TPU tunnel)
    "device unavailable",
    "device is unavailable",
    "device lost",
    "device not found",
    "unable to reach device",
    "failed to connect",
    "connection reset",
    "socket closed",
    "deadline exceeded",
    "data transfer failed",
    "halted",
    "unavailable:",
    # the CUDA runtime's cudaGetErrorString texts and enum names of the
    # errors that mean the card is gone (held against libcudart on the
    # card by tests/test_torch_cuda_kernels.py)
    "no cuda-capable device is detected",  # cudaErrorNoDevice
    "busy or unavailable",  # cudaErrorDevicesUnavailable
    "uncorrectable ecc error encountered",  # cudaErrorECCUncorrectable
    "the launch timed out and was terminated",  # cudaErrorLaunchTimeout
    "cudaerrornodevice",
    "cudaerrordevicesunavailable",
    "cudaerroreccuncorrectable",
    "cudaerrorlaunchtimeout",
)


def is_device_loss_error(exc: BaseException) -> bool:
    if isinstance(exc, DeviceLossError):
        return True
    if type(exc).__name__ != "XlaRuntimeError" and not isinstance(
        exc, RuntimeError
    ):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def device_retry_delay(attempts: int, base_delay_s: float = 0.05) -> float:
    """Jittered exponential backoff for device-loss retries — ONE policy
    shared by this helper and the scheduler's launch/serial retry loops
    (which can't use call_with_device_retry itself: each of their retries
    must re-encode/re-flush first)."""
    return base_delay_s * (2 ** attempts) * (1.0 + random.uniform(-0.3, 0.3))


def call_with_device_retry(
    fn: Callable,
    attempts: int,
    base_delay_s: float = 0.05,
    on_retry: Optional[Callable] = None,
):
    """Run fn(), retrying device-loss errors up to `attempts` times with
    jittered exponential backoff (a transient transfer failure heals in
    tens of ms; a dead card won't, and the caller's ride-through takes
    over). Only safe for repeatable calls — a launch that DONATED its
    inputs must re-flush before retrying and cannot use this helper."""
    n = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classifier filters
            if not is_device_loss_error(e) or n >= attempts:
                raise
            n += 1
            if on_retry is not None:
                on_retry(n, e)
            time.sleep(device_retry_delay(n, base_delay_s))


# -- node-axis sharding ------------------------------------------------------


def shard_snapshot(snap: DeviceSnapshot, mesh: Mesh) -> ShardedSnapshot:
    """Place a single-device snapshot onto the mesh with node-axis
    sharding: each row-major field split into one fresh row block per
    entry of this process (a :class:`RemoteBlock` for another process's),
    each replicated field copied to every entry. Row counts are
    capacity-padded powers of two, so they divide over a power-of-two
    mesh."""
    n = int(snap.valid.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} snapshot rows do not divide over a mesh of {mesh.size}")
    b = n // mesh.size
    return ShardedSnapshot(
        mesh,
        [
            DeviceSnapshot(
                *(
                    _block_of(t, name, s, mesh.size).to(e.device, copy=True)
                    for name, t in zip(DeviceSnapshot._fields, snap)
                )
            )
            if mesh.is_local(s) else RemoteBlock(s * b, (s + 1) * b, e.process)
            for s, e in enumerate(mesh.devices)
        ],
    )


class NodeSharded:
    """A ``[..., N]`` kernel output left split over the mesh along its last
    (node) axis, as the reference's ``P(None, NODES_AXIS)`` outputs are:
    part s holds columns ``[s * rows, (s + 1) * rows)`` on entry s's
    device. ``cpu()`` (and ``numpy()``, ``np.asarray``) assembles all N
    columns on the host, global column c being part ``c // rows``'s local
    column ``c % rows``: what the Scheduler's failure paths read. On a
    mesh over processes another process's part is None, and ``cpu()``
    raises (the reference's ``jax.device_get`` of an array that is not
    fully addressable does)."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    def cpu(self) -> torch.Tensor:
        for s, p in enumerate(self.parts):
            if p is None:
                raise ValueError(
                    f"NodeSharded: part {s} lives in another process, and a "
                    "process reads only its own parts"
                )
        return torch.cat([p.cpu() for p in self.parts], dim=-1)

    def numpy(self):
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def _on(nt, device):
    """A NamedTuple of tensors (nested ones too) on `device`; the same
    tensors when they already live there."""
    return type(nt)(
        *(
            _on(x, device) if isinstance(x, tuple) else x.to(device)
            for x in nt
        )
    )


def _merge(reqs, dev0: torch.device):
    """One merge across the shards' requests (``ops/lattice.Merge``),
    computed on the first device."""
    op = reqs[0].op
    if op == "top":
        v = torch.cat([r.value[0].to(dev0) for r in reqs], dim=1)
        i = torch.cat([r.value[1].to(dev0) for r in reqs], dim=1)
        # concatenated in shard order, each list stable: equal scores sit
        # in ascending global row, and the stable sort keeps them so
        v, order = torch.sort(v, dim=1, descending=True, stable=True)
        m = reqs[0].m
        return v[:, :m], i.gather(1, order[:, :m])
    if op == "argmax":
        vals = torch.stack([r.value[0].to(dev0) for r in reqs])
        rows = torch.stack([r.value[1].to(dev0) for r in reqs])
        return rows[vals.argmax()]  # the first shard holding the maximum
    f = {"sum": torch.add, "max": torch.maximum, "any": torch.logical_or}[op]
    out = reqs[0].value.to(dev0)
    for r in reqs[1:]:
        out = f(out, r.value.to(dev0))
    return out


def _slots(mesh: Mesh) -> list:
    """Each entry's position among its own process's entries."""
    seen, out = {}, []
    for e in mesh.devices:
        out.append(seen.get(e.process, 0))
        seen[e.process] = out[-1] + 1
    return out


def _flat(value) -> tuple:
    return value if isinstance(value, tuple) else (value,)


def _gather_requests(reqs: List[dict], mesh: Mesh, dev0: torch.device) -> List[dict]:
    """Every shard's merge requests, in mesh order, on every process of a
    mesh over processes: this process's shards' request values packed
    into one buffer and all-gathered (ONE collective a yield), then read
    back at each entry's owner and slot. Every shard asks for the same
    keys, shapes and dtypes (the blocks have equal rows)."""
    keys = list(reqs[0])
    like = [t for k in keys for t in _flat(reqs[0][k].value)]
    seg = distributed.packed_size(like)
    slots = _slots(mesh)
    g = distributed.all_gather_packed(
        [t.to(dev0) for r in reqs for k in keys for t in _flat(r[k].value)],
        pad_to=(max(slots) + 1) * seg,
    )
    out = []
    for e, j in zip(mesh.devices, slots):
        vals = iter(distributed.unpack(g[e.process, j * seg:(j + 1) * seg], like))
        out.append({
            k: r._replace(
                value=tuple(next(vals) for _ in r.value)
                if isinstance(r.value, tuple) else next(vals)
            )
            for k, r in reqs[0].items()
        })
    return out


def _lockstep(gens: List, mesh: Mesh) -> list:
    """Drive one block generator per entry this process holds
    (``mesh.local``, in mesh order) in step: at each yield the shards'
    merge requests (every process's, on a mesh over processes) are merged
    on the first device and the results sent back, copied to each shard's
    device (the top-M list, which only the first device reads on, stays
    there). Returns each generator's return value at its entry's mesh
    position, None at another process's entries."""
    dev0 = mesh.first
    sent = [None] * len(gens)
    while True:
        reqs, done = [], []
        for g, x in zip(gens, sent):
            try:
                reqs.append(g.send(x))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if reqs:
                raise RuntimeError("mesh shards fell out of step")
            out = iter(done)
            return [next(out) if mesh.is_local(s) else None for s in range(mesh.size)]
        if mesh.distributed:
            reqs = _gather_requests(reqs, mesh, dev0)
        merged = {k: (r.op, _merge([q[k] for q in reqs], dev0)) for k, r in reqs[0].items()}
        sent = [
            {
                k: (v if op == "top" else v.to(e.device))
                for k, (op, v) in merged.items()
            }
            for e in mesh.local
        ]


def _take_rows(parts, idx: torch.Tensor, rows: int, dev0: torch.device) -> torch.Tensor:
    """``full[idx]`` of an ``[N, ...]`` tensor held as per-shard row blocks
    (`parts[s]` holds rows ``[s * rows, (s + 1) * rows)``, None where
    another process holds them): each index read from the shard that owns
    it; ``[*idx.shape, ...]`` on dev0. On a mesh over processes only this
    process's rows are filled (:func:`_by_owner` completes them)."""
    out = None
    for s, t in enumerate(parts):
        if t is None:
            continue
        local = idx - s * rows if s else idx
        v = t[local.clamp(0, rows - 1).to(t.device)].to(dev0)
        if out is None:
            out = v
        else:
            mine = (local >= 0) & (local < rows)
            out = torch.where(mine.reshape(mine.shape + (1,) * (v.dim() - mine.dim())), v, out)
    return out


def _take_tn(parts, t_idx: torch.Tensor, idx: torch.Tensor, rows: int, dev0) -> torch.Tensor:
    """``full[t_idx, idx]`` (broadcast) of a ``[TPL, N]`` tensor held as
    per-shard column blocks, each column read from its owning shard (this
    process's, as :func:`_take_rows`)."""
    out = None
    for s, t in enumerate(parts):
        if t is None:
            continue
        local = idx - s * rows if s else idx
        v = t[t_idx.to(t.device), local.clamp(0, rows - 1).to(t.device)].to(dev0)
        out = v if out is None else torch.where((local >= 0) & (local < rows), v, out)
    return out


def _by_owner(mesh: Mesh, rows: int, items) -> list:
    """Complete the row reads of :func:`_take_rows`/:func:`_take_tn`:
    `items` are (this process's partial read, the global rows it reads,
    of the read's leading shape). On a mesh over processes every
    process's partials go into one packed all-gather and each position is
    selected from the process owning its row (an index outside ``[0, N)``
    reads as on one process, from entry 0's); elsewhere the partials are
    the reads."""
    if not mesh.distributed:
        return [v for v, _ in items]
    like = [v for v, _ in items]
    dev0 = mesh.first
    g = distributed.all_gather_packed(like)
    by_proc = [distributed.unpack(g[p], like) for p in range(g.shape[0])]
    owner_of = torch.tensor([e.process for e in mesh.devices], device=dev0)
    n = rows * mesh.size
    out = []
    for j, (_v, idx) in enumerate(items):
        idx = idx.to(dev0)
        proc = owner_of[torch.where((idx >= 0) & (idx < n), idx // rows, 0)]
        res = by_proc[0][j]
        for p in range(1, len(by_proc)):
            m = proc == p
            res = torch.where(m.reshape(m.shape + (1,) * (res.dim() - m.dim())), by_proc[p][j], res)
        out.append(res)
    return out


class _ColumnRows:
    """The wave loop's node-row reads on a mesh: from the candidate
    columns and the pinned rows, gathered once from their owning shards
    before the loop, plus the first device's deltas. A pod's candidate
    value is its template's column at its chosen slot, or its pinned
    row's for a pinned pod."""

    def __init__(self, c, free_cols, port_cols, dom_cm, free_pin, port_pin, dom_pin_pm, pin_rows):
        self.c = c
        self.free_cols, self.port_cols, self.dom_cm = free_cols, port_cols, dom_cm
        self.free_pin, self.port_pin, self.dom_pin_pm = free_pin, port_pin, dom_pin_pm
        self.pin_rows = pin_rows

    def wave(self, req_d, port_d):
        self.req_d, self.port_d = req_d, port_d

    def pin_free(self):
        return self.free_pin - self.req_d[self.pin_rows]

    def pin_ports_used(self):
        return self.port_pin + self.port_d[self.pin_rows]

    def _at(self, cols, pin, first):
        c = self.c
        slot = c.cand_slot.gather(1, first[:, None])[:, 0]
        return torch.where(c.pinned[:, None], pin, cols[c.t_of, slot])

    def free_ext_sorted(self, cand_n, first, order_c):
        f0 = self._at(self.free_cols, self.free_pin, first)
        p0 = self._at(self.port_cols, self.port_pin, first)
        free_ext = torch.cat(
            [f0 - self.req_d[cand_n], 1 - (p0 + self.port_d[cand_n]).clamp(max=1)], dim=1
        )  # [P, R+PV]
        return free_ext[order_c]

    def dom_at(self, cand_n, first):
        return self._at(self.dom_cm, self.dom_pin_pm, first)


class ShardedWaveKernel:
    """The wave kernel over a :class:`ShardedSnapshot` (the reference's
    ``make_sharded_wave_kernel``): computes exactly what
    ``WaveKernel.with_noise`` computes on the assembled snapshot. Called
    like it, ``kernel(snap, tb, pt, weights, rng)`` or
    ``kernel.with_noise(snap, tb, pt, weights, noise)`` with the pod-side
    tensors and the ``[P, min(m_cand, N)]`` noise on the mesh's first
    device; the blocks' occupancy is updated in place and ``snap`` is
    returned with the WaveResult (``resolvable_tpl``/``feasible_tpl``
    :class:`NodeSharded`, the rest on the first device).

    Stages: (a) per shard, ``WaveKernel._stage_a`` on its rows — the
    statics, ``free0``, K1 on the shard's rows, the ports mask and the
    ``[J, V]`` partial domain sums; (b) the merges (``_lockstep``);
    (c) ``WaveKernel._waves`` on the merged candidates on the first
    device, with each candidate's node columns gathered from its owning
    shard; (d) the commits, each routed to the shard owning its row."""

    def __init__(self, base: WaveKernel, mesh: Mesh):
        self.base = base
        self.mesh = mesh

    def __call__(self, snap: ShardedSnapshot, tb, pt, weights, rng: torch.Generator):
        P = tb.pod_tpl.shape[0]
        m_c = min(self.base.m_cand, snap.n)
        noise = torch.rand(
            (P, m_c), generator=rng, device=snap.first, dtype=torch.float32,
        ) * 0.999
        return self.with_noise(snap, tb, pt, weights, noise)

    def with_noise(self, snap: ShardedSnapshot, tb, pt, weights, noise: torch.Tensor):
        k = self.base
        if not isinstance(snap, ShardedSnapshot):
            raise TypeError("the sharded wave kernel takes a ShardedSnapshot")
        mesh, dev0, n, b = snap.mesh, snap.first, snap.n, snap.rows
        f32 = torch.float32
        tpl = tb.tpl
        TPL = tpl.valid.shape[0]
        P = tb.pod_tpl.shape[0]
        J = pt.col.shape[0]
        m_c = min(k.m_cand, n)
        weights = torch.as_tensor(weights, dtype=f32).to(dev0)
        if tuple(noise.shape) != (P, m_c):
            raise ValueError(f"tie noise is {tuple(noise.shape)}, want {(P, m_c)}")
        local = snap.local

        # (a) per-shard Stage A, (b) its merges
        sts = _lockstep(
            [
                k._stage_a(
                    blk, _on(tpl, mesh.devices[s].device), _on(pt, mesh.devices[s].device),
                    weights.to(mesh.devices[s].device), m_c, s * b,
                )
                for s, blk in local
            ],
            mesh,
        )

        def parts(name):
            return [None if st is None else st[name] for st in sts]

        st = sts[local[0][0]]
        top_i = st["top_i"]
        t_of, pinned, pin_rows = _pod_rows(tb, TPL, n)
        (pin_feas,) = _by_owner(
            mesh, b, [(_take_tn(parts("feasible0"), t_of, pin_rows, b, dev0), pin_rows)]
        )
        cand_slot, cand_nodes, cand_valid = _candidates(
            tb, st["top_v"], top_i, noise, t_of, pinned, pin_rows, pin_feas, n, m_c
        )

        # (c) the candidates' node columns from their owning shards
        c = SimpleNamespace(
            tb=tb, pt=pt, weights=weights, n=n, m_c=m_c, t_of=t_of,
            pinned=pinned, top_i=top_i, cand_slot=cand_slot,
            cand_nodes=cand_nodes, cand_valid=cand_valid,
            base_dom=st["base_dom"], present_dom=st["present_dom"],
            tot0=st["tot0"], rtc=st["rtc_fn"],
        )
        v_cap = k.v_cap
        free_parts = parts("free0")
        port_parts = [None if isinstance(blk, RemoteBlock) else blk.port_counts for blk in snap.blocks]
        dom_parts = [None if x is None else x.T for x in parts("dom_j")]  # [rows, J]
        cnt_parts = [None if x is None else x.T for x in parts("cnt0")]
        tpl_rows = torch.arange(TPL, device=dev0)[:, None]
        reads = {
            "static_ok_c": (_take_tn(parts("static_ok"), tpl_rows, top_i, b, dev0), top_i),  # [TPL, M]
            "free0_cols": (_take_rows(free_parts, top_i, b, dev0), top_i),  # [TPL, M, R]
            "port0_cols": (_take_rows(port_parts, top_i, b, dev0), top_i),  # [TPL, M, PV]
            "dom_cm": (_take_rows(dom_parts, top_i, b, dev0), top_i),  # [TPL, M, J]
            "cnt0_cm": (_take_rows(cnt_parts, top_i, b, dev0), top_i),
            "free_pin": (_take_rows(free_parts, pin_rows, b, dev0), pin_rows),  # [P, R]
            "port_pin": (_take_rows(port_parts, pin_rows, b, dev0), pin_rows),  # [P, PV]
            "dom_pin_pm": (_take_rows(dom_parts, pin_rows, b, dev0), pin_rows),  # [P, J]
        }
        if k.has_pinned:
            reads["cnt0_pin"] = (_take_rows(cnt_parts, pin_rows, b, dev0), pin_rows)
        if k.score_refresh:
            resid = [None] * len(sts)
            for s, _blk in local:
                x, w = sts[s], weights.to(mesh.devices[s].device)
                w_res = (
                    w[SC_LEAST_ALLOC] * x["least"]
                    + w[SC_MOST_ALLOC] * x["most"]
                    + w[SC_BALANCED] * x["balanced"]
                    + w[SC_REQ_TO_CAP] * x["rtc"]
                )
                resid[s] = x["total_score"] - w_res
            reads["cand_resid"] = (_take_tn(resid, t_of[:, None], cand_nodes, b, dev0), cand_nodes)  # [P, M]
            for name, field, r in (
                ("alloc_cpu_c", "allocatable", RES_CPU), ("alloc_mem_c", "allocatable", RES_MEM),
                ("nz_cpu0_c", "nonzero_req", RES_CPU), ("nz_mem0_c", "nonzero_req", RES_MEM),
            ):
                col = [
                    None if isinstance(blk, RemoteBlock) else getattr(blk, field)[:, r]
                    for blk in snap.blocks
                ]
                reads[name] = (_take_rows(col, cand_nodes, b, dev0), cand_nodes)
        got = dict(zip(reads, _by_owner(mesh, b, list(reads.values()))))
        c.static_ok_c = got["static_ok_c"]
        c.free0_cols = got["free0_cols"]
        c.port0_cols = got["port0_cols"]
        dom_cm = got["dom_cm"]
        c.dom_cols = dom_cm.permute(0, 2, 1)  # [TPL, J, M]
        c.cnt0_cols = got["cnt0_cm"].permute(0, 2, 1)
        c.dom_cols_flat = dom_cm.permute(2, 0, 1).reshape(J, TPL * m_c).clamp(0, v_cap - 1).long()
        free_pin, port_pin, dom_pin_pm = got["free_pin"], got["port_pin"], got["dom_pin_pm"]
        if k.has_pinned:
            c.dom_pin = dom_pin_pm.T  # [J, P]
            c.dom_pin_flat = c.dom_pin.clamp(0, v_cap - 1).long()
            c.cnt0_pin = got["cnt0_pin"].T  # [J, P]
            c.pin_req = tpl.req[t_of]  # [P, R]
            c.pin_ports = tpl.port_mask[t_of]  # [P, PV]
        if k.score_refresh:
            c.cand_resid = got["cand_resid"]
            c.alloc_cpu_c = got["alloc_cpu_c"].to(f32).clamp(min=1.0)
            c.alloc_mem_c = got["alloc_mem_c"].to(f32).clamp(min=1.0)
            c.nz_cpu0_c = got["nz_cpu0_c"]
            c.nz_mem0_c = got["nz_mem0_c"]
            c.pod_nz_cpu = tpl.nonzero_req[:, RES_CPU][t_of][:, None]
            c.pod_nz_mem = tpl.nonzero_req[:, RES_MEM][t_of][:, None]
        blk0 = local[0][1]
        c.req_d = torch.zeros((n,) + tuple(blk0.requested.shape[1:]), dtype=blk0.requested.dtype, device=dev0)
        c.port_d = torch.zeros((n,) + tuple(blk0.port_counts.shape[1:]), dtype=blk0.port_counts.dtype, device=dev0)
        c.nz2_d = torch.zeros((n, 2), dtype=blk0.nonzero_req.dtype, device=dev0)
        rows = _ColumnRows(c, c.free0_cols, c.port0_cols, dom_cm, free_pin, port_pin, dom_pin_pm, pin_rows)
        placed, chosen, req_t, ports_t = k._waves(c, rows)

        # (d) each commit on the shard that owns its row (this process's)
        for s, blk in local:
            d = mesh.devices[s].device
            local_row = chosen - s * b
            mine = placed & (local_row >= 0) & (local_row < b)
            _commit(
                blk, torch.where(mine, local_row, 0).to(d), mine[:, None].to(d),
                _on(tb, d), t_of.to(d), req_t.to(d), ports_t.to(d),
            )
        at = chosen.clamp(0, n - 1)
        (score_at,) = _by_owner(mesh, b, [(_take_tn(parts("total_score"), t_of, at, b, dev0), at)])
        return snap, _result(
            tb, t_of, pinned, pin_feas, st["feas_cnt_tpl"], placed, chosen, score_at,
            NodeSharded(parts("resolvable_tpl")), NodeSharded(parts("feasible0")),
        )


class ShardedScheduleBatch:
    """The serial batch kernel over a :class:`ShardedSnapshot` (the
    reference's ``make_sharded_schedule_batch``): equal to
    ``ScheduleBatch`` on the assembled snapshot. Each pod step filters
    and scores on every shard's rows (``ScheduleBatch._block``); the
    domain sums, score maxima, feasible count and best score merge, the
    argmax goes to the first shard holding the maximum (ties to the lower
    global row) and the carry's commit to the shard owning the chosen
    row. ``noise`` is the single-device ``[P, N]`` draw on the first
    device, split by row block (each process takes its own shards'
    columns), so the result equals one device's. The snapshot is read,
    never written; ``resolvable`` is :class:`NodeSharded`, the rest lands
    on the first device."""

    def __init__(self, base: ScheduleBatch, mesh: Mesh):
        self.base = base
        self.mesh = mesh

    def __call__(self, snap: ShardedSnapshot, batch, weights, noise) -> BatchResult:
        if not isinstance(snap, ShardedSnapshot):
            raise TypeError("the sharded serial kernel takes a ShardedSnapshot")
        n, b = snap.n, snap.rows
        p = batch.valid.shape[0]
        if tuple(noise.shape) != (p, n):
            raise ValueError(f"tie noise is {tuple(noise.shape)}, want {(p, n)}")
        devs = snap.mesh.devices
        rs = _lockstep(
            [
                self.base._block(
                    blk, _on(batch, devs[s].device), weights,
                    noise[:, s * b:(s + 1) * b].to(devs[s].device), shard=s * b,
                )
                for s, blk in snap.local
            ],
            snap.mesh,
        )
        r0 = rs[snap.local[0][0]]
        return BatchResult(
            chosen=r0.chosen,
            score=r0.score,
            feasible_count=r0.feasible_count,
            resolvable=NodeSharded([None if r is None else r.resolvable for r in rs]),
        )


@functools.lru_cache(maxsize=8)
def make_sharded_schedule_batch(
    v_cap: int, mesh: Mesh, hard_pod_affinity_weight: float = 1.0
) -> ShardedScheduleBatch:
    """The serial kernel over `mesh` (the reference's signature)."""
    return ShardedScheduleBatch(ScheduleBatch(v_cap, hard_pod_affinity_weight), mesh)


@functools.lru_cache(maxsize=32)
def make_sharded_wave_kernel(
    v_cap: int,
    m_cand: int,
    n_waves: int,
    hard_pod_affinity_weight: float,
    mesh: Mesh,
    use_pallas_fit: bool = True,
    score_refresh: bool = True,
    rtc_shape: tuple = None,
    has_pinned: bool = True,
) -> ShardedWaveKernel:
    """The production wave kernel over `mesh` (the reference's
    signature; ``use_pallas_fit`` routes each shard's fit mask through K1,
    the CUDA kernel on a card)."""
    return ShardedWaveKernel(
        WaveKernel(
            v_cap, m_cand, n_waves, hard_pod_affinity_weight, use_pallas_fit,
            score_refresh, rtc_shape or DEFAULT_RTC_SHAPE, has_pinned,
        ),
        mesh,
    )
