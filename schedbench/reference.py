"""The plain reference that decides ``correct``: kube-scheduler's rules for
the configurations of this benchmark, in NumPy, from the benchmark's own
inputs. It imports nothing of the program.

Two parts, one for each layer the window drives:

* ``check_binds`` replays the pods watch in resourceVersion order, from
  the first node to the end of the drain: each pod bound once, only pods
  the benchmark created, to a node that exists, with every node's
  requests within its allocatable after each bind, and, where the
  configuration asks for it, a pod of the required labels already in the
  zone. Every measured pod created must be bound by the end of the drain.

* ``check_held`` judges one wave batch held from the window: its
  feasibility per node, the score it reports for each pod it placed (less
  the constant no node varies), and whether each pod's node lies among
  the best ``wave_m_cand`` nodes, all worked out again here from the
  configuration and the number of pods on each node (every pod of these
  configurations has one shape, so a node's state is its pod count).
  That number comes from the stream (``held_start``): the store at the
  launch, the batches in flight, and the deletes the Scheduler had not
  yet seen; the program's snapshot is held to it exactly, and the held
  batch's own bind call to the rows its kernel chose.

``control_held`` is the reference put in the program's place in
bfloat16, the precision below the configuration's float32, once with
the whole score rounded and once with only its variable part rounded:
the comparison has to find both wrong
(``schedbench/tests/test_sb_control.py``, and ``python3
schedbench/control.py`` on the chip).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from .window import ADD, BIND, DEL, OTHER  # the stream's event codes

_SUFFIX = {
    "": 1, "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
}


def quantity(v, milli: bool = False) -> int:
    """A Kubernetes quantity as an integer: milli-units for CPU."""
    s = str(v)
    m = re.fullmatch(r"([0-9]+)(m|k|M|G|T|Ki|Mi|Gi|Ti)?", s)
    if not m:
        raise ValueError(f"quantity {v!r}")
    n, suf = int(m.group(1)), m.group(2) or ""
    if suf == "m":
        if not milli:
            raise ValueError(f"milli quantity {v!r} where units are whole")
        return n
    return n * _SUFFIX[suf] * (1000 if milli else 1)


class Shapes:
    """The numbers of a configuration file the reference needs."""

    def __init__(self, cfg: dict):
        a = cfg["node_allocatable"]
        self.alloc = np.array(
            [quantity(a["cpu"], True), quantity(a["memory"]), int(a["pods"])],
            dtype=np.int64,
        )
        r = cfg["pod_requests"]
        self.req = np.array(
            [quantity(r["cpu"], True), quantity(r["memory"]), 1], dtype=np.int64
        )
        self.zones = int(cfg["zones"])
        self.num_nodes = int(cfg["num_nodes"])
        self.node_zone = {f"node-{i}": i % self.zones for i in range(self.num_nodes)}
        aff = cfg.get("required_pod_affinity")
        self.affinity = aff is not None
        sel = (aff or {}).get("match_labels", {})
        self.measured_matches = all(
            cfg["pod_labels"].get(k) == v for k, v in sel.items()
        ) if aff else False
        self.init_matches = all(
            cfg["init_pod_labels"].get(k) == v for k, v in sel.items()
        ) if aff else False
        sc = cfg["score"]
        w = sc["weights"]
        self.w_least = float(w.get("NodeResourcesLeastAllocated", 0))
        self.w_balanced = float(w.get("NodeResourcesBalancedAllocation", 0))
        self.w_interpod = float(w.get("InterPodAffinity", 0))
        self.hard_weight = float(sc["hard_pod_affinity_weight"])
        self.constant = float(sc["node_constant"])
        self.m_cand = int(cfg["scheduler"]["wave_m_cand"])


def _is_init(name: str) -> bool:
    return name.startswith("init-")


def check_binds(events, cfg: dict, measured_created: Optional[int] = None) -> Dict[str, int]:
    """Counts of what went wrong over the whole stream (each 0 when
    correct). `events` are (code, rv, name, node, t) in stream order."""
    sh = Shapes(cfg)
    used: Dict[str, np.ndarray] = {}
    zone_match = np.zeros(sh.zones, dtype=np.int64)
    matching = 0
    created = set()
    node_of: Dict[str, str] = {}
    out = dict(
        unknown_pod=0, double_bind=0, unknown_node=0, over_allocatable=0,
        affinity=0, unbound=0, out_of_order=0,
    )
    last_rv = 0
    for code, rv, name, node, _t in events:
        if rv <= last_rv:
            out["out_of_order"] += 1
        last_rv = rv
        if code == ADD:
            created.add(name)
        elif code == BIND:
            if name not in created:
                out["unknown_pod"] += 1
            if name in node_of:
                out["double_bind"] += 1
                continue
            z = sh.node_zone.get(node)
            if z is None:
                out["unknown_node"] += 1
                node_of[name] = node
                continue
            init = _is_init(name)
            matches = sh.init_matches if init else sh.measured_matches
            if sh.affinity and not init:
                # required affinity: a matching pod already in the zone, or,
                # with none anywhere, the pod matching its own selector
                if zone_match[z] == 0 and not (matching == 0 and matches):
                    out["affinity"] += 1
            u = used.setdefault(node, np.zeros(3, dtype=np.int64))
            u += sh.req
            if (u > sh.alloc).any():
                out["over_allocatable"] += 1
            if matches:
                zone_match[z] += 1
                matching += 1
            node_of[name] = node
        elif code == DEL:
            node = node_of.get(name)
            if node is not None and node in used:
                used[node] -= sh.req
                init = _is_init(name)
                if (sh.init_matches if init else sh.measured_matches):
                    zone_match[sh.node_zone[node]] -= 1
                    matching -= 1
        elif code == OTHER and node and node_of.get(name) not in (None, node):
            out["double_bind"] += 1
    measured = [n for n in created if not _is_init(n)]
    out["unbound"] = sum(1 for n in measured if n not in node_of)
    if measured_created is not None and measured_created != len(measured):
        out["unknown_pod"] += abs(measured_created - len(measured))
    return out


def replay(events, rv_limit: int, names) -> tuple:
    """The store at resourceVersion `rv_limit`, replayed from the stream:
    (pods on each row, init pods on each row, the rows of the bound pods
    deleted, in order); rows follow `names` (None for a row without a
    node, -1 for a deleted pod's node outside them)."""
    row = {n: i for i, n in enumerate(names) if n is not None}
    total = np.zeros(len(names), dtype=np.int64)
    init = np.zeros(len(names), dtype=np.int64)
    deleted = []
    node_of = {}
    for code, rv, name, node, _t in events:
        if rv > rv_limit:
            break
        if code == BIND and name not in node_of:
            node_of[name] = node
            r = row.get(node)
            if r is not None:
                total[r] += 1
                if _is_init(name):
                    init[r] += 1
        elif code == DEL and name in node_of:
            r = row.get(node_of.pop(name), -1)
            deleted.append(r)
            if r >= 0:
                total[r] -= 1
                if _is_init(name):
                    init[r] -= 1
    return total, init, deleted


# bind calls after the launch searched for the held batch's own: the
# pipeline's other batches in flight, and one to spare
_CALLS_AFTER_LAUNCH = 6


def held_start(held: dict, events, runs) -> dict:
    """The pod count on each row that the held launch started from,
    worked out from the stream alone, and the program's snapshot judged
    against it.

    The store at the launch's resourceVersion, plus the pods of the
    batches launched before it and bound after it (the binds of the bind
    calls that come before the held batch's own; that call is the first
    after the launch whose binds fall on the rows the kernel chose), is
    the state with every delete applied. The Scheduler's informer may
    not yet have applied the newest deletes, in resourceVersion order:
    the start is that state with the fewest newest deletes undone that
    makes it equal the snapshot's pod counts. ``snapshot_mismatch`` is
    what stays unequal at the best such cut (0 when the snapshot is the
    store at some earlier point plus the batches in flight),
    ``snapshot_lag`` the deletes undone."""
    names = held["names"]
    n = len(names)
    rv = held["rv"]
    total, init, deleted = replay(events, rv, names)
    placed = held["placed"].astype(bool) & held["pod_valid"].astype(bool)
    chosen = held["chosen"].astype(np.int64)[placed]
    own_rows = np.bincount(chosen[chosen < n], minlength=n)
    own_rows[0] += int((chosen >= n).sum())  # a row beyond the nodes never matches
    later = sorted((r for r in runs if r.rv1 > rv), key=lambda r: r.rv0)[:_CALLS_AFTER_LAUNCH]
    row = {nm: i for i, nm in enumerate(names) if nm is not None}
    all_rows = [np.zeros(n, dtype=np.int64) for _ in later]
    after_rows = [np.zeros(n, dtype=np.int64) for _ in later]
    if later:
        lo, hi = min(r.rv0 for r in later), max(r.rv1 for r in later)
        for code, erv, _name, node, _t in events:
            if erv <= lo or code != BIND:
                continue
            if erv > hi:
                break
            k = next((k for k, r in enumerate(later) if r.rv0 < erv <= r.rv1), None)
            r = row.get(node)
            if k is None or r is None:
                continue
            all_rows[k][r] += 1
            if erv > rv:
                after_rows[k][r] += 1
    gaps = [int(np.abs(h - own_rows).sum()) for h in all_rows]
    own = next((k for k, g in enumerate(gaps) if g == 0), None)
    if own is None:
        own = int(np.argmin(gaps)) if gaps else 0
    bind_mismatch = gaps[own] if gaps else int(own_rows.sum())
    expected = total + sum(after_rows[:own], np.zeros(n, dtype=np.int64))
    c = held["pods_col"].astype(np.int64)[:n]
    diff = (c - expected).tolist()
    undone = [0] * n
    d = sum(abs(x) for x in diff)
    best = (d, 0)
    for lag, r in enumerate(reversed(deleted), 1):
        if d == 0:
            break
        if r < 0:
            continue
        before = abs(diff[r] - undone[r])
        undone[r] += 1
        d += abs(diff[r] - undone[r]) - before
        if d < best[0]:
            best = (d, lag)
    counts = expected.copy()
    for r in deleted[len(deleted) - best[1]:] if best[1] else []:
        if r >= 0:
            counts[r] += 1
    return {
        "counts": counts,
        "init": init,
        "held_bind_mismatch": bind_mismatch,
        "snapshot_mismatch": int(best[0]),
        "snapshot_lag": int(best[1]),
    }


def snapshot_units(held: dict, cfg: dict) -> int:
    """Rows whose resource columns do not hold whole pods of the
    configuration's shape, for the pod count the snapshot gives
    (unit-free: requested / allocatable against the configuration's)."""
    sh = Shapes(cfg)
    names = held["names"]
    n = len(names)
    valid = np.array([nm in sh.node_zone for nm in names])
    c = held["pods_col"].astype(np.int64)[:n]
    cpu_ok = held["cpu_col"][:n].astype(np.int64) * sh.alloc[0] == (
        c * sh.req[0] * held["alloc_cpu_col"][:n].astype(np.int64)
    )
    mem_ok = held["mem_col"][:n].astype(np.int64) * sh.alloc[1] == (
        c * sh.req[1] * held["alloc_mem_col"][:n].astype(np.int64)
    )
    return int((valid & ~(cpu_ok & mem_ok)).sum() + (c[~valid] != 0).sum())


def stage_a(sh: Shapes, names, count, init_count):
    """Feasibility [N] and the variable part of the score [N] (the score
    less the configuration's ``node_constant``) of one measured pod on
    each row, with `count` pods (`init_count` of them init pods) on each
    row, in float64 (``_stage_a_torch`` redoes the scores in a lower
    precision for the control)."""
    n = len(names)
    valid = np.array([nm in sh.node_zone for nm in names])
    zone = np.array([sh.node_zone.get(nm, -1) for nm in names])
    c = np.where(valid, count, 0).astype(np.int64)
    after = (c[:, None] + 1) * sh.req[None, :]
    fits = (after <= sh.alloc[None, :]).all(axis=1)
    feasible = valid & fits
    meas = np.where(valid, c - init_count, 0)
    zone_meas = np.zeros(sh.zones, dtype=np.int64)
    zone_matching = np.zeros(sh.zones, dtype=np.int64)
    np.add.at(zone_meas, zone[valid], meas[valid])
    matching = (
        (meas if sh.measured_matches else 0) + (init_count if sh.init_matches else 0)
    )
    matching = np.where(valid, matching, 0)
    np.add.at(zone_matching, zone[valid], matching[valid])
    if sh.affinity:
        anywhere = zone_matching.sum() > 0
        aff_ok = np.where(valid, zone_matching[np.clip(zone, 0, None)] > 0, False)
        if not anywhere and sh.measured_matches:
            aff_ok = valid.copy()
        feasible &= aff_ok
    cpu_f = np.minimum(1.0, after[:, 0] / float(sh.alloc[0]))
    mem_f = np.minimum(1.0, after[:, 1] / float(sh.alloc[1]))
    least = ((1.0 - cpu_f) + (1.0 - mem_f)) * 50.0
    balanced = np.where(
        (cpu_f >= 1.0) | (mem_f >= 1.0), 0.0, (1.0 - np.abs(cpu_f - mem_f)) * 100.0
    )
    if sh.affinity and sh.measured_matches:
        # every resident measured pod's required term matches the incoming
        # pod: hardPodAffinityWeight on each node of its zone
        ip = sh.hard_weight * zone_meas[np.clip(zone, 0, None)].astype(np.float64)
        ip = np.where(valid, ip, 0.0)
    else:
        ip = np.zeros(n)
    ip_mx = np.abs(np.where(feasible, ip, 0.0)).max() if n else 0.0
    ip_norm = ip / ip_mx * 100.0 if ip_mx > 0 else np.zeros(n)
    var = sh.w_least * least + sh.w_balanced * balanced + sh.w_interpod * ip_norm
    return feasible, var


def judge_outputs(held: dict, cfg: dict, start: dict) -> Dict[str, float]:
    """The held batch's outputs (``pod_tpl``, ``pod_valid``,
    ``feasible_tpl``, ``chosen``, ``placed``, ``score``) against the
    reference's feasibility and scores from `start` (``held_start``).
    The reported score is compared less the configuration's
    ``node_constant``, which no node of these clusters varies."""
    sh = Shapes(cfg)
    names = held["names"]
    n = len(names)
    feasible, var = stage_a(sh, names, start["counts"], start["init"])
    t_of = held["pod_tpl"]
    pv = held["pod_valid"].astype(bool)
    tpls = sorted(set(int(t) for t in t_of[pv]))
    ftpl = held["feasible_tpl"].astype(bool)
    feas_bad = int(sum((ftpl[t, :n] != feasible).sum() + ftpl[t, n:].sum() for t in tpls))
    placed = held["placed"].astype(bool) & pv
    chosen = held["chosen"].astype(np.int64)
    ch = chosen[placed]
    if ch.size == 0:
        return {"held_placed": 0}
    if (ch >= n).any():
        return {"held_placed": int(ch.size), "chosen_infeasible": int((ch >= n).sum())}
    reported = held["score"][placed].astype(np.float64) - sh.constant
    gap = float(np.abs(reported - var[ch]).max())
    fs = np.sort(var[feasible])[::-1]
    thr = fs[min(sh.m_cand, fs.size) - 1]
    shortfall = float(np.clip(thr - var[ch], 0.0, None).max())
    return {
        "held_placed": int(ch.size),
        "feasible_mismatch": feas_bad,
        "chosen_infeasible": int((~feasible[ch]).sum()),
        "score_gap": gap,
        "topm_shortfall": shortfall,
    }


def check_held(held: Optional[dict], cfg: dict, events, runs) -> Dict[str, float]:
    """Every number the held batch is judged by, and the start the
    reference worked out (None without a held batch). `held` holds the
    program's snapshot at the launch (``names``, ``pods_col``,
    ``cpu_col``, ``mem_col``, ``alloc_cpu_col``, ``alloc_mem_col``), the
    launch's resourceVersion and time (``rv``, ``t``), and its outputs;
    `runs` are the run's bind calls (``stream.BindClock``)."""
    if held is None:
        return {"held_placed": 0}, None
    start = held_start(held, events, runs)
    out = {k: v for k, v in start.items() if k not in ("counts", "init")}
    out["snapshot_units"] = snapshot_units(held, cfg)
    out.update(judge_outputs(held, cfg, start))
    return out, start


def _stage_a_torch(sh: Shapes, names, count, init_count, dtype):
    """``stage_a``'s variable part with every float in `dtype`."""
    import torch

    feasible, _ = stage_a(sh, names, count, init_count)
    valid = np.array([nm in sh.node_zone for nm in names])
    zone = np.array([sh.node_zone.get(nm, -1) for nm in names])
    c = torch.tensor(np.where(valid, count, 0), dtype=dtype)
    meas = np.where(valid, count - init_count, 0)
    zone_meas = np.zeros(sh.zones, dtype=np.int64)
    np.add.at(zone_meas, zone[valid], meas[valid])
    one = torch.tensor(1.0, dtype=dtype)
    cpu_f = torch.minimum(one, (c + 1) * float(sh.req[0]) / float(sh.alloc[0]))
    mem_f = torch.minimum(one, (c + 1) * float(sh.req[1]) / float(sh.alloc[1]))
    least = ((1 - cpu_f) + (1 - mem_f)) * 50
    balanced = (1 - (cpu_f - mem_f).abs()) * 100
    if sh.affinity and sh.measured_matches:
        ip = torch.tensor(
            np.where(valid, zone_meas[np.clip(zone, 0, None)], 0), dtype=dtype
        ) * sh.hard_weight
        mx = ip[torch.from_numpy(feasible)].abs().max()
        ip_norm = ip / mx * 100 if float(mx) > 0 else torch.zeros_like(ip)
    else:
        ip_norm = torch.zeros_like(c)
    return feasible, least * sh.w_least + balanced * sh.w_balanced + ip_norm * sh.w_interpod


# the controls: the whole score in bfloat16, and only its variable part in
# bfloat16 with the constant added in the configuration's float32
CONTROLS = ("control", "control_var")


def control_held(held: dict, cfg: dict, start: dict, kind: str = "control") -> dict:
    """The held batch with the program's outputs replaced by the
    reference's own from `start`, in bfloat16: each pod takes the next of
    the best ``wave_m_cand`` rows by the low-precision score, and reports
    that score. ``kind`` "control" rounds the whole score, constant and
    all; "control_var" only its variable part, and adds the constant in
    float32."""
    import torch

    sh = Shapes(cfg)
    names = held["names"]
    n = len(names)
    feasible, var = _stage_a_torch(sh, names, start["counts"], start["init"], torch.bfloat16)
    if kind == "control":
        s = torch.tensor(sh.constant, dtype=torch.bfloat16) + var
    else:
        s = torch.tensor(sh.constant, dtype=torch.float32) + var.float()
    s = s.float()
    masked = torch.where(torch.from_numpy(feasible), s, torch.tensor(float("-inf")))
    order = torch.sort(masked, descending=True, stable=True).indices
    top = order[: min(sh.m_cand, int(feasible.sum()))].numpy()
    p = len(held["pod_valid"])
    chosen = top[np.arange(p) % top.size]
    out = dict(held)
    out["chosen"] = chosen.astype(np.int64)
    out["placed"] = np.ones(p, dtype=bool)
    out["score"] = s.numpy()[chosen]
    ftpl = np.zeros_like(held["feasible_tpl"], dtype=bool)
    for t in set(int(t) for t in held["pod_tpl"][held["pod_valid"].astype(bool)]):
        ftpl[t, :n] = feasible
    out["feasible_tpl"] = ftpl
    return out
