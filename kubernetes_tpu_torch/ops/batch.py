"""Pod-batch encoding: pending pods → fixed-shape PodBatch tensors.

Port of ``kubernetes_tpu/ops/batch.py``: the host encoding is the
reference's; the finished arrays upload once to the encoder's device as
torch tensors (``batch``), with the numpy mirror kept beside them
(``batch_np``) for host-side consumers such as the pair-table build.

The device analogue of the per-pod work the reference does at the top of the
scheduling cycle (PreFilter state construction: noderesources/fit.go:99,
podtopologyspread/filtering.go:43, interpodaffinity/filtering.go:51). All
string/selector work happens here once per pod; the kernel sees only integer
ids. Pods whose spec overflows the static buckets (more affinity terms than
`aff_terms`, etc.) are flagged for the host fallback path — the same escape
hatch the reference uses for extenders (generic_scheduler.go:421: device/fast
path narrows, slow path completes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import objects as v1
from ..api.objects import (
    TAINT_NODE_UNSCHEDULABLE,
    Taint,
    compute_pod_resource_request,
    pod_host_ports,
    tolerations_tolerate_taint,
)
from ..api.selectors import (
    OP_IN,
    OP_NOT_IN,
    LabelSelector,
    Requirement,
)
from .encoding import (
    _OP_CODES,
    ETERM_ANTI_PREF,
    ETERM_AFF_PREF,
    ENC_OP_IN,
    PodBatch,
    PodPredicate,
    RES_PODS,
    SnapshotEncoder,
    zpad,
)

TOL_OP_EQUAL = 0
TOL_OP_EXISTS = 1
_TOL_EFFECT = {
    "": -1,
    v1.TAINT_NO_SCHEDULE: 0,
    v1.TAINT_PREFER_NO_SCHEDULE: 1,
    v1.TAINT_NO_EXECUTE: 2,
}


@dataclass
class EncodedBatch:
    batch: PodBatch
    pods: List[v1.Pod]  # row-aligned with the batch (padded rows absent)
    fallback: np.ndarray  # [P] bool — pod overflowed static buckets
    batch_np: Optional[PodBatch] = None  # host (numpy) mirror of `batch`:
    # host-side consumers (pair-table build) read this, never the device
    # tensors (each read of those is a device->host copy and a sync)


class _PodEnc:
    """Per-pod intermediate encoding (python lists, turned into arrays later)."""

    def __init__(self) -> None:
        self.fallback = False


def _encode_expr(
    enc: SnapshotEncoder, r: v1.NodeSelectorRequirement, vals_cap: int
) -> Optional[Tuple[int, int, List[int], int]]:
    """(key_id, op, value_ids, numval). None => overflow (fallback)."""
    op = _OP_CODES.get(r.operator)
    if op is None or len(r.values) > vals_cap:
        return None
    key_id = enc.key_vocab.get(r.key)  # -2: unknown key == absent everywhere
    if key_id < 0:
        key_id = -2
    vids = [max(enc.val_vocab.get(v), -2) for v in r.values]
    num = 0
    if r.operator in ("Gt", "Lt"):
        try:
            num = int(r.values[0])
        except (ValueError, IndexError):
            return None
    return key_id, op, vids, num


def encode_pod_batch(
    enc: SnapshotEncoder, pods: Sequence[v1.Pod], pad_to: Optional[int] = None
) -> EncodedBatch:
    """Encode up to P pods. Interning of predicates/eterms happens first so
    all capacities are final before arrays are allocated."""
    c = enc.cfg
    P = pad_to or max(1, len(pods))
    assert len(pods) <= P

    # ---- pass 1: intern everything that can grow capacities ----------------
    per_pod: List[dict] = []
    for pod in pods:
        d: dict = {"fallback": False}
        ns = pod.metadata.namespace
        spec = pod.spec
        aff = spec.affinity

        # PVC-backed and direct-attach volumes need the host path: the
        # volume plugins (binding, restrictions, attach limits, zone) are
        # host-side post-filters, like reference extenders
        if any(
            vol.persistent_volume_claim
            or vol.gce_persistent_disk
            or vol.aws_elastic_block_store
            or vol.iscsi
            or vol.rbd
            or vol.azure_disk
            or vol.cinder
            for vol in spec.volumes
        ):
            d["fallback"] = True

        # topology spread
        spreads = []
        for tsc in spec.topology_spread_constraints[: c.spread_max]:
            key_id = enc.intern_key(tsc.topology_key)
            if tsc.label_selector is not None:
                sid = enc.intern_predicate(frozenset({ns}), tsc.label_selector)
                self_m = tsc.label_selector.matches(pod.metadata.labels)
            else:
                sid, self_m = -1, False
            spreads.append(
                (key_id, sid, tsc.max_skew, tsc.when_unsatisfiable == v1.DO_NOT_SCHEDULE, self_m)
            )
        if len(spec.topology_spread_constraints) > c.spread_max:
            d["fallback"] = True
        d["spreads"] = spreads

        # incoming interpod terms
        def pred_of(term: v1.PodAffinityTerm) -> PodPredicate:
            nss = frozenset(term.namespaces) if term.namespaces else frozenset({ns})
            return PodPredicate(nss, term.label_selector or LabelSelector())

        paff, panti, ppref = [], [], []
        if aff and aff.pod_affinity:
            for term in aff.pod_affinity.required:
                pred = pred_of(term)
                sid = enc.intern_predicate(pred.namespaces, pred.selector)
                paff.append(
                    (sid, enc.intern_key(term.topology_key), pred.matches(ns, pod.metadata.labels))
                )
            for wt in aff.pod_affinity.preferred:
                pred = pred_of(wt.term)
                sid = enc.intern_predicate(pred.namespaces, pred.selector)
                ppref.append((sid, enc.intern_key(wt.term.topology_key), float(wt.weight)))
        if aff and aff.pod_anti_affinity:
            for term in aff.pod_anti_affinity.required:
                pred = pred_of(term)
                sid = enc.intern_predicate(pred.namespaces, pred.selector)
                panti.append((sid, enc.intern_key(term.topology_key)))
            for wt in aff.pod_anti_affinity.preferred:
                pred = pred_of(wt.term)
                sid = enc.intern_predicate(pred.namespaces, pred.selector)
                ppref.append((sid, enc.intern_key(wt.term.topology_key), -float(wt.weight)))
        if len(paff) > c.pod_aff_max or len(panti) > c.pod_anti_max or len(ppref) > c.pod_pref_max:
            d["fallback"] = True
        d["paff"], d["panti"], d["ppref"] = (
            paff[: c.pod_aff_max],
            panti[: c.pod_anti_max],
            ppref[: c.pod_pref_max],
        )

        # the pod's own carried terms (for in-batch carry + eterm matching)
        d["eterm_ids"], d["eterm_ws"] = enc._pod_eterms(pod)

        # host ports
        ports = pod_host_ports(pod)
        d["port_ids"] = [enc.intern_port(proto, port) for (_, proto, port) in ports]

        per_pod.append(d)

    # ---- pass 2: fixed-shape arrays (capacities now final) -----------------
    # re-read the config: pass-1 interning may have GROWN capacities, and
    # _grow replaces enc.cfg with a new object — the `c` bound above would
    # silently allocate stale-shaped arrays (caught by the differential fuzz)
    c = enc.cfg
    S, T = c.s_cap, c.t_cap
    svc_mask = enc.service_sid_mask()
    b = {
        "valid": np.zeros(P, np.bool_),
        "req": np.zeros((P, c.r_cap), np.int32),
        "nonzero_req": np.zeros((P, c.r_cap), np.int32),
        "node_name_row": np.full(P, -1, np.int32),
        "tolerates_unschedulable": np.zeros(P, np.bool_),
        "ns_key": np.full((P, c.ns_max), -1, np.int32),
        "ns_op": np.full((P, c.ns_max), -1, np.int32),
        "ns_vals": np.full((P, c.ns_max, c.aff_vals), -2, np.int32),
        "ns_num": np.zeros((P, c.ns_max), np.int32),
        "aff_has": np.zeros(P, np.bool_),
        "aff_key": np.full((P, c.aff_terms, c.aff_exprs), -1, np.int32),
        "aff_op": np.full((P, c.aff_terms, c.aff_exprs), -1, np.int32),
        "aff_vals": np.full((P, c.aff_terms, c.aff_exprs, c.aff_vals), -2, np.int32),
        "aff_num": np.zeros((P, c.aff_terms, c.aff_exprs), np.int32),
        "aff_term_valid": np.zeros((P, c.aff_terms), np.bool_),
        "aff_match_name_row": np.full((P, c.aff_terms), -1, np.int32),
        "pref_key": np.full((P, c.pref_terms, c.aff_exprs), -1, np.int32),
        "pref_op": np.full((P, c.pref_terms, c.aff_exprs), -1, np.int32),
        "pref_vals": np.full((P, c.pref_terms, c.aff_exprs, c.aff_vals), -2, np.int32),
        "pref_num": np.zeros((P, c.pref_terms, c.aff_exprs), np.int32),
        "pref_weight": np.zeros((P, c.pref_terms), np.float32),
        "pref_term_valid": np.zeros((P, c.pref_terms), np.bool_),
        "tol_key": np.full((P, c.tol_max), -9, np.int32),
        "tol_op": np.full((P, c.tol_max), -1, np.int32),
        "tol_val": np.full((P, c.tol_max), -2, np.int32),
        "tol_effect": np.full((P, c.tol_max), -1, np.int32),
        "spread_key": np.full((P, c.spread_max), -1, np.int32),
        "spread_sid": np.full((P, c.spread_max), -1, np.int32),
        "spread_skew": np.zeros((P, c.spread_max), np.int32),
        "spread_hard": np.zeros((P, c.spread_max), np.bool_),
        "spread_self": np.zeros((P, c.spread_max), np.bool_),
        "paff_sid": np.full((P, c.pod_aff_max), -1, np.int32),
        "paff_key": np.full((P, c.pod_aff_max), -1, np.int32),
        "paff_self": np.zeros((P, c.pod_aff_max), np.bool_),
        "panti_sid": np.full((P, c.pod_anti_max), -1, np.int32),
        "panti_key": np.full((P, c.pod_anti_max), -1, np.int32),
        "ppref_sid": np.full((P, c.pod_pref_max), -1, np.int32),
        "ppref_key": np.full((P, c.pod_pref_max), -1, np.int32),
        "ppref_w": np.zeros((P, c.pod_pref_max), np.float32),
        "match_sel": np.zeros((P, S), np.bool_),
        "match_svc": np.zeros((P, S), np.bool_),
        "match_eterm": np.zeros((P, T), np.bool_),
        "eterm_add": np.zeros((P, T), np.float32),
        "port_mask": np.zeros((P, c.pv_cap), np.bool_),
        "image_ids": np.full((P, c.images_max), -1, np.int32),
        "image_total": np.zeros(P, np.float32),
        "ctrl_id": np.full(P, -1, np.int32),
        "priority": np.zeros(P, np.int32),
    }
    fallback = np.zeros(P, np.bool_)

    for i, pod in enumerate(pods):
        d = per_pod[i]
        ns = pod.metadata.namespace
        spec = pod.spec
        b["valid"][i] = True
        b["priority"][i] = pod.priority

        req = enc.encode_resources(compute_pod_resource_request(pod), ceil=True)
        nz = enc.encode_resources(
            compute_pod_resource_request(pod, non_zero=True), ceil=True
        )
        b["req"][i] = zpad(req, c.r_cap)
        b["nonzero_req"][i] = zpad(nz, c.r_cap)
        b["req"][i, RES_PODS] = 1
        b["nonzero_req"][i, RES_PODS] = 1

        if spec.node_name:
            row = enc.row_of(spec.node_name)
            b["node_name_row"][i] = row if row >= 0 else -2

        b["tolerates_unschedulable"][i] = tolerations_tolerate_taint(
            spec.tolerations, Taint(TAINT_NODE_UNSCHEDULABLE, "", v1.TAINT_NO_SCHEDULE)
        )

        # node_selector map (AND of In exprs)
        items = list(spec.node_selector.items())
        if len(items) > c.ns_max:
            d["fallback"] = True
            items = items[: c.ns_max]
        for j, (k, v) in enumerate(items):
            b["ns_key"][i, j] = max(enc.key_vocab.get(k), -2)
            b["ns_op"][i, j] = ENC_OP_IN
            b["ns_vals"][i, j, 0] = max(enc.val_vocab.get(v), -2)

        # required node affinity
        node_aff = spec.affinity.node_affinity if spec.affinity else None
        if node_aff and node_aff.required and node_aff.required.terms:
            terms = node_aff.required.terms
            if len(terms) > c.aff_terms:
                d["fallback"] = True
                terms = terms[: c.aff_terms]
            b["aff_has"][i] = True
            for t_i, term in enumerate(terms):
                b["aff_term_valid"][i, t_i] = True
                exprs = term.match_expressions
                if len(exprs) > c.aff_exprs:
                    d["fallback"] = True
                    exprs = exprs[: c.aff_exprs]
                for e_i, r in enumerate(exprs):
                    e = _encode_expr(enc, r, c.aff_vals)
                    if e is None:
                        d["fallback"] = True
                        continue
                    key_id, op, vids, num = e
                    b["aff_key"][i, t_i, e_i] = key_id
                    b["aff_op"][i, t_i, e_i] = op
                    for v_i, vid in enumerate(vids):
                        b["aff_vals"][i, t_i, e_i, v_i] = vid
                    b["aff_num"][i, t_i, e_i] = num
                # matchFields: only metadata.name In [x] supported
                for mf in term.match_fields:
                    if mf.key == "metadata.name" and mf.operator == OP_IN and len(mf.values) == 1:
                        row = enc.row_of(mf.values[0])
                        b["aff_match_name_row"][i, t_i] = row if row >= 0 else enc.cfg.n_cap
                    else:
                        d["fallback"] = True

        # preferred node affinity
        if node_aff and node_aff.preferred:
            prefs = node_aff.preferred
            if len(prefs) > c.pref_terms:
                d["fallback"] = True
                prefs = prefs[: c.pref_terms]
            for t_i, pt in enumerate(prefs):
                b["pref_term_valid"][i, t_i] = True
                b["pref_weight"][i, t_i] = float(pt.weight)
                exprs = pt.preference.match_expressions
                if len(exprs) > c.aff_exprs:
                    d["fallback"] = True
                    exprs = exprs[: c.aff_exprs]
                for e_i, r in enumerate(exprs):
                    e = _encode_expr(enc, r, c.aff_vals)
                    if e is None:
                        d["fallback"] = True
                        continue
                    key_id, op, vids, num = e
                    b["pref_key"][i, t_i, e_i] = key_id
                    b["pref_op"][i, t_i, e_i] = op
                    for v_i, vid in enumerate(vids):
                        b["pref_vals"][i, t_i, e_i, v_i] = vid
                    b["pref_num"][i, t_i, e_i] = num

        # tolerations
        tols = spec.tolerations
        if len(tols) > c.tol_max:
            d["fallback"] = True
            tols = tols[: c.tol_max]
        for j, tol in enumerate(tols):
            if tol.key == "":
                b["tol_key"][i, j] = -1  # wildcard
            else:
                b["tol_key"][i, j] = max(enc.key_vocab.get(tol.key), -2)
            b["tol_op"][i, j] = (
                TOL_OP_EXISTS if tol.operator == v1.TOLERATION_OP_EXISTS else TOL_OP_EQUAL
            )
            b["tol_val"][i, j] = max(enc.val_vocab.get(tol.value), -2)
            b["tol_effect"][i, j] = _TOL_EFFECT.get(tol.effect, -1)

        for j, (key_id, sid, skew, hard, self_m) in enumerate(d["spreads"]):
            b["spread_key"][i, j] = key_id
            b["spread_sid"][i, j] = sid
            b["spread_skew"][i, j] = skew
            b["spread_hard"][i, j] = hard
            b["spread_self"][i, j] = self_m

        for j, (sid, key_id, self_m) in enumerate(d["paff"]):
            b["paff_sid"][i, j] = sid
            b["paff_key"][i, j] = key_id
            b["paff_self"][i, j] = self_m
        for j, (sid, key_id) in enumerate(d["panti"]):
            b["panti_sid"][i, j] = sid
            b["panti_key"][i, j] = key_id
        for j, (sid, key_id, w) in enumerate(d["ppref"]):
            b["ppref_sid"][i, j] = sid
            b["ppref_key"][i, j] = key_id
            b["ppref_w"][i, j] = w

        # cross-match tensors
        b["match_sel"][i, : len(enc.sel_vocab)] = enc._match_vec(
            ns, pod.metadata.labels
        )
        b["match_svc"][i] = b["match_sel"][i] & svc_mask
        for t_i, et in enumerate(enc.eterm_vocab.items):
            b["match_eterm"][i, t_i] = et.predicate.matches(ns, pod.metadata.labels)
        for tid, w in zip(d["eterm_ids"], d["eterm_ws"]):
            b["eterm_add"][i, tid] += w

        for pid in d["port_ids"]:
            b["port_mask"][i, pid] = True

        # images
        imgs = []
        total = 0.0
        for cont in spec.containers:
            if cont.image:
                iid = enc.image_vocab.get(cont.image)
                if iid >= 0:
                    imgs.append(iid)
        imgs = sorted(set(imgs))[: c.images_max]
        for j, iid in enumerate(imgs):
            b["image_ids"][i, j] = iid

        # controller ref for NodePreferAvoidPods
        for ref in pod.metadata.owner_references:
            if ref.controller:
                b["ctrl_id"][i] = enc.avoid_vocab.get(f"{ref.kind}/{ref.name}")
                break

        fallback[i] = d["fallback"]

    batch = PodBatch(
        **{k: torch.tensor(v, device=enc.device) for k, v in b.items()}
    )
    batch_np = PodBatch(**b)
    return EncodedBatch(
        batch=batch, pods=list(pods), fallback=fallback, batch_np=batch_np
    )
