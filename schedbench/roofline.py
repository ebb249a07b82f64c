"""Peaks of the card and the least bytes each measured kernel's work needs.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 3.35 TB/s
of HBM3 and 67 TFLOP/s in float32 outside the tensor cores. A share is
stated against these whatever the card's power limit; the run's
``nvidia-smi`` reading goes beside it in PERF.md.

The bytes count what the cell's inputs need, read once and written once,
whatever the program reads again or pads: the configuration's real nodes
(not the snapshot's padded rows), the one pod template a batch of these
configurations holds, and only the resource columns its pods request
(CPU, memory, one pod slot). The arithmetic of both is a handful of
operations a node, far below the bytes' time, so both are bound by bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

I32 = 4
F32 = 4
BOOL = 1
# resource columns a pod of these configurations requests: cpu, memory, pods
RES_USED = 3


def fit_mask_bytes(cfg: dict, templates: int = 1) -> int:
    """K1 (``fit_mask_kernel``): each template's requests, each node's free
    columns, one mask byte per (template, node)."""
    n = int(cfg["num_nodes"])
    return templates * RES_USED * I32 + n * RES_USED * I32 + templates * n * BOOL


def wave_batch_bytes(cfg: dict, pods: int) -> int:
    """One wave batch of `pods` pods: every node's allocatable, requested
    and scoring (cpu, memory) columns, its zone and its valid flag, and,
    with pod affinity, its matching-pod count and its existing-term weight,
    read once; each pod's template index and valid flag read once; each
    pod's chosen row, placed and deferred flags and score, the template's
    feasibility row, and each node's updated requested columns (and
    affinity columns) written once."""
    n = int(cfg["num_nodes"])
    aff = cfg.get("required_pod_affinity") is not None
    node_in = n * (RES_USED * I32 + RES_USED * I32 + 2 * I32 + I32 + BOOL)
    node_out = n * (RES_USED * I32 + 2 * I32)
    if aff:
        node_in += n * (I32 + F32)
        node_out += n * (I32 + F32)
    pod_in = pods * (I32 + BOOL)
    pod_out = pods * (I32 + BOOL + BOOL + F32)
    return node_in + node_out + pod_in + pod_out + n * BOOL


def share_pct(bytes_moved: float, seconds: float) -> float:
    """Percent of the bytes roofline: least time over measured time."""
    return 100.0 * (bytes_moved / HBM_BYTES_PER_S) / seconds
