"""Chip smoke test of the PyTorch/CUDA port (kubernetes_tpu_torch) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, the CUDA toolkit's ``nvcc`` and nothing else of
the network or the JAX package. Both kernels (csrc/fit_mask.cu and
csrc/fit_least_alloc.cu) are built first, by two nvcc processes started
together, into build/kernels/. Phases (any failure exits non-zero):

1. K1, the hand-written resource-fit kernel, against its plain PyTorch
   version on the card: the main-path shape [TPL, 8192, 6] for TPL = 8
   and 64, ragged N (700, 5001), R = 1 and R = 12, zero-request columns
   and negative free; and the edge shapes of its tiling: N % 4 = 1, 2, 3
   (8193-8195), N < 4, TPL off its 4-template tile, TPL > 256, and one
   shard's rows of the main path over a mesh of 4 and of 8 ([4, 2048, 6],
   [4, 1024, 6]).
   Tolerance: none, the masks must be bit-equal. At [8, 8192, 6] and
   [64, 8192, 6] (and at the main path's live shape after phase 2) it is
   timed: the launch floor (fit_mask_floor_launch, an empty kernel with
   K1's grid), per call from Python, and the parent commit's
   wrapper and kernel in turns (parent, new, new, parent) when they have
   been placed under build/tree/ (see load_parent).
1b. K2, the fused fit mask + least-allocated score, against its plain
   version at [16, 8192, 6], [16, 700, 6], [16, 5001, 6], [4, 8192, 1]
   and [8, 5001, 12], and at its tiling's edges: TPL off its 4-template
   tile (17, 5, 3), N % 4 = 3, 1, 2, N < 4, TPL > 256; with zero-request
   templates, negative free, alloc = 0 columns and an exact fit. The mask
   must be bit-equal; the score bit-equal too, else the largest
   difference is printed and the run fails above 1e-6 relative. Timed
   like K1 (floor, per call, parent in turns) at [16, 8192, 6],
   [16, 5001, 6] and [8, 5001, 12]. No path of the system runs K2: it is
   a standalone kernel, as in the reference.
1c. [nodeloss] (the first Scheduler phase, while the interpreter's heap
   is small): node loss as tests/test_chaos_pipeline.py's kubelet cases
   run it, at SchedulingBasic/5000's 5,000 nodes in 10 zones (all of
   them rows of the snapshot on the card), the 2,500 of zone-0 .. zone-4
   lease-managed (a kubelet each in one NodeAgentPool, heartbeat 1.0 s,
   and a node lease; cut from all 5,000, whose heartbeat and lifecycle
   passes reached 24 s in one interpreter, past the grace period), in a
   bind-ledger store that keeps 20,000 events a kind for watch resumption,
   the Scheduler on the card with the reference's settings, the
   replicaset controller's reconcile (its workers, fed by its
   ReplicaSets' writes and a resync every resync_period: the copied
   controller's watch loop takes one pod event a turn) and 10 ReplicaSets of 500 of
   the workload's pods, each in a namespace of its own: rs-0 tolerating
   every taint, rs-1 the unreachable taint for 3 s, rs-2 .. rs-9 nothing.
   Once all are bound the node-lifecycle controller starts (monitor
   period 0.5 s, grace 10.0 s, raised from 4.0 s because the heartbeat
   pass over the kubelets reaches 5 s; eviction timeout 1.0 s, eviction
   limiter 100 qps); at one instant zone-3's 500 kubelets stop and an
   11th ReplicaSet of 500 is created, whose waves run while the taints
   land. Once every replacement is bound, 100 of the dead nodes' kubelets
   restart; once their taints are lifted, the 11th ReplicaSet grows by
   500. Requires every killed node to carry both lifecycle taints in the
   API server and in its rows on the card (taint_key, taint_val,
   taint_effect fetched by fetch_device_rows, equal to the host encoding
   and the masters), no other node ever tainted, the partial-disruption
   gauge 0 at every pass, every rs-1 .. rs-9 pod of a killed node evicted
   (rs-1's no sooner than 3 s after its node went NotReady) and every
   rs-0 pod kept in place, node_lifecycle_evictions_total risen by the
   pods deleted from killed nodes, every ReplicaSet back at its replicas,
   all bound, none on a taint it does not tolerate (from the API server),
   requested <= allocatable, every bind applied once, the revived rows
   untainted on the card and one of the last 500 pods on a revived node,
   K1 launched after the kill, one 4096-pod replacement batch on the
   tainted snapshot (encoded afresh from the API server) held card
   against CPU (hold_batch) with no pod on a killed node it does not
   tolerate, 0 guard trips, drift rows, rebuilds and device-down, an
   auditor pass and no ERROR. Prints kill -> all tainted, -> first
   eviction, -> all evicted, -> every replacement bound, evictions and
   deferred evictions, the lifecycle and heartbeat pass times (p50, max),
   the wave batches after the kill, K1 launches, the pods bound to revived
   nodes, the full collections and the card (each pass's timeline and
   the threads' CPU when a check fails).
2. The main path: SchedulingPodAffinity/5000 (5,000 nodes, 1,000 initial
   pods, 5,000 measured pods with required zone pod-affinity; random
   choices from --seed) encoded on the card and scheduled batch by batch
   through scheduler/wavepath.py. Requires every pod placed, requested <=
   allocatable on every node, every placed pod in a zone that held an
   app=bench pod before its batch, the kernel-output guards passing on
   every batch, and K1 launched by the run.
3. One batch of the main path through the wave kernel twice, from the
   same snapshot clone and the same tie noise: with K1 and with the plain
   fit. Every WaveResult field and the returned snapshot must be equal.
4. The same batch through the wave kernel on the CPU (the path the tier-1
   tests hold against the JAX reference) against the card's run: exact
   masks, counts and snapshot; scores within rtol = 1e-5; chosen nodes
   equal except inside a TIE_EPS near-tie.
4b. The serial lattice on one 128-pod batch (SERIAL_HOLD_PODS, cut from
   512 and then 256 to keep the script inside its time limit) of the
   main path's workload at 5,000 nodes (n_cap 8192, v_cap 8192, t_cap
   64), on the card and then on the CPU from the same snapshot and tie
   noise: chosen, feasible_count and resolvable must be equal, the
   largest score difference is printed; the card's run on the batch is
   profiled (device busy against wall).
4c. [mesh]: node-axis sharding over 4 virtual entries of the card
   (parallel/mesh.virtual_devices: one process driving an ordered device
   list, as the reference's single controller drives its mesh), from the
   main path's snapshot (n_cap 8192, 2,048 rows a shard): one 4096-pod
   wave batch through the sharded wave kernel and the single-device one
   with the same noise — every output and the committed snapshot must be
   equal, K1 on each shard's rows equal to its plain version, K1 launched
   once a shard; one 64-pod serial batch, sharded against single, equal;
   SchedulingPodAffinity/5000 through run_benchmark with the Scheduler on
   the 4 entries (the gate of phase 5: all bound once, affinity held, 0
   trips, drift, rebuilds, no ERROR, K1 launched); then, on the fault
   cluster, entries 2 and 3 failing the probe with launch 0 lost (the
   mesh must shrink to [0, 1], every pod bound once on the device,
   scheduler_mesh_devices 2) and only entry 1 answering (the encoder
   pinned to entry 1). Copies between two cards are not exercised: the
   card is one.
4d. [dist]: the mesh over processes (parallel/distributed.py). Two
   worker processes (this script with --dist-worker) on cuda:0 join a
   gloo group through a file store (GLOO_SOCKET_IFNAME=lo), each adding 2
   virtual entries: a global mesh of 4 entries, 2,048 rows a shard of
   n_cap 8192. Each builds SchedulingPodAffinity/5000's cluster from
   --seed (nodes, initial pods placed through the wave path) and runs one
   4096-pod wave batch (512 candidates) and one 64-pod serial batch, the
   tie noise drawn from generators seeded alike, through the set_sharding
   upload; every merge and row read is a collective staged through host
   memory. Each worker's outputs (chosen, placed, deferred,
   feasible_count, score; the serial chosen, score, feasible_count), its
   local mask parts and its committed local blocks must equal this
   process's single-device run of the same batches exactly; K1 on each
   local shard equals its plain version and launches once a local shard.
   Then the same batches in one worker under a 1-rank NCCL group (one
   card admits no second NCCL rank), equal too. Each spawn is killed and
   fails the run past 150 s. Prints each worker's wave wall p50 of 5,
   collectives and bytes a batch and the serial pod step beside [mesh]'s
   one-process figures.
5. The system's own entry point: perf/harness.run_benchmark of
   SchedulingPodAffinity/5000 through the port's APIServer, informers,
   queue and Scheduler (split-phase readback, assume and bind), after one
   warm-up run of SchedulingPodAffinity/500 presized to 5,000 nodes.
   Requires 5000/5000 bound, 0 kernel guard trips, 0 unwound trailing
   assumes, no ERROR logged by the port (a "scheduling batch failed"
   included), K1 launched, requested <= allocatable on every node from the
   API server's bindings, and every measured pod in a zone that held an
   app=bench pod.
6. Latency: run_latency_benchmark at max(10, min(0.3 x the burst pods/s,
   2000)) pods/s with 500 pods (bench.py's rule); all 500 must bind, K1
   must be launched, waterfall_vs_e2e (the mean in-cycle span sum over the
   e2e histogram's mean) must lie in 0.95-1.05, and the p99 exemplar's
   trace id must resolve through the tracer to a finished trace.
7. [serial]: SchedulingPodAffinity/5000 with SERIAL_MEASURED = 500
   measured pods (cut from 5,000 to keep the script inside its time
   limit) through run_benchmark with use_wave=False (the serial lattice at
   batch 4096): the gate of phase 5 (every measured pod bound, bindings
   checked from the API server, 0 guard trips, no ERROR logged); pods/s,
   batches and serial-kernel seconds per batch.
8. [preempt]: run_preemption_benchmark at an eighth of the reference's
   defaults (PREEMPT_NODES = 125 full nodes, a burst of 125 priority-100
   pods needing victims; cut from 1,000, whose burst can spend minutes in
   oracle_reject host walks, to keep the script inside its time limit).
   Requires every preemptor bound, vector attempts > 0, no
   kernel_error fallback and no preemption guard trip.
9. [standby]: start_standby() on SchedulingPodAffinity/5000's cluster,
   500 pods queued while it stands by, promote(), all 500 bound; the
   warm-up seconds and the promotion ms. Requires exactly one standby
   warm-up and all 500 bound, with the bindings checked.
9b. [ha]: the leader-elected failover of tests/test_chaos_ha.py on the
   same cluster, in a store with a bind ledger and a one-shot bind
   refusal (ha_store) behind one shared Cacher, every replica a
   Scheduler on the card that stands by first and a LeaderElector with
   the reference's fast lease (1.5 s, renew 1.0 s, retry 0.2 s) whose win
   promotes it with the lease's fence. Leader A binds 1,000 measured
   pods; the refusal is armed and 4,096 more created; once A's
   ride-through buffer holds parked binds A dies (its elector crashes
   without releasing, its Scheduler stops) and the store recovers;
   standby B takes the lease, adopts the in-flight pods from the store
   and binds them. Then replica C stands by and B's elector is paused
   with B's Scheduler running: once C leads, B's fenced bind of a pod no
   profile owns must raise LeaderFenced and leave it unbound, and a
   racing burst of 500 pods must bind once each. Requires B promoted,
   scheduler_ha_adoptions_total{outcome="pending"} risen, the first bind
   after the kill within one autoscaler period (5.0 s), every measured
   pod bound exactly once on the ledger, the bindings checked, each
   replica pre-warmed once and no full snapshot upload after its
   bring-up, K1 launched by B's adopted waves, 0 guard trips, drift
   rows, rebuilds and device-down, and no ERROR but the zombie's own
   fence records. Prints kill -> promoted, -> first bind, -> all bound,
   the ride-through depth at the kill, the adoption outcomes, fenced
   binds by path, K1 launches per replica and the card.
10. [audit] (right after phase 5, on its cluster: the API server's 5,000
   nodes and 6,000 bound pods, encoded on the card and on the CPU): 16
   rows of `requested` and `valid` corrupted in device state; one
   audit_once() must report exactly those rows, repair and confirm them
   with no rebuild, the card's report equal to the CPU's; one clean pass
   and fetch_device_rows of 64 rows timed (p50 of 20).
11. [hostcb]: phase 5's run with host_callback_binds=True: 5000/5000
   bound, 0 guard trips, 0 blocking readbacks, every launched wave
   batch's payload taken from a delivery, the ticket registry's backlog
   back to its start, K1 launched, each pod bound once.
12. [whatif] (after [hostcb], on phase 5's cluster: 5,000 nodes, 6,000
   bound pods, n_cap 8192, so 3,192 rows free, encoded into a scheduler
   cache on the card and one on the CPU): one what-if overlay of 64
   virtual nodes (16 of each autoscaler bench shape) and 16 masked rows,
   every field equal card against CPU, the card's live generation
   bit-identical afterwards (compared on the card) and sharing no storage
   with the overlay; one WhatIfSimulator.simulate of 256 pending pods on
   both with the same tie noise, chosen and fallback equal. Prints the
   overlay build p50, the pass's wall, ms per pod step, and a profiled
   pass's device busy time and launches.
12b. [gym] (on the same two caches): one tuner/scoring.build_overlay of
   GYM_PODS = 64 of SchedulingPodAffinity's pods on each (cut from 128 to
   keep the script inside its time limit), the host columns equal;
   four arms (the incumbent, `pack`, the TOPSIS arm, one perturbation)
   replayed on both with the same tie noise: chosen rows and every
   WaveOutcome field equal, the card's live generation bit-identical
   afterwards. Prints each arm's wall and ms per pod step on the card, a
   profiled arm's device busy time and launches, and one whole
   PolicyTuner pass (every arm it assembles) on the card.
13. [autoscaler]: run_autoscaler_benchmark(n_pods=AUTOSCALER_PODS), bench.py's
   Autoscaler/1k-pending-4-shapes cut to 250 pods to keep the script
   inside its time limit. Requires every pod bound (checked
   from the API server, each pod bound once), every node from the
   catalog, no ERROR logged, 0 guard trips, drift rows, rebuilds and
   device-down, and K1 launched.
14. [hetero]: run_hetero_benchmark(n_pods=HETERO_PODS), 150 pods (cut
   from 300 to keep the script inside its time limit): both arms bind
   every pod and the cost-aware fleet is strictly cheaper.
15. [defrag]: run_defrag_benchmark() at its defaults: every replica bound
   after, the fleet strictly tighter, any plan abort a rolled-back drift
   abort (aborts and rejections printed by reason).
16. [hardpair]: SchedulingPodAntiAffinity/5000 through run_benchmark (the
   hard-pair path): the gate of phase 5 (all bound, bindings checked, no
   two measured pods on one node, 0 guard trips, K1 launched); pods/s and
   the waves of every launched batch.
16a. [suite]: every other scheduling workload of perf/workloads.py at its
   defined size, through run_benchmark with the reference's settings, in
   this order: Gang/5000 (15,000 pods in 300 gangs of 50, min-member 50)
   under the coscheduling profile built as bench.py builds it, with its
   600 s timeout; TopologySpreading/5000; SchedulingBasic/5000;
   SchedulingNodeAffinity/5000; SchedulingPreferredPodAffinity/5000;
   SchedulingSecrets/5000; SchedulingDensity/1000 (30,000 pods); and
   SchedulingInTreePVs/500 (the host lane). Each: the gate of phase 5
   (all measured pods bound, 0 guard trips and unwound assumes, the
   defense counters 0, no ERROR, K1 launched), and its placements checked
   from the API server's objects against the workload's own spec: every
   pod bound exactly once, requested <= allocatable on every node; Gang:
   every gang wholly bound (a partly bound gang fails) and 0 Permit
   timeouts; TopologySpreading: app=bench pods per zone within maxSkew 1;
   NodeAffinity: every measured pod in zone-0 .. zone-{zones/2 - 1};
   InTreePVs: at most 16 GCE PDs on a node (non_csi.go) and every disk on
   one pod; PreferredPodAffinity: the share of measured pods in a zone
   holding another app=bench pod is printed (preferred: no hard check).
   Then one fresh measured batch of the workload through the wave path
   (main_path's cluster), held as in phases 3 and 4: K1 against the plain
   fit on the card, and the CPU against the card, chosen nodes equal but
   for near-ties, each shown against its TIE_EPS bound. One line per
   workload: bound/measured, pods/s, e2e p50/p99, batches, K1 launches,
   blocking readbacks per batch, guard trips, unwound assumes, pod
   creation seconds, for Gang the Permit waits, timeouts and rejects, and
   the (pods, placed) of the first 8 committed wave batches with the
   median placed per batch (a hard-spread burst's mode shows there).
   [time] is printed before and after, thread_report before.
16a'. [soak]: perf/soak.run_soak (the counterpart of scripts/soak.py) on
   the card in the reference's small, aggressive shape: SOAK_NODES = 10
   nodes of 16 CPUs and 110 pods (scripts/repro_mismatch.py's node count,
   a 1,100-pod capacity), the replicaset and deployment controllers,
   hollow kubelets, and the Scheduler (use_mesh off) under SOAK_MINUTES =
   2.5 minutes of the reference's pod, node-cordon and service churn,
   which runs the backlog past capacity; then marking quiescence, the
   capacity-release refill probe and the quiesce-and-audit rounds of the
   device snapshot against the host masters, and the stage gate (finish
   CPU <= 5 s, wall <= 60 s). Requires SOAK PASS with pending > 0 (so the
   refill probe ran), refill_ok, unmarked 0, no device/host mismatch,
   K1 launched, memory_allocated and the pinned host bytes within 64 MiB
   of their 2-minute values after minute 2, snapshot_generation_retiring
   0 at every passing audit, and the auditor's drift rows, rebuilds and
   device-down 0. Prints the SOAK line, the samples at 2 minutes, at the
   end of the churn and at the peak, the audits, K1's launches and the
   card. [time] is printed after it.
16b. [tuner]: run_tuner_benchmark() at the reference's defaults (8
   nodes, 4 rounds, the cost flip, timeout 120 s): every burst bound, no
   promotion before the flip, a converged promotion with a cost weight,
   0 guard trips, drift, rebuilds and device-down; baseline and tuner-on
   pods/s, overhead, time to converge, gym passes, pass p50/p99.
16c. [cmd]: cmd/scheduler.run(server, KubeSchedulerConfiguration(
   tune_policy=True), block=False) with no device (the card), from the
   main thread (the cache debugger's SIGUSR2 handler), its health
   endpoints on a free port (healthz_port=0 would serve none), then
   SchedulingPodAffinity/5000's nodes, initial and measured pods created
   through the server: every pod bound once with requested <=
   allocatable, /healthz, /readyz and /metrics 200, the debugger's dump
   with its policy-gym section, a gym pass after the burst, K1 launched,
   the defense counters 0; pods/s with the gym on, gym passes, pass p50.
   The tuner, then the Scheduler and its Cacher, are stopped.
16d. [kubeadm]: the whole control plane through its user entry points,
   at SchedulingPodAffinity/500's size (KUBEADM_WORKLOAD: cut from
   SchedulingPodAffinity/5000 to keep the script inside its time
   limit). cmd.kubeadm.init_cluster(
   replication=True) with every controller but the four that rescan the
   whole store under its lock (attachdetach, nodelifecycle,
   garbagecollector, podgc: with them the burst decayed to a few pods/s
   at 5,000 nodes), so not kubeadm's default controller set, and no device
   (the Scheduler, the reference's bare KubeSchedulerConfiguration(), on
   the card); a standby_cluster tailing its replication stream from a
   process of its own, as on a machine of its own (synced before the
   phase writes); 500 nodes and 100 initial pods, then 3 nodes joined
   over the bootstrap token (signed discovery, node credentials from the
   CSR controllers), then 1,000 measured pods created through the
   secured REST facade (authn, RBAC, admission, audit) by 8 admin clients
   into the WAL-backed store, fsynced and replicated, and a 100-replica
   Deployment applied through cmd.kubectl (the Deployment and ReplicaSet
   controllers make its pods). Requires K1 launched, the defense
   counters 0 and no ERROR but the node IPAM controller's "cluster CIDR
   ... exhausted" (its default /16 holds 256 node CIDRs; counted), and,
   checked on the primary's store once [failover] has stopped it (the
   check holds the interpreter for seconds, which would stall the
   listener's acks), every pod bound exactly once (a ledger on the store's
   bind_pods), requested <= allocatable on all 503 nodes and each
   measured pod in a zone that held an app=bench pod. Prints time to all
   bound, the measured burst's pods/s from the first create to the last
   bind, create-call p50/p99, K1 launches, blocking readbacks and the
   replication layer's warnings (follower ejections).
16e. [failover]: after [kubeadm], a graceful stop: the writers (the
   joined nodes' agents, the controllers) stop, and the follower must be
   in the sync set with every write acknowledged (legacy two-node
   replication ejects a follower whose ack misses its 0.75 s deadline
   and acks without it until it resyncs; the ejections are counted
   beside the primary's full-collection pauses); the primary is stopped
   and its acknowledged state taken (a ledger on the listener's ship():
   each object's rv and wire digest, the acknowledged deletes); the
   standby promotes when its 2 s lease lapses, behind the same security,
   in its own process. Requires the promoted rv at or past
   the last acknowledged rv, every acknowledged object in the promoted
   store at its rv (taken at promotion, before the promoted plane
   writes) and, where not written since, with the same wire form, no
   acknowledged delete undone and no object the primary never had; then
   1,000 pods created through the promoted REST port each bound exactly
   once by the promoted Scheduler on the card (K1 launched), requested
   <= allocatable. Prints stop -> promoted and stop -> serving, the time
   to all 1,000 bound and K1 launches.
16f. [durability]: run_durability_benchmark(n_records=DURABILITY_RECORDS):
   5,000 records (the reference's 50,000, cut to keep the script inside
   its time limit), batches of 64, 2,000 fsynced: append rates with
   fsync on and off, fsync p50/p99, recovery time. Requires the native
   WAL sink (native/walsink.cpp, built with g++) and every record
   recovered. Touches no device.
17. [guards] and [device-loss] on a 260-node cluster (SchedulingPodAffinity's
   nodes, 50 pre-bound pods, FAULT_CLUSTER, cut from 500 and 100 to keep
   the script inside its time limit; the host path binds a quarantined batch
   in seconds there) with the fault injector (testing/device_faults.py):
   a NaN score and a wild row quarantine their batches, K =
   device_loss_disable_after consecutive trips latch the device down; a
   lost launch recovers on the device after the real card's probe, every
   launch (wave or serial) lost latches after K losses. Every pod bound
   exactly once, none oversubscribed, no assume leaked.

The Scheduler phases (1c, 5-9b, 11, 13-16e, 16a) print the auditor's passes, its skips by
reason, drift rows, rebuilds and scheduler_device_down, and fail unless
the last three are 0. Every phase but the fault phases fails on any ERROR
record the port logs; a fault phase fails on any ERROR it did not cause
([kubeadm] and [failover] allow only the ones they name).

The kernel launch counts are set to 0 just before each main path (phases
1c (and again at its kill), 2, 4c, 4d (in each worker), 5, 6, 7, 8, 9, 9b, 11, 12-16c, 16a (each workload), 16a', 16d and 16e)
and read just after. The last lines are the
card's name and power limit (nvidia-smi), a ``{"kernels": [...]}`` JSON
line with each kernel's launches on the Scheduler's burst run
(``launches``), the latency run (``launches_latency``), the serial,
preemption, standby and host-callback runs (``launches_serial``,
``launches_preempt``, ``launches_standby``, ``launches_hostcb``), the
failover's three replicas together (``launches_ha``), the node loss
(``launches_nodeloss``), the
what-if pass (``launches_whatif``: the serial lattice, no Pallas kernel
on it), the autoscaler, heterogeneity, defragmentation and hard-pair runs
(``launches_autoscaler``, ``launches_hetero``, ``launches_defrag``,
``launches_hardpair``), the gym's replays, the tuner bench and the
process entry (``launches_gym``, ``launches_tuner``: the serial lattice,
0; ``launches_cmd``), the kubeadm control plane and its promoted standby
(``launches_kubeadm``, ``launches_failover``), the burst on the 4-shard
mesh (``launches_mesh``), the two [dist] workers' wave batches
(``launches_dist``), the [suite] workloads' runs together
(``launches_suite``), the soak (``launches_soak``),
its device time, bound, plain time, launch floor (``floor_ms``), time per
call from Python (``call_ms``) and the parent's time (``parent_ms``, null
without build/tree/), and ``{"ok": true, "device": {...}}``.

To time the parent commit against this tree in the same run, place its
kernel module and sources under the git-ignored build/tree/, e.g.
``git archive <parent> kubernetes_tpu_torch/ops/fit_kernels.py
kubernetes_tpu_torch/csrc | tar -x -C build/tree``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import importlib.util
import json
import logging
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

PARENT_TREE = Path(__file__).resolve().parent / "build" / "tree"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core 32-bit rate (no tensor cores)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of fn() issued back to back from Python, between two
    CUDA events after warm-up: the device time plus whatever host launch
    overhead the device waits on."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time per call of fn(): `iters` calls captured in one CUDA
    graph, replayed `reps` times between two CUDA events, so host launch
    overhead drops out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def fit_case(seed, tpl, n, r, device):
    g = np.random.default_rng(seed)
    req = g.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[g.random((tpl, r)) < 0.3] = 0  # sparse requests
    req[:, 0] = np.where(np.arange(tpl) % 3 == 0, 0, req[:, 0])  # zero columns
    alloc = g.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * g.random((n, r)) * 0.9).astype(np.int32)
    free[::5] -= 70000  # over-committed nodes: negative free
    return (
        torch.tensor(req, device=device),
        torch.tensor(free, device=device),
    )


def fit_bound(tpl: int, n: int, r: int):
    """(bound_ms, bound_by) for one fit mask: each input read once, the
    mask written once, against TPL*N*R compares at the 32-bit rate."""
    bytes_ = n * r * 4 + tpl * n + tpl * r * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = tpl * n * r / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def load_parent():
    """The parent commit's kernel module, when its ``ops/fit_kernels.py`` and
    ``csrc/`` have been placed under the git-ignored build/tree/ (same
    relative paths) for a parent-against-change run; else None. It builds
    its own sources into build/tree/build/kernels/."""
    path = PARENT_TREE / "kubernetes_tpu_torch" / "ops" / "fit_kernels.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location("parent_fit_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_report(name: str, build_log: str) -> None:
    """One line per compiled kernel: registers, barriers, shared memory and
    spills, from nvcc's -Xptxas=-v output."""
    entry, spill = None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            log(f"[build] {name} ptxas: {entry}: {line.split(':', 1)[1].strip()}; {spill}")


def build_kernels():
    """Both kernel libraries, built by concurrent nvcc processes; the
    parent's too (at the same time) when load_parent() finds them."""
    from kubernetes_tpu_torch.ops import fit_kernels

    t0 = time.perf_counter()
    parent = load_parent()
    failed = []

    def build_parent():
        try:
            parent.build_all()
        except Exception as e:  # reported below; the run then fails
            failed.append(e)

    side = threading.Thread(target=build_parent) if parent else None
    if side:
        side.start()
    libs = fit_kernels.build_all()
    if side:
        side.join()
        if failed:
            raise failed[0]
    log(f"[build] {', '.join(l.path.name for l in libs.values())} built/loaded "
        f"in {time.perf_counter() - t0:.2f} s"
        + ("; the parent's kernels from build/tree/ beside them" if parent else ""))
    for name, lib in libs.items():
        ptxas_report(name, lib.build_log)
    bind_measurement_entries(libs)
    return parent


def bind_measurement_entries(libs) -> None:
    """argtypes of the entries only this script calls: each kernel's empty
    launch with its grid (the launch floor)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib, name, args in (
        ("fit_mask", "fit_mask_floor_launch", (I, I, P)),
        ("fit_least_alloc", "fit_least_alloc_floor_launch", (I, I, P)),
    ):
        fn = getattr(libs[lib].cdll, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def count_k(fit_kernels) -> tuple:
    """(K1 launches, K2 launches) since the last zero_k."""
    return fit_kernels.fit_mask.launches, fit_kernels.fit_mask_least_alloc.launches


def zero_k(fit_kernels) -> None:
    """Set both kernels' launch counts to 0, just before a path runs."""
    fit_kernels.fit_mask.launches = 0
    fit_kernels.fit_mask_least_alloc.launches = 0


def in_turns(timer, a, b):
    """timer(a), timer(b), timer(b), timer(a): (mean of a, mean of b, the
    four readings in that order)."""
    r = [timer(a), timer(b), timer(b), timer(a)]
    return (r[0] + r[3]) / 2, (r[1] + r[2]) / 2, r


def _fmt(xs) -> str:
    return "/".join(f"{x * 1e3:.3f}" for x in xs)


def k1_timings(req, free, parent, what: str) -> dict:
    """K1 at one shape: the kernel through its wrapper (against the parent
    commit's wrapper and kernel in turns when present), the launch floor,
    the plain version; device time from the CUDA graph replay and the time
    per call from Python."""
    from kubernetes_tpu_torch.ops import fit_kernels

    tpl, r = req.shape
    n = free.shape[0]
    lib = fit_kernels.library("fit_mask")
    new = lambda: fit_kernels.fit_mask(req, free)  # noqa: E731
    if not torch.equal(new(), fit_kernels.fit_mask_plain(req, free)):
        raise AssertionError(f"[K1] {what} TPL={tpl} N={n} R={r}: mask differs")
    res = {"parent_ms": None, "parent_call_ms": None}
    if parent is not None:
        old = lambda: parent.fit_mask(req, free)  # noqa: E731
        if not torch.equal(old(), new()):
            raise AssertionError(f"[K1] {what}: parent and change disagree")
        res["parent_ms"], res["ms"], dev = in_turns(device_ms, old, new)
        res["parent_call_ms"], res["call_ms"], call = in_turns(call_ms, old, new)
        turns = (f"parent/new/new/parent device {_fmt(dev)} us, per call "
                 f"from Python {_fmt(call)} us; ")
    else:
        res["ms"], res["call_ms"] = device_ms(new), call_ms(new)
        turns = "parent not present (build/tree/); "

    res["floor_ms"] = device_ms(lambda: lib.cdll.fit_mask_floor_launch(tpl, n, _stream()))
    res["plain_ms"] = device_ms(lambda: fit_kernels.fit_mask_plain(req, free))
    res["bound_ms"], res["bound_by"] = fit_bound(tpl, n, r)
    log(f"[K1] {what} TPL={tpl} N={n} R={r}: bit-equal; {turns}launch floor "
        f"{res['floor_ms'] * 1e3:.3f} us; plain {res['plain_ms'] * 1e3:.3f} us; bound {res['bound_ms'] * 1e3:.4f} us "
        f"({res['bound_by']}); kernel {res['ms'] * 1e3:.3f} us, per call "
        f"{res['call_ms'] * 1e3:.3f} us")
    return res


def phase_fit_kernel(device, parent):
    from kubernetes_tpu_torch.ops import fit_kernels

    cases = [
        (8, 8192, 6), (64, 8192, 6), (4, 700, 6), (16, 5001, 6),
        (8, 8192, 1), (8, 5001, 12),
        # N % 4 = 1, 2, 3; N < 4; TPL off K1's 4-template tile; TPL > 256
        (4, 8193, 6), (5, 8194, 6), (17, 8195, 6), (3, 1, 6), (2, 2, 16),
        (7, 3, 6), (300, 4099, 6), (257, 9, 5),
        # one shard's rows of the main path over a mesh of 4 and of 8
        (4, 2048, 6), (4, 1024, 6),
    ]
    for i, (tpl, n, r) in enumerate(cases):
        req, free = fit_case(i, tpl, n, r, device)
        got = fit_kernels.fit_mask(req, free)
        torch.cuda.synchronize()
        want = fit_kernels.fit_mask_plain(req, free)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"[K1] TPL={tpl} N={n} R={r}: {bad} mask entries differ")
        ms = device_ms(lambda: fit_kernels.fit_mask(req, free))
        plain = device_ms(lambda: fit_kernels.fit_mask_plain(req, free))
        bound, by = fit_bound(tpl, n, r)
        log(f"[K1] TPL={tpl} N={n} R={r}: bit-equal; device time "
            f"kernel {ms:.5f} ms, plain {plain:.5f} ms; bound {bound:.6f} ms ({by})")
    for tpl in (8, 64):
        k1_timings(*fit_case(50 + tpl, tpl, 8192, 6, device), parent, "timed")
    log("[K1] no single PyTorch call computes this mask: library_ms is null")


def la_case(seed, tpl, n, r, device):
    """K2's inputs: sparse requests with a zero-request template, negative
    free on every 5th node, alloc = 0 on every 11th node's first column,
    and node 3 an exact fit for template 1."""
    g = np.random.default_rng(seed)
    req = g.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[g.random((tpl, r)) < 0.3] = 0
    req[0] = 0
    alloc = g.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * g.random((n, r)) * 0.9).astype(np.int32)
    free[::5] -= 70000
    alloc[::11, 0] = 0
    if n > 3 and tpl > 1:
        free[3] = req[1]
    return tuple(torch.tensor(x, device=device) for x in (req, free, alloc))


def la_bound(tpl: int, n: int, r: int):
    """(bound_ms, bound_by) for K2: free and alloc read once, the requests
    once, mask (1 B) and score (4 B) written once; against TPL*N*(3R + 1)
    float32 operations (per resource a division, a product and a sum, and
    one final division)."""
    bytes_ = 2 * n * r * 4 + tpl * r * 4 + tpl * n * 5
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = tpl * n * (3 * r + 1) / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_timings(req, free, alloc, parent) -> dict:
    """K2 at one shape, as k1_timings: against the parent in turns when
    present, the launch floor, per call from Python."""
    from kubernetes_tpu_torch.ops import fit_kernels

    tpl, r = req.shape
    n = free.shape[0]
    lib = fit_kernels.library("fit_least_alloc")
    new = lambda: fit_kernels.fit_mask_least_alloc(req, free, alloc)  # noqa: E731
    res = {"parent_ms": None, "parent_call_ms": None}
    if parent is not None:
        old = lambda: parent.fit_mask_least_alloc(req, free, alloc)  # noqa: E731
        (om, os_), (nm, ns) = old(), new()
        if not (torch.equal(om, nm) and torch.equal(os_, ns)):
            raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: parent and change disagree")
        res["parent_ms"], res["ms"], dev = in_turns(device_ms, old, new)
        res["parent_call_ms"], res["call_ms"], call = in_turns(call_ms, old, new)
        turns = (f"parent/new/new/parent device {_fmt(dev)} us, per call "
                 f"from Python {_fmt(call)} us; ")
    else:
        res["ms"], res["call_ms"] = device_ms(new), call_ms(new)
        turns = "parent not present (build/tree/); "
    res["floor_ms"] = device_ms(
        lambda: lib.cdll.fit_least_alloc_floor_launch(tpl, n, _stream())
    )
    log(f"[K2] timed TPL={tpl} N={n} R={r}: {turns}launch floor "
        f"{res['floor_ms'] * 1e3:.3f} us; kernel {res['ms'] * 1e3:.3f} us, per "
        f"call {res['call_ms'] * 1e3:.3f} us")
    return res


def phase_least_alloc(device, parent):
    """K2 against its plain version on every listed shape. Returns the
    main shape's numbers for the kernels line."""
    from kubernetes_tpu_torch.ops import fit_kernels

    cases = [
        (16, 8192, 6), (16, 700, 6), (16, 5001, 6), (4, 8192, 1), (8, 5001, 12),
        # TPL off K2's template tile; N % 4 = 3, 1, 2; N < 4; TPL > 256
        (17, 8191, 6), (5, 4097, 6), (3, 1030, 6), (6, 3, 6), (1, 1, 16),
        (300, 2049, 6),
    ]
    timed = {(16, 8192, 6), (16, 5001, 6), (8, 5001, 12)}
    out = None
    worst = 0.0
    for i, (tpl, n, r) in enumerate(cases):
        req, free, alloc = la_case(100 + i, tpl, n, r, device)
        mask, score = fit_kernels.fit_mask_least_alloc(req, free, alloc)
        torch.cuda.synchronize()
        pm, ps = fit_kernels.fit_mask_least_alloc_plain(req, free, alloc)
        if not torch.equal(mask, pm):
            bad = int((mask != pm).sum())
            raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: {bad} mask entries differ")
        if not torch.isfinite(score).all():
            raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: non-finite scores")
        diff = (score - ps).abs()
        max_abs = float(diff.max())
        worst = max(worst, max_abs)
        if max_abs == 0.0:
            eq = "bit-equal"
        else:
            rel = float((diff / ps.abs().clamp(min=1e-30)).max())
            eq = f"largest difference {max_abs:.3e} abs, {rel:.3e} relative"
            if rel > 1e-6:
                raise AssertionError(f"[K2] TPL={tpl} N={n} R={r}: score {eq}")
        ms = device_ms(lambda: fit_kernels.fit_mask_least_alloc(req, free, alloc))
        plain = device_ms(lambda: fit_kernels.fit_mask_least_alloc_plain(req, free, alloc))
        bound, by = la_bound(tpl, n, r)
        log(f"[K2] TPL={tpl} N={n} R={r}: mask bit-equal, score {eq}; device "
            f"time kernel {ms:.5f} ms, plain {plain:.5f} ms; bound {bound:.6f} ms ({by})")
        if (tpl, n, r) in timed:
            t = k2_timings(req, free, alloc, parent)
            if out is None:
                out = {**t, "plain_ms": plain, "bound_ms": bound, "bound_by": by}
    out["max_abs_err"] = worst
    log("[K2] no single PyTorch call computes this mask and score: library_ms is null")
    return out


class ErrorLog(logging.Handler):
    """Collects every ERROR record the port logs (its copied modules keep
    the reference's logger names)."""

    def __init__(self):
        super().__init__(level=logging.ERROR)
        self.records = []
        for name in ("kubernetes_tpu_torch", "kubernetes_tpu"):
            logging.getLogger(name).addHandler(self)

    def emit(self, record):
        self.records.append(record)

    def check(self, what: str) -> None:
        if self.records:
            for r in self.records[:5]:
                log(f"[{what}] ERROR logged: {r.name}: {r.getMessage()}")
            raise AssertionError(f"[{what}] {len(self.records)} ERROR records logged")

    def expect(self, what: str, allowed, raised=()) -> int:
        """The end of a fault phase, which logs ERRORs on purpose: every
        record since the phase began must contain one of the `allowed`
        messages, or carry an exception of one of the `raised` types, any
        other fails the run. Clears the records and returns how many
        there were."""
        records, self.records = self.records, []
        other = [
            r for r in records
            if not any(a in r.getMessage() for a in allowed)
            and not (r.exc_info and isinstance(r.exc_info[1], tuple(raised)))
        ]
        for r in other[:5]:
            log(f"[{what}] unexpected ERROR logged: {r.name}: {r.getMessage()}")
        if other:
            raise AssertionError(f"[{what}] {len(other)} ERROR records it did not cause")
        return len(records)


def defense_report(what: str, card: str, res=None, sched=None) -> dict:
    """The data-plane defense of one Scheduler phase: the auditor's passes,
    its skipped passes by reason, the drift rows and rebuilds it found,
    and scheduler_device_down, from a harness result (res) or from the
    metrics since the last reset and the Scheduler's latch (sched). Fails
    unless drift rows, rebuilds and device-down are all 0."""
    from kubernetes_tpu_torch.perf.harness import defense_counts

    if res is not None:
        d = {k: getattr(res, k) for k in (
            "audit_passes", "audit_skips", "drift_rows", "rebuilds", "device_down")}
    else:
        d = {**defense_counts(), "device_down": int(sched._device_down)}
    log(f"[{what}] auditor: {d['audit_passes']} passes, skipped "
        f"{json.dumps(d['audit_skips'], sort_keys=True)}; drift rows "
        f"{d['drift_rows']}, rebuilds {d['rebuilds']}; scheduler_device_down "
        f"{d['device_down']}; card {card}")
    if d["drift_rows"] or d["rebuilds"] or d["device_down"]:
        raise AssertionError(f"[{what}] drift, a rebuild or the device latched down")
    return d


def check_capacity(server, what: str):
    """Every pod in the API server bound, and requested <= allocatable (and
    the pod count <= its capacity) on every node. Returns (nodes, pods)."""
    from kubernetes_tpu_torch.scheduler.cache.nodeinfo import Snapshot

    nodes = server.list("nodes")[0]
    pods = server.list("pods")[0]
    unbound = [p.metadata.name for p in pods if not p.spec.node_name]
    if unbound:
        raise AssertionError(f"[{what}] {len(unbound)} pods unbound, e.g. {unbound[:3]}")
    snap = Snapshot.from_literals(pods, nodes)
    for ni in snap.node_info_list:
        for rname, amount in ni.requested.items():
            if amount > ni.allocatable.get(rname, 0):
                raise AssertionError(
                    f"[{what}] {ni.node.metadata.name}: {rname} requested "
                    f"{amount} > allocatable {ni.allocatable.get(rname, 0)}"
                )
        if len(ni.pods) > ni.allocatable.get("pods", 0):
            raise AssertionError(f"[{what}] {ni.node.metadata.name}: too many pods")
    return nodes, pods


def check_bindings(server, n_measured: int, what: str) -> None:
    """The correctness gate on the API server's bindings: every pod bound,
    requested <= allocatable on every node, and every measured pod
    (``pod-*``) in a zone that held an app=bench pod (its required zone
    affinity)."""
    nodes, pods = check_capacity(server, what)
    # nodes joined over a bootstrap token carry no zone: no measured pod
    # may land there
    zone_of = {n.metadata.name: n.metadata.labels.get("topology.kubernetes.io/zone") for n in nodes}
    init_zones = {
        zone_of[p.spec.node_name] for p in pods
        if p.metadata.name.startswith("init-") and p.metadata.labels.get("app") == "bench"
    } - {None}
    measured = [p for p in pods if p.metadata.name.startswith("pod-")]
    stray = [p.metadata.name for p in measured if zone_of[p.spec.node_name] not in init_zones]
    if len(measured) != n_measured or stray:
        raise AssertionError(
            f"[{what}] {len(measured)} measured pods; {len(stray)} outside "
            "the zones that held an app=bench pod"
        )
    log(f"[{what}] checked from the API server: {len(pods)} pods bound, "
        f"requested <= allocatable on all {len(nodes)} nodes, every measured "
        f"pod in one of the {len(init_zones)} zones that held an app=bench pod")


def phase_scheduler(device, card: str, errors: ErrorLog):
    """SchedulingPodAffinity/5000 through the port's APIServer and
    Scheduler (run_benchmark), after a warm-up of the same presize."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.utils.metrics import metrics

    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    t0 = time.perf_counter()
    warm = run_benchmark(
        WORKLOADS["SchedulingPodAffinity/500"], presize_nodes=wl.num_nodes,
        device=device, timeout_s=300,
    )
    if warm.unscheduled:
        raise AssertionError(f"[scheduler] warm-up left {warm.unscheduled} pods unbound")
    log(f"[scheduler] warm-up SchedulingPodAffinity/500 presized to 5000 nodes: "
        f"{warm.scheduled}/{warm.num_measured_pods} bound, "
        f"{warm.throughput_pods_per_s:.1f} pods/s ({time.perf_counter() - t0:.1f} s in all)")
    errors.check("scheduler warm-up")
    defense_report("scheduler warm-up", card, res=warm)

    server = APIServer()
    zero_k(fit_kernels)
    res = run_benchmark(wl, device=device, server=server, timeout_s=300, quiet=False)
    k1, k2 = count_k(fit_kernels)
    trips, unwound = res.guard_trips, res.unwound_assumes
    blocking = metrics.counter("scheduler_wave_readbacks_blocking_total")
    log(f"[scheduler] SchedulingPodAffinity/5000 through APIServer + Scheduler: "
        f"{res.scheduled}/{res.num_measured_pods} bound in {res.duration_s:.3f} s = "
        f"{res.throughput_pods_per_s:.1f} pods/s; e2e p50/p90/p99 "
        f"{res.e2e_p50_ms:.1f}/{res.e2e_p90_ms:.1f}/{res.e2e_p99_ms:.1f} ms; "
        f"encode {res.encode_total_s:.3f} s, kernel {res.kernel_total_s:.3f} s; "
        f"{res.n_batches} batches, {res.n_readbacks} blocking readbacks = "
        f"{res.readbacks_per_batch:.3f} per batch ({blocking:.0f} blocking syncs "
        f"in all); pipeline depth {res.pipeline_depth}, max in flight "
        f"{res.max_waves_inflight}; K1 launches {k1}, K2 launches {k2}; guard "
        f"trips {trips}, unwound assumes {unwound}; card {card}")
    errors.check("scheduler")
    defense_report("scheduler", card, res=res)
    if res.scheduled != res.num_measured_pods or res.unscheduled:
        raise AssertionError(f"[scheduler] {res.unscheduled} measured pods not bound")
    if trips or unwound:
        raise AssertionError(f"[scheduler] {trips} guard trips, {unwound} unwound assumes")
    if k1 <= 0:
        raise AssertionError("[scheduler] the Scheduler never launched K1")

    check_bindings(server, wl.num_measured_pods, "scheduler")
    return res, k1, k2, server


def phase_latency(device, burst_pods_per_s: float, errors: ErrorLog, card: str):
    from kubernetes_tpu_torch.perf.harness import run_latency_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.utils.tracing import tracer

    rate = max(10.0, min(burst_pods_per_s * 0.3, 2000.0))
    lat = run_latency_benchmark(
        WORKLOADS["SchedulingPodAffinity/5000"], rate, n_pods=500, device=device,
        timeout_s=120,
    )
    for stage, st in (lat.stage_waterfall or {}).items():
        log(f"[latency]   stage {stage}: {st.get('count', 0)} spans, p50 "
            f"{st.get('p50_ms', 0.0):.2f} ms, p99 {st.get('p99_ms', 0.0):.2f} ms")
    log(f"[latency] SchedulingPodAffinity/5000 at {rate:.1f} pods/s, 500 pods: "
        f"{lat.scheduled} bound; pod p50 {lat.pod_p50_ms:.2f} ms, p99 "
        f"{lat.pod_p99_ms:.2f} ms; queue-wait p99 {lat.queue_wait_p99_ms:.2f} ms; "
        f"in-flight p99 {lat.in_flight_p99_ms:.2f} ms; readbacks per bind "
        f"{lat.readbacks_per_bind:.4f}; pipeline depth {lat.pipeline_depth}, "
        f"max in flight {lat.max_waves_inflight}; guard trips {lat.guard_trips}, "
        f"unwound assumes {lat.unwound_assumes}")
    trace = tracer.get(lat.p99_trace_id) if lat.p99_trace_id else None
    log(f"[latency] waterfall_vs_e2e {lat.waterfall_vs_e2e:.4f}; p99 exemplar trace "
        f"{lat.p99_trace_id or '(none)'}: "
        + (f"finished {trace['finished']}, outcome {trace.get('outcome')}, stages "
           f"{json.dumps({k: round(v, 2) for k, v in trace['stages_ms'].items()})} ms"
           if trace else "not in the tracer"))
    errors.check("latency")
    defense_report("latency", card, res=lat)
    if lat.scheduled != 500:
        raise AssertionError(f"[latency] {lat.scheduled}/500 bound")
    if not 0.95 <= lat.waterfall_vs_e2e <= 1.05:
        raise AssertionError(f"[latency] waterfall_vs_e2e {lat.waterfall_vs_e2e} outside 0.95-1.05")
    if trace is None or not trace["finished"]:
        raise AssertionError("[latency] the p99 exemplar does not resolve to a finished trace")
    return lat


def main_path(device, seed: int, name: str = "SchedulingPodAffinity/5000", cfg=None):
    """Encode the workload's nodes on `device`, schedule its initial then
    its measured pods through the wave path, check the result. Returns a
    dict of what the caller reports. The pods that the encoder sends to
    the host lane (HOST_LANE workloads' in-tree volumes) are left to the
    Scheduler's host path: counted in "fallback", never placed here."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.ops.lattice import weights_for_policy
    from kubernetes_tpu_torch.ops.templates import TemplateCache
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler.wavepath import WavePathConfig, schedule_pods

    cfg = cfg or WavePathConfig()
    wl = WORKLOADS[name]
    nodes, init_pods, factory = build_workload(wl)
    measured = [factory(i) for i in range(wl.num_measured_pods)]
    t0 = time.perf_counter()
    enc = SnapshotEncoder(EncodingConfig.for_cluster(wl.num_nodes), device=device)
    for n in nodes:
        enc.add_node(n)
    enc.flush()
    setup_s = time.perf_counter() - t0
    cache = TemplateCache(enc)
    weights = torch.tensor(weights_for_policy("default"), device=device)
    rng = torch.Generator(device=device).manual_seed(seed)

    init = schedule_pods(enc, cache, init_pods, weights, rng, cfg)
    if init.unscheduled or init.fallback or len(init.placed) != len(init_pods):
        raise AssertionError(f"{name} init pods: {len(init.placed)}/{len(init_pods)} placed")
    zone_of = {n.metadata.name: n.metadata.labels["topology.kubernetes.io/zone"] for n in nodes}
    bench_zones = {zone_of[node] for _pod, node in init.placed}

    fit_kernels.fit_mask.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = schedule_pods(enc, cache, measured, weights, rng, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fit_kernels.fit_mask.launches

    placed = len(res.placed)
    host_lane = len(res.fallback) if wl.name in HOST_LANE else 0
    if placed + host_lane != len(measured) or res.unscheduled or len(res.fallback) != host_lane:
        raise AssertionError(
            f"{name}: {placed}/{len(measured)} placed, {len(res.unscheduled)} "
            f"unscheduled, {len(res.fallback)} fallback"
        )
    valid = enc.m_valid
    if not (enc.m_req <= enc.m_alloc)[valid].all():
        raise AssertionError(f"{name}: requested exceeds allocatable on some node")
    if wl.name == "SchedulingPodAffinity":
        for i, bo in enumerate(res.batches):
            zones = {zone_of[node] for _pod, node in bo.placed}
            if not zones <= bench_zones:
                raise AssertionError(
                    f"batch {i}: pods placed in zones {sorted(zones - bench_zones)} "
                    "that held no app=bench pod (required affinity)"
                )
            bench_zones |= zones
    return {
        "enc": enc, "cache": cache, "weights": weights, "rng": rng, "cfg": cfg,
        "factory": factory, "placed": placed, "wall_s": wall, "setup_s": setup_s,
        "batches": res.batches, "launches": launches, "host_lane": host_lane,
    }


def compare_results(a_snap, a_res, b_snap, b_res, tie_ok: bool, what: str):
    """Exact equality of masks, counts and snapshot; with tie_ok, chosen
    may differ inside a TIE_EPS near-tie (scores within rtol 1e-5): each
    such pod is shown with both rows and scores against the tie bound.
    Returns the number of near-tie chosen differences."""
    from kubernetes_tpu_torch.ops.wavelattice import TIE_EPS

    def np_(x):
        return x.cpu().numpy()

    for f in ("placed", "deferred", "feasible_count", "feasible_tpl", "resolvable_tpl"):
        if not np.array_equal(np_(getattr(a_res, f)), np_(getattr(b_res, f))):
            raise AssertionError(f"{what}: WaveResult.{f} differs")
    ca, cb = np_(a_res.chosen), np_(b_res.chosen)
    sa, sb = np_(a_res.score), np_(b_res.score)
    diff = np.flatnonzero(ca != cb)
    if diff.size and not tie_ok:
        raise AssertionError(f"{what}: chosen differs for {diff.size} pods")
    for n, i in enumerate(diff):
        gap = abs(float(sa[i]) - float(sb[i]))
        bound = TIE_EPS * max(1.0, abs(float(sa[i])))
        if n < 5 or gap > bound:
            log(f"[tie] {what}: pod {i} chose row {ca[i]} (score {float(sa[i])!r}) "
                f"against row {cb[i]} (score {float(sb[i])!r}): |gap| {gap:.3g} "
                f"{'<=' if gap <= bound else '>'} TIE_EPS bound {bound:.3g}")
        if gap > bound:
            raise AssertionError(f"{what}: pod {i} chose {ca[i]} vs {cb[i]} outside a tie")
    same = ca == cb
    if tie_ok:
        if not np.allclose(sa[same], sb[same], rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{what}: scores differ beyond rtol 1e-5")
    elif not np.array_equal(sa, sb):
        raise AssertionError(f"{what}: scores differ")
    if diff.size == 0:
        for f in a_snap._fields:
            x, y = np_(getattr(a_snap, f)), np_(getattr(b_snap, f))
            if not np.array_equal(x, y):
                raise AssertionError(f"{what}: snapshot.{f} differs")
    return int(diff.size)


def hold_batch(mp, device, what: str) -> dict:
    """Phases 3 and 4 on one fresh measured batch of `mp`'s workload: its
    wave kernel with K1 and with the plain fit on the card from the same
    snapshot clone and tie noise (every WaveResult field and the snapshot
    equal), then on the CPU with the same noise (exact masks, counts and
    snapshot, chosen equal but for shown near-ties). Returns the batch,
    its kernels, inputs and figures."""
    from kubernetes_tpu_torch.ops.templates import TemplateBatch
    from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel
    from kubernetes_tpu_torch.scheduler.wavepath import prepare_batch

    enc, cfg = mp["enc"], mp["cfg"]
    pods = [mp["factory"](100000 + i) for i in range(cfg.batch_size)]
    prep = prepare_batch(enc, mp["cache"], pods, cfg)
    snap = enc.flush()
    k = prep.kern
    args = (k.v_cap, k.m_cand, k.n_waves, k.hard_pod_affinity_weight)
    rest = (k.score_refresh, k.rtc_shape, k.has_pinned)
    kern_fit = make_wave_kernel(*args, True, *rest)
    kern_plain = make_wave_kernel(*args, False, *rest)
    m_c = min(k.m_cand, snap.valid.shape[0])
    noise = torch.rand(
        (cfg.batch_size, m_c), generator=mp["rng"], device=device
    ) * 0.999

    def clone(nt):
        return type(nt)(*(t.clone() for t in nt))

    s_fit, r_fit = kern_fit.with_noise(clone(snap), prep.eb.batch, prep.ptab, mp["weights"], noise)
    s_plain, r_plain = kern_plain.with_noise(clone(snap), prep.eb.batch, prep.ptab, mp["weights"], noise)
    compare_results(s_fit, r_fit, s_plain, r_plain, False, f"{what}: K1 vs plain fit")

    def cpu(nt):
        if isinstance(nt, TemplateBatch):
            return TemplateBatch(cpu(nt.tpl), *(t.cpu() for t in nt[1:]))
        return type(nt)(*(t.cpu() for t in nt))

    t0 = time.perf_counter()
    s_cpu, r_cpu = kern_fit.with_noise(
        cpu(snap), cpu(prep.eb.batch), cpu(prep.ptab), mp["weights"].cpu(), noise.cpu()
    )
    cpu_s = time.perf_counter() - t0
    ties = compare_results(s_cpu, r_cpu, s_fit, r_fit, True, f"{what}: CPU vs card")
    return {
        "pods": len(pods), "placed": int(r_fit.placed.sum()), "ties": ties,
        "cpu_s": cpu_s, "n_waves": prep.n_waves, "host_lane": int(prep.eb.fallback.sum()),
        "kern": kern_fit, "snap": snap, "prep": prep, "noise": noise, "clone": clone,
        "batch": pods, "res": r_fit,
    }


def phase_parity(mp, device):
    """Phases 3 and 4 on one fresh batch of the main path's workload, and
    a profile of its wave kernel."""
    h = hold_batch(mp, device, "main path")
    log(f"[wave] K1 fit == plain fit on one main-path batch: every WaveResult field "
        f"and the snapshot equal ({h['placed']} of {h['pods']} placed)")
    log(f"[wave] CPU run of the same batch ({h['cpu_s']:.2f} s) agrees with the card "
        f"({h['ties']} near-tie chosen differences)")
    kern, snap, prep, clone = h["kern"], h["snap"], h["prep"], h["clone"]
    try:
        profile_device(
            f"wave kernel, one batch of {h['pods']} pods, {h['n_waves']} waves",
            lambda: kern.with_noise(
                clone(snap), prep.eb.batch, prep.ptab, mp["weights"], h["noise"]
            ),
        )
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] wave kernel device time not measured: {e}")


def profile_device(what: str, fn) -> dict:
    """Where one call of fn() spends its time: wall time against the sum of
    device kernel time (torch.profiler), and the kernels that take most of
    it. Measurement only: says "not measured" when the profiler sees no
    device activity. Returns {"wall_ms", "busy_ms", "launches"} (busy_ms
    None when not measured)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log(f"[profile] {what}: wall {wall_ms:.2f} ms; device time not measured "
            "(the profiler saw no device activity)")
        return {"wall_ms": wall_ms, "busy_ms": None, "launches": None}
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms in {launches} kernel launches "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f})")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3, "launches": launches}


# the serial batch held card against CPU, cut from 512 pods (its CPU run
# took 9.9 s on an H100, PERF.md §4; then 256) so that the
# script, [soak] and [ha] included, stays inside its time limit
SERIAL_HOLD_PODS = 128


def serial_batch_check(mp, device) -> dict:
    """One SERIAL_HOLD_PODS-pod batch of the main path's workload through the serial
    lattice at 5,000 nodes on the card, then the same snapshot, batch and
    tie noise through the port's own CPU run (the path the tier-1 tests
    hold against the JAX reference): chosen, feasible_count and
    resolvable must be equal; the score's largest difference is printed.
    The card's run is profiled (device busy against wall)."""
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.lattice import make_schedule_batch

    enc = mp["enc"]
    pods = [mp["factory"](200000 + i) for i in range(SERIAL_HOLD_PODS)]
    eb = encode_pod_batch(enc, pods, pad_to=SERIAL_HOLD_PODS)
    snap = enc.flush()
    n = snap.valid.shape[0]
    noise = torch.rand((SERIAL_HOLD_PODS, n), generator=mp["rng"], device=device)
    kern = make_schedule_batch(enc.cfg.v_cap)
    kern(snap, eb.batch, mp["weights"], noise)  # first launch: allocator warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = kern(snap, eb.batch, mp["weights"], noise)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0

    def cpu(nt):
        return type(nt)(*(t.cpu() for t in nt))

    t0 = time.perf_counter()
    ref = kern(cpu(snap), cpu(eb.batch), mp["weights"].cpu(), noise.cpu())
    cpu_s = time.perf_counter() - t0
    for f in ("chosen", "feasible_count", "resolvable"):
        if not torch.equal(getattr(res, f).cpu(), getattr(ref, f)):
            bad = int((getattr(res, f).cpu() != getattr(ref, f)).sum())
            raise AssertionError(f"[serial] {SERIAL_HOLD_PODS}-pod batch: {f} differs at {bad} entries")
    placed = ref.chosen >= 0
    sa, sb = res.score.cpu()[placed], ref.score[placed]
    if not torch.isfinite(sa).all():
        raise AssertionError(f"[serial] {SERIAL_HOLD_PODS}-pod batch: non-finite scores")
    max_diff = float((sa - sb).abs().max()) if int(placed.sum()) else 0.0
    log(f"[serial] one {SERIAL_HOLD_PODS}-pod batch at {int(snap.valid.sum())} nodes (n_cap {n}, "
        f"v_cap {enc.cfg.v_cap}, t_cap {snap.eterm_w.shape[1]}): card {card_s:.3f} s, "
        f"CPU {cpu_s:.3f} s; chosen, feasible_count, resolvable equal "
        f"({int(placed.sum())} placed); largest score difference {max_diff}")
    if int(placed.sum()) == 0:
        raise AssertionError(f"[serial] {SERIAL_HOLD_PODS}-pod batch placed nothing")
    # the profile takes the batch's first 128 pods: the profiler's own
    # bookkeeping grows with the ~140 launches of every pod step
    sub = type(eb.batch)(*(t[:128] for t in eb.batch))
    try:
        prof = profile_device(
            "serial lattice, one 128-pod batch",
            lambda: kern(snap, sub, mp["weights"], noise[:128]),
        )
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] serial lattice device time not measured: {e}")
        prof = {}
    return {"card_s": card_s, "cpu_s": cpu_s, "max_score_diff": max_diff, **prof}


# [preempt]'s nodes and preemptors, cut from the reference's 1,000: a
# burst that spans more than one select batch can spend minutes in
# oracle_reject host walks (ROADMAP queue 3), and the script, [suite]
# included, must stay inside its time limit (250 until PR 12's last cut)
PREEMPT_NODES = 125


# [serial]'s measured pods, cut from SchedulingPodAffinity/5000's 5,000
# (three batches at 10.75 s each on an H100; then 2,000, then 1,000,
# PERF.md §4) so that the script, [soak] and [ha] included,
# stays inside its time limit
SERIAL_MEASURED = 500


def phase_serial(device, card: str, errors: ErrorLog) -> dict:
    """SchedulingPodAffinity/5000 with SERIAL_MEASURED measured pods through
    run_benchmark with use_wave=False: the serial lattice at the
    accelerator settings (batch 4096, 5,000 nodes, 1,000 initial pods);
    the correctness gate of [scheduler]."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import default_config, run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS

    wl = dataclasses.replace(
        WORKLOADS["SchedulingPodAffinity/5000"], num_measured_pods=SERIAL_MEASURED
    )
    server = APIServer()
    zero_k(fit_kernels)
    res = run_benchmark(
        wl, sched_config=default_config(use_wave=False), device=device,
        server=server, timeout_s=600, quiet=False,
    )
    k1, k2 = count_k(fit_kernels)
    per_batch = res.kernel_total_s / res.n_batches if res.n_batches else 0.0
    log(f"[serial] SchedulingPodAffinity/5000 with {SERIAL_MEASURED} measured pods, "
        f"use_wave=False, through APIServer + "
        f"Scheduler: {res.scheduled}/{res.num_measured_pods} bound in "
        f"{res.duration_s:.3f} s = {res.throughput_pods_per_s:.1f} pods/s; "
        f"{res.n_batches} batches, serial kernel {res.kernel_total_s:.3f} s = "
        f"{per_batch:.3f} s per batch; e2e p50/p99 {res.e2e_p50_ms:.1f}/"
        f"{res.e2e_p99_ms:.1f} ms; encode {res.encode_total_s:.3f} s; K1 launches "
        f"{k1}, K2 launches {k2}; guard trips {res.guard_trips}, unwound assumes "
        f"{res.unwound_assumes}; card {card}")
    errors.check("serial")
    defense_report("serial", card, res=res)
    if res.scheduled != res.num_measured_pods or res.unscheduled:
        raise AssertionError(f"[serial] {res.unscheduled} measured pods not bound")
    if res.guard_trips or res.unwound_assumes:
        raise AssertionError(f"[serial] {res.guard_trips} guard trips")
    check_bindings(server, wl.num_measured_pods, "serial")
    return {"res": res, "k1": k1, "k2": k2, "per_batch_s": per_batch}


def phase_preempt(device, card: str, errors: ErrorLog) -> dict:
    """run_preemption_benchmark at PREEMPT_NODES full nodes (4 x 1-cpu
    priority-0 pods each), a burst of as many 2-cpu priority-100 pods.
    Fails unless every preemptor is bound, the batched pass served
    attempts, no kernel_error fallback and no guard trip."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_preemption_benchmark

    zero_k(fit_kernels)
    res = run_preemption_benchmark(PREEMPT_NODES, PREEMPT_NODES, device=device, timeout_s=600)
    k1, k2 = count_k(fit_kernels)
    log(f"[preempt] {res.num_nodes} full nodes, burst {res.burst_pods}: "
        f"scheduled {res.scheduled}, all bound in {res.time_to_all_bound_s:.3f} s; "
        f"victims evicted {res.victims_evicted}; select batches "
        f"{res.select_batches}; vector attempts {res.vector_attempts}; host-walk "
        f"fallbacks {res.host_walk_fallbacks} (by reason "
        f"{json.dumps(res.fallbacks_by_reason, sort_keys=True)}); guard trips "
        f"{res.guard_trips}; oracle divergences {res.oracle_divergences}; select "
        f"p50/p99 {res.select_p50_ms:.3f}/{res.select_p99_ms:.3f} ms; K1 launches "
        f"{k1}, K2 launches {k2}; card {card}")
    errors.check("preempt")
    defense_report("preempt", card, res=res)
    if res.scheduled != res.burst_pods:
        raise AssertionError(f"[preempt] {res.scheduled}/{res.burst_pods} bound")
    if res.vector_attempts <= 0:
        raise AssertionError("[preempt] the batched victim selection served no attempt")
    if res.fallbacks_by_reason.get("kernel_error", 0):
        raise AssertionError("[preempt] kernel_error fallbacks")
    if res.guard_trips:
        raise AssertionError(f"[preempt] {res.guard_trips} guard trips")
    return {"res": res, "k1": k1, "k2": k2}


def phase_standby(device, card: str, errors: ErrorLog) -> dict:
    """A warm standby on SchedulingPodAffinity/5000's cluster (5,000 nodes,
    its 1,000 initial pods bound): start_standby(), 500 measured pods
    queued while it stands by, promote(), every one bound. Fails unless
    the standby pre-warmed exactly once and all 500 are bound."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import default_config
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.scheduler.ha import COUNTER_STANDBY_WARMUPS
    from kubernetes_tpu_torch.utils.metrics import metrics

    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    nodes, init_pods, factory = build_workload(wl)
    server = APIServer()
    for n in nodes:
        server.create("nodes", n)
    for i, p in enumerate(init_pods):
        p.spec.node_name = nodes[(7 * i) % len(nodes)].metadata.name
        server.create("pods", p)
    metrics.reset()
    sched = Scheduler(server, default_config(), device=device)
    zero_k(fit_kernels)
    n_pods = 500
    try:
        t0 = time.perf_counter()
        sched.start_standby(identity="standby")
        warm_s = time.perf_counter() - t0
        warmups = metrics.counter(COUNTER_STANDBY_WARMUPS)
        k1_warm = fit_kernels.fit_mask.launches
        for i in range(n_pods):
            server.create("pods", factory(i))
        deadline = time.monotonic() + 60
        while len(sched.queue) < n_pods and time.monotonic() < deadline:
            time.sleep(0.01)
        queued = len(sched.queue)
        t1 = time.perf_counter()
        sched.promote()
        promote_ms = (time.perf_counter() - t1) * 1e3
        deadline = time.monotonic() + 120
        bound = 0
        while time.monotonic() < deadline:
            bound = server.count(
                "pods", lambda p: p.metadata.name.startswith("pod-") and bool(p.spec.node_name)
            )
            if bound >= n_pods:
                break
            time.sleep(0.02)
        bound_s = time.perf_counter() - t1
    finally:
        sched.stop()
    k1, k2 = count_k(fit_kernels)
    defense_report("standby", card, sched=sched)
    adopted = metrics.counter("scheduler_ha_adoptions_total", {"outcome": "pending"})
    log(f"[standby] {len(nodes)} nodes: start_standby (informer sync, snapshot, kernel "
        f"pre-warm) {warm_s:.3f} s, standby warm-ups {warmups:.0f} (K1 launches "
        f"{k1_warm}); {queued} pods queued while standing by; promote "
        f"{promote_ms:.1f} ms (adopted {adopted:.0f} pending); {bound}/{n_pods} "
        f"bound {bound_s:.3f} s after the promotion; K1 launches {k1}, K2 "
        f"launches {k2}; card {card}")
    errors.check("standby")
    if warmups != 1:
        raise AssertionError(f"[standby] {warmups} standby warm-ups, want 1")
    if bound != n_pods:
        raise AssertionError(f"[standby] {bound}/{n_pods} bound")
    check_bindings(server, n_pods, "standby")
    return {"k1": k1, "k2": k2, "warm_s": warm_s, "promote_ms": promote_ms}


HA_WORKLOAD = "SchedulingPodAffinity/5000"
HA_FIRST = 1000  # measured pods the first leader binds
HA_WAVE = 4096  # measured pods of the wave the leader dies holding: one full batch
HA_BURST = 500  # measured pods racing the new leader and the zombie
HA_LEASE = dict(lease_duration=1.5, renew_deadline=1.0, retry_period=0.2)
AUTOSCALER_PERIOD_S = 5.0  # tests/test_chaos_ha.py: the first bind after a kill within it
HA_FENCED = "rejected by the leadership fence"  # the zombie's own ERROR record


def ha_store():
    """An APIServer with a bind ledger (the binds it applies, per pod uid)
    and a one-shot bind refusal, the mechanism of tests/test_chaos_pipeline.py's
    ChaosStore.fail_next_bind: once armed, the next bind_pods raises
    DegradedWrites before applying anything, and every bind is refused so
    until recover(). Only binds: pod creates keep landing, so that a
    4,096-pod wave reaches the leader whole while its binds park."""
    from collections import defaultdict

    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.runtime.consensus import DegradedWrites

    class HAStore(APIServer):
        def __init__(self):
            super().__init__()
            self.applied = defaultdict(int)
            self.fail_next_bind = False
            self.binds_degraded = False
            self._chaos_lock = threading.Lock()

        def recover(self):
            self.binds_degraded = False

        def bind_pods(self, bindings, fence=None):
            with self._chaos_lock:
                if self.fail_next_bind:
                    self.fail_next_bind, self.binds_degraded = False, True
                refused = self.binds_degraded
            if refused:
                raise DegradedWrites("bind refused: store degraded")
            errs = super().bind_pods(bindings, fence=fence)
            for b, err in zip(bindings, errs):
                if err is None:
                    self.applied[b.pod_uid] += 1
            return errs

    return HAStore()


class HAReplica:
    """One scheduler replica wired as tests/test_chaos_ha.py's _Replica and
    cmd/scheduler.py wire it: a Scheduler on the card standing by over the
    shared Cacher, a LeaderElector on the raw store with the reference's
    fast lease, and the election winner promoting with the elector's
    fence. Counts its own K1 launches (each wave launch's K1 delta, taken
    under one lock shared by the replicas) and its full snapshot uploads
    after its bring-up."""

    launch_lock = threading.Lock()

    def __init__(self, store, cacher, identity: str, device):
        from kubernetes_tpu_torch.client.leaderelection import (
            LeaderElectionConfig, LeaderElector)
        from kubernetes_tpu_torch.ops import fit_kernels
        from kubernetes_tpu_torch.perf.harness import default_config
        from kubernetes_tpu_torch.scheduler import Scheduler
        from kubernetes_tpu_torch.scheduler.ha import COUNTER_STANDBY_WARMUPS
        from kubernetes_tpu_torch.utils.metrics import metrics

        self.identity = identity
        self.k1 = 0
        self.uploads = 0
        self.sched = Scheduler(cacher, default_config(), device=device)
        launch, enc = self.sched._launch_wave_kernel, self.sched.cache.encoder
        upload = enc._upload

        def counted_launch(*a):
            with HAReplica.launch_lock:
                k0 = fit_kernels.fit_mask.launches
                try:
                    return launch(*a)
                finally:
                    self.k1 += fit_kernels.fit_mask.launches - k0

        def counted_upload(masters):
            self.uploads += 1
            return upload(masters)

        self.sched._launch_wave_kernel = counted_launch
        enc._upload = counted_upload
        w0 = metrics.counter(COUNTER_STANDBY_WARMUPS)
        t0 = time.perf_counter()
        self.sched.start_standby(identity=identity)
        self.warm_s = time.perf_counter() - t0
        self.warmups = metrics.counter(COUNTER_STANDBY_WARMUPS) - w0
        self.uploads_standing = self.uploads
        self.promoted = threading.Event()
        self.promoted_at = None

        def on_started():
            self.sched.promote(fence=self.elector.fence())
            self.promoted_at = time.monotonic()
            self.promoted.set()

        self.elector = LeaderElector(
            store, LeaderElectionConfig(identity=identity, **HA_LEASE),
            on_started_leading=on_started,
        )
        self.thread = threading.Thread(
            target=self.elector.run, daemon=True, name=f"elector-{identity}")
        self.thread.start()

    def stop(self) -> None:
        self.elector.stop()
        self.sched.stop()
        self.thread.join(timeout=10.0)


def wait_for(cond, timeout: float, what: str, period: float = 0.005,
             phase: str = "ha", clock=time.monotonic, report=None) -> float:
    """Poll cond until it holds; returns the time it first held (on
    `clock`); fails the run past `timeout` seconds, after calling `report`
    (when given) to print the state it was waiting on."""
    deadline = time.monotonic() + timeout
    while True:
        if cond():
            return clock()
        if time.monotonic() > deadline:
            if report is not None:
                report()
            raise AssertionError(f"[{phase}] timed out after {timeout} s waiting for {what}")
        time.sleep(period)


def phase_ha(device, card: str, errors: ErrorLog, workload: str = HA_WORKLOAD,
             first: int = HA_FIRST, wave: int = HA_WAVE, burst: int = HA_BURST) -> dict:
    """The Scheduler's leader-elected failover, as tests/test_chaos_ha.py
    runs it, on `workload`'s cluster (nodes and initial pods bound, as
    [standby] builds it) in a bind-ledger store (ha_store) behind one
    shared Cacher. Replica A leads and binds `first` measured pods; the
    bind refusal is armed and `wave` more pods created; once A's
    ride-through buffer holds parked binds, A dies (elector.crash(),
    Scheduler stopped), the store recovers, and standby B takes the
    lease, adopts the in-flight pods from the store and binds them. Then
    replica C stands by and B's elector is paused with B's Scheduler
    running: once C leads, B's fenced bind of a pod no profile owns must
    raise LeaderFenced and leave it unbound, and a racing burst of
    `burst` pods must bind once each. Fails unless B promoted, adoptions
    {pending} rose, the first bind after the kill came within one
    autoscaler period (5.0 s), every measured pod was bound exactly once
    on the ledger, check_bindings passes, each replica pre-warmed once and
    re-uploaded no snapshot after its bring-up, K1 launched by B's
    adopted waves (on the card), and 0 guard trips, drift rows, rebuilds
    and device-down."""
    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.apiserver.cacher import Cacher
    from kubernetes_tpu_torch.client.apiserver import LeaderFenced
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler.ha import COUNTER_ADOPTIONS, COUNTER_FENCED_BINDS
    from kubernetes_tpu_torch.utils.metrics import metrics

    nodes, init_pods, factory = build_workload(WORKLOADS[workload])
    store = ha_store()
    for n in nodes:
        store.create("nodes", n)
    for i, p in enumerate(init_pods):
        p.spec.node_name = nodes[(7 * i) % len(nodes)].metadata.name
        store.create("pods", p)
    cacher = Cacher(store)
    metrics.reset()
    zero_k(fit_kernels)
    measured = 0

    def create(n: int) -> None:
        nonlocal measured
        for i in range(measured, measured + n):
            store.create("pods", factory(i))
        measured += n

    def applied() -> int:
        return sum(store.applied.values())

    def adoptions() -> dict:
        return {o: metrics.counter(COUNTER_ADOPTIONS, {"outcome": o})
                for o in ("bound", "pending", "gone")}

    def measured_bound() -> int:
        return store.count(
            "pods", lambda p: p.metadata.name.startswith("pod-") and bool(p.spec.node_name))

    replicas = []
    try:
        a = HAReplica(store, cacher, "ha-a", device)
        replicas.append(a)
        wait_for(a.promoted.is_set, 30, "replica A to lead")
        b = HAReplica(store, cacher, "ha-b", device)
        replicas.append(b)
        create(first)
        wait_for(lambda: measured_bound() == first, 120, f"A to bind {first} pods")
        # mid-wave: the next bind is refused (degraded store), so A parks
        # the wave assumed-but-unbound, then dies before it can drain
        store.fail_next_bind = True
        create(wave)
        wait_for(lambda: a.sched._ridethrough.depth > 0, 60, "A to park the wave")
        depth = a.sched._ridethrough.depth
        bound_at_kill, applied_at_kill = measured_bound(), applied()
        adopt0, k1_at_kill = adoptions(), b.k1
        t_kill = time.monotonic()
        a.elector.crash()
        a.sched.stop()
        store.recover()
        wait_for(b.promoted.is_set, 30, "B to promote")
        t_first = wait_for(lambda: applied() > applied_at_kill, 30, "a bind after the kill")
        t_all = wait_for(lambda: measured_bound() == first + wave, 120,
                         "B to bind every measured pod")
        adopted = {k: v - adopt0[k] for k, v in adoptions().items()}
        k1_after_kill = b.k1 - k1_at_kill

        # the zombie: C stands by, B's elector pauses while B's Scheduler runs
        c = HAReplica(store, cacher, "ha-c", device)
        replicas.append(c)
        b.elector.crash()
        wait_for(c.promoted.is_set, 30, "C to take the lease")
        zp = store.create("pods", v1.Pod(
            metadata=v1.ObjectMeta(name="zombie-target"),
            spec=v1.PodSpec(scheduler_name="nobody",
                            containers=[v1.Container(requests={"cpu": "100m"})])))
        binding = v1.Binding(pod_name="zombie-target", pod_namespace="default",
                             pod_uid=zp.metadata.uid, target_node=nodes[0].metadata.name)
        try:
            b.sched._bind_pods_fenced([binding])
            raise AssertionError("[ha] the zombie's bind was not fenced")
        except LeaderFenced:
            pass
        if store.get("pods", "default", "zombie-target").spec.node_name:
            raise AssertionError("[ha] a fenced bind reached the store")
        store.delete("pods", "default", "zombie-target")
        t_burst = time.monotonic()
        create(burst)
        t_race = wait_for(lambda: measured_bound() == first + wave + burst, 120,
                          "the racing burst to bind")
        fenced = {labels.get("path", ""): v for _n, labels, v in
                  metrics.snapshot_counters(COUNTER_FENCED_BINDS)}
        lease = store.get("leases", "kube-system", "kube-scheduler")
    finally:
        for r in replicas:
            r.stop()
        cacher.stop()
    k1, k2 = count_k(fit_kernels)
    fenced_records = errors.expect("ha", (HA_FENCED,))
    trips = sum(v for _n, _l, v in metrics.snapshot_counters("kernel_guard_trips_total"))
    d = defense_report("ha", card, sched=b.sched)
    down = [r.identity for r in replicas if r.sched._device_down]
    uids = {p.metadata.uid for p in store.list("pods")[0] if p.metadata.name.startswith("pod-")}
    twice = {u: n for u, n in store.applied.items() if n != 1}
    per = {r.identity: r.k1 for r in replicas}
    log(f"[ha] {workload}'s cluster ({len(nodes)} nodes, {len(init_pods)} initial pods) "
        f"behind one Cacher; A bound {first}, then died holding {depth} parked binds of "
        f"a {wave}-pod wave ({bound_at_kill} measured bound at the kill); kill -> B promoted "
        f"{(b.promoted_at - t_kill) * 1e3:.1f} ms, -> first bind "
        f"{(t_first - t_kill) * 1e3:.1f} ms, -> all {first + wave} bound "
        f"{t_all - t_kill:.3f} s; adoptions {json.dumps(adopted, sort_keys=True)}; "
        f"zombie B fenced (LeaderFenced on its direct bind), C led after "
        f"{(c.promoted_at - t_kill):.3f} s since the kill; the {burst}-pod race bound in "
        f"{t_race - t_burst:.3f} s; fenced binds by path {json.dumps(fenced, sort_keys=True)} "
        f"({fenced_records} fence ERROR records); lease held by {lease.holder_identity} at "
        f"transition {lease.lease_transitions}; K1 launches per replica "
        f"{json.dumps(per, sort_keys=True)} ({k1} in all, "
        f"B's adopted waves {k1_after_kill}), K2 {k2}; warm-ups {[r.warmups for r in replicas]}, start_standby "
        f"{[round(r.warm_s, 3) for r in replicas]} s, full uploads after bring-up "
        f"{[r.uploads - r.uploads_standing for r in replicas]}; guard trips {trips:.0f}; "
        f"card {card}")
    if not b.promoted.is_set() or adopted["pending"] <= 0:
        raise AssertionError(f"[ha] B promoted {b.promoted.is_set()}, adoptions {adopted}")
    if t_first - t_kill >= AUTOSCALER_PERIOD_S:
        raise AssertionError(f"[ha] first bind {t_first - t_kill:.3f} s after the kill")
    if len(uids) != first + wave + burst or set(store.applied) != uids or twice:
        raise AssertionError(
            f"[ha] {len(uids)} measured pods, {len(store.applied)} on the ledger, "
            f"{len(twice)} not bound exactly once")
    check_bindings(store, first + wave + burst, "ha")
    if any(r.warmups != 1 for r in replicas) or any(r.uploads != r.uploads_standing
                                                      for r in replicas):
        raise AssertionError("[ha] a replica pre-warmed other than once or re-uploaded "
                             "its snapshot after its bring-up")
    if k1_after_kill <= 0 and device.type == "cuda":
        raise AssertionError("[ha] B's promoted waves never launched K1")
    if trips or down or d["drift_rows"] or d["rebuilds"]:
        raise AssertionError(f"[ha] guard trips {trips}, device down {down}")
    return {"k1": k1, "k2": k2, "depth": depth, "adopted": adopted,
            "promote_ms": (b.promoted_at - t_kill) * 1e3,
            "first_bind_ms": (t_first - t_kill) * 1e3, "all_bound_s": t_all - t_kill,
            "per_replica": per, "fenced": fenced}


# [nodeloss]: a zone's kubelets die at SchedulingBasic/5000's size
NODELOSS_WORKLOAD = "SchedulingBasic/5000"  # its 5,000 nodes in 10 zones and its pod template
NODELOSS_SETS = 10  # ReplicaSets, rs-0 .. rs-9, each of NODELOSS_REPLICAS pods
NODELOSS_REPLICAS = 500
NODELOSS_ZONE = "zone-3"  # whose 500 kubelets stop at once
# zones whose nodes are lease-managed (a kubelet and a node lease each):
# zone-0 .. zone-4, 2,500 of the 5,000 nodes; the other 2,500 are static
# nodes with no lease. Cut from all 10 zones: at 5,000 lease-managed nodes
# one interpreter's heartbeat and lifecycle passes reach 24 s, past the
# 10 s grace, and the partial-disruption halt trips (PERF.md section 4,
# ROADMAP queue 3)
NODELOSS_MANAGED_ZONES = 5
NODELOSS_REVIVE = 100  # of its nodes whose kubelets restart once every replacement is bound
NODELOSS_HEARTBEAT_S = 1.0  # the kubelets' shared heartbeat loop's interval
# the grace period raised from 4.0 s: the heartbeat pass over 2,500 kubelets
# reaches 5 s, and a lease then ages past 4 s between two renewals
NODELOSS_LIFECYCLE = dict(node_monitor_period=0.5, node_monitor_grace_period=10.0,
                          pod_eviction_timeout=1.0, eviction_limiter_qps=100.0)
NODELOSS_TOLERATION_S = 3  # rs-1's tolerationSeconds on the unreachable taint
# events a kind the store keeps for watch resumption (the reference's
# default 200,000 holds 40 s of 5,000 kubelets' lease renewals, each a deep
# copy that every full collection walks)
NODELOSS_WATCH_HISTORY = 20_000
LIFECYCLE_TAINTS = ("node.kubernetes.io/unreachable", "node.kubernetes.io/not-ready")


class NodeLossWatch:
    """Two store watches from the current resource version on, each drained
    by a thread of its own, so that the phase polls no list of the store
    (a list deep-copies every object under the store's one lock, which the
    5,000 kubelets' lease renewals take one at a time). Nodes: each node's
    taint keys as the last event left them, the first time each carried
    both lifecycle taints, the first time after that it carried none, and
    every node outside `killed` that was ever tainted. Pods: each live
    pod's (name, node, owner) by uid, and every deletion (time, name, uid,
    node, owner). Times are time.time(), the lifecycle controller's
    clock."""

    def __init__(self, store, killed: set):
        self.store = store
        self.killed = killed
        self.taints = {}
        self.tainted_at = {}
        self.untainted_at = {}
        self.stray = set()
        self.pods = {}
        self.deleted = []
        self.rv = {}
        self._stop = threading.Event()
        self._threads = []
        for kind, handle in (("nodes", self._node), ("pods", self._pod)):
            self.rv[kind] = store.kind_resource_version(kind)
            w = store.watch(kind, from_version=self.rv[kind])
            t = threading.Thread(target=self._drain, args=(kind, w, handle), daemon=True,
                                 name=f"nodeloss-watch-{kind}")
            t.start()
            self._threads.append((t, w))

    def _drain(self, kind, w, handle) -> None:
        while not self._stop.is_set():
            ev = w.get(timeout=0.1)
            if ev is None:
                continue
            handle(ev)
            self.rv[kind] = ev.resource_version

    def _node(self, ev) -> None:
        name, now = ev.object.metadata.name, time.time()
        keys = frozenset(t.key for t in ev.object.spec.taints) if ev.type != "DELETED" else frozenset()
        self.taints[name] = keys
        if keys and name not in self.killed:
            self.stray.add(name)
        if keys >= set(LIFECYCLE_TAINTS):
            self.tainted_at.setdefault(name, now)
        elif not keys and name in self.tainted_at:
            self.untainted_at.setdefault(name, now)

    def _pod(self, ev) -> None:
        p = ev.object
        owner = next((r.name for r in p.metadata.owner_references), None)
        if ev.type == "DELETED" or p.metadata.deletion_timestamp is not None:
            if self.pods.pop(p.metadata.uid, None) is not None:
                self.deleted.append((time.time(), p.metadata.name, p.metadata.uid,
                                     p.spec.node_name, owner))
        else:
            self.pods[p.metadata.uid] = (p.metadata.name, p.spec.node_name, owner)

    def tainted_now(self) -> set:
        return {n for n, keys in list(self.taints.items()) if keys}

    def caught_up(self) -> bool:
        return all(self.rv.get(k, 0) >= self.store.kind_resource_version(k)
                   for k in ("nodes", "pods"))

    def stop(self) -> None:
        self._stop.set()
        for t, w in self._threads:
            t.join(timeout=5.0)
            w.stop()


def thread_cpu() -> dict:
    """CPU seconds each live Python thread of this process has used
    (/proc/self/task/<tid>/stat, user + system), by thread name."""
    import os

    hz = os.sysconf("SC_CLK_TCK")
    out = {}
    for t in threading.enumerate():
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, TypeError):
            continue
        out[t.name] = out.get(t.name, 0.0) + (int(fields[11]) + int(fields[12])) / hz
    return out


class HeartbeatPasses:
    """The pool's heartbeat pass times: one pass gives every kubelet's
    heartbeat(now) the same `now` (the pass's start, time.time()) and ends
    when the last of them returns."""

    def __init__(self):
        self.end = {}

    def wrap(self, kubelet):
        beat = kubelet.heartbeat

        def timed(now=None):
            beat(now)
            self.end[now] = time.time()

        kubelet.heartbeat = timed
        return kubelet

    def passes(self) -> list:
        return [e - n for n, e in sorted(self.end.items()) if n is not None]

    def timeline(self, t0: float) -> list:
        """(start - t0, duration) of each pass, in seconds."""
        return [(round(n - t0, 1), round(e - n, 2))
                for n, e in sorted(self.end.items()) if n is not None]


def nodeloss_replicaset(k: int, replicas: int, template):
    """ReplicaSet rs-k of `template`'s pod spec, in a namespace of its own
    (nodeloss-k): rs-0 tolerates every taint (key "" and Exists: the
    DaemonSet form), rs-1 the unreachable taint for NODELOSS_TOLERATION_S
    seconds, the rest nothing."""
    import copy

    from kubernetes_tpu_torch.api import objects as v1

    spec = copy.deepcopy(template.spec)
    spec.tolerations = {
        0: [v1.Toleration(key="", operator=v1.TOLERATION_OP_EXISTS)],
        1: [v1.Toleration(key=LIFECYCLE_TAINTS[0], operator=v1.TOLERATION_OP_EXISTS,
                          effect=v1.TAINT_NO_EXECUTE, toleration_seconds=NODELOSS_TOLERATION_S)],
    }.get(k, [])
    name = f"rs-{k}"
    return v1.ReplicaSet(
        metadata=v1.ObjectMeta(name=name, namespace=f"nodeloss-{k}"),
        spec=v1.ReplicaSetSpec(
            replicas=replicas, selector={"rs": name},
            template=v1.PodTemplateSpec(metadata=v1.ObjectMeta(labels={"rs": name}), spec=spec),
        ),
    )


def tainted_rows_match(sched, store, names, what: str) -> int:
    """The taint columns of `names`' rows on the card (the live snapshot,
    flushed, gathered by SnapshotEncoder.fetch_device_rows) equal the host
    encoding of the API server's node objects and the encoder's masters,
    once the Scheduler's node informer has every node event. Returns the
    rows checked."""
    inf = sched.informer_factory.informer("nodes")
    target = store.kind_resource_version("nodes")
    wait_for(lambda: inf.last_resource_version >= target, 30,
             "the Scheduler's node informer", period=0.01, phase="nodeloss")
    enc = sched.cache.encoder
    with sched.cache.lock:
        enc.flush()
        rows = [enc.row_of(n) for n in names]
        host = [enc.encode_node_row_values(store.get("nodes", "", n)) for n in names]
        masters = {f: enc._master_of(f)[rows].copy()
                   for f in ("taint_key", "taint_val", "taint_effect")}
    dev = enc.fetch_device_rows(rows)
    for f in ("taint_key", "taint_val", "taint_effect"):
        want = np.stack([h[f] for h in host])
        differ = (dev[f] != want).any(axis=1) | (masters[f] != want).any(axis=1)
        if differ.any():
            i = int(np.argmax(differ))
            raise AssertionError(
                f"[nodeloss] {what}: {f} of {names[i]} is {dev[f][i].tolist()} on the card, "
                f"{masters[f][i].tolist()} in the masters, {want[i].tolist()} encoded")
    return len(rows)


def phase_nodeloss(device, card: str, errors: ErrorLog, seed: int = 0,
                   workload: str = NODELOSS_WORKLOAD, replicas: int = NODELOSS_REPLICAS,
                   revive: int = NODELOSS_REVIVE) -> dict:
    """[nodeloss]: node loss as tests/test_chaos_pipeline.py's kubelet cases
    run it, at `workload`'s nodes: those of the first
    NODELOSS_MANAGED_ZONES zones lease-managed (a kubelet each in one
    NodeAgentPool, heartbeat NODELOSS_HEARTBEAT_S, and a node lease), the
    rest static; a bind-ledger store (ledger_server) keeping
    NODELOSS_WATCH_HISTORY events a kind; the Scheduler on `device` with
    the reference's settings; the replicaset controller's reconcile (its
    workers, fed by its ReplicaSets' writes and a resync every
    resync_period: the copied controller's watch loop takes one pod event
    a turn) and NODELOSS_SETS ReplicaSets of `replicas` pods each, each in
    a namespace of its own. Once all are bound, the node-lifecycle
    controller starts (NODELOSS_LIFECYCLE); at one instant the kubelets of
    NODELOSS_ZONE stop and an 11th ReplicaSet of `replicas` is created,
    whose waves run while the taints land. Once every replacement is
    bound, `revive` of the dead nodes' kubelets restart; once their taints
    are lifted, the 11th ReplicaSet grows by `replicas`.
    Fails unless every killed node carries both lifecycle taints in the API
    server and in its rows on the card (equal to the host encoding), no
    other node was ever tainted, the partial-disruption gauge stayed 0,
    every rs-1..rs-9 pod on a killed node was evicted (rs-1's no sooner
    than its tolerationSeconds after its node went NotReady) and every
    rs-0 pod stayed, node_lifecycle_evictions_total rose by the pods
    deleted from killed nodes, every ReplicaSet is back at its replicas,
    all bound, none on a node whose NoSchedule or NoExecute taint it does
    not tolerate, check_capacity passes, every bind applied once on the
    ledger, the revived rows read untainted on the card and at least one
    of the last `replicas` pods bound to a revived node, K1 launched after
    the kill (on the card), one replacement batch on the tainted snapshot
    held card against CPU (hold_batch: equal but for near-ties, no pod on
    a taint it does not tolerate), 0 guard trips, drift rows, rebuilds
    and device-down, an auditor pass, and no ERROR."""
    import copy
    from collections import Counter

    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.client.leaderelection import Lease
    from kubernetes_tpu_torch.controller import nodelifecycle
    from kubernetes_tpu_torch.controller.replicaset import ReplicaSetController
    from kubernetes_tpu_torch.kubelet.kubelet import NODE_LEASE_NS, NodeAgentPool
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.ops.lattice import weights_for_policy
    from kubernetes_tpu_torch.ops.templates import TemplateCache
    from kubernetes_tpu_torch.perf.harness import default_config, defense_counts
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.scheduler.wavepath import WavePathConfig
    from kubernetes_tpu_torch.utils.metrics import metrics

    errors.check("before nodeloss")
    sets, zone, lifecycle = NODELOSS_SETS, NODELOSS_ZONE, NODELOSS_LIFECYCLE
    nodes, _init, factory = build_workload(WORKLOADS[workload])
    template = factory(0)
    store = ledger_server(watch_history=NODELOSS_WATCH_HISTORY)
    t0 = time.perf_counter()
    now = time.time()
    zones = sorted({n.metadata.labels[ZONE] for n in nodes}, key=lambda z: int(z.split("-")[1]))
    managed_set = set(zones[:NODELOSS_MANAGED_ZONES])
    managed = [n for n in nodes if n.metadata.labels[ZONE] in managed_set]
    for n in nodes:
        store.create("nodes", n)
    for n in managed:
        store.create("leases", Lease(
            metadata=v1.ObjectMeta(name=n.metadata.name, namespace=NODE_LEASE_NS),
            holder_identity=n.metadata.name, lease_duration_seconds=40.0, renew_time=now))
    beats = HeartbeatPasses()
    pool = NodeAgentPool(store, heartbeat_interval=NODELOSS_HEARTBEAT_S)
    for n in managed:
        beats.wrap(pool.add_node(n.metadata.name, register=False))
    killed = [n.metadata.name for n in nodes if n.metadata.labels[ZONE] == zone]
    killed_set, revived = set(killed), killed[:revive]
    metrics.reset()
    zero_k(fit_kernels)
    # the replicaset controller's reconcile (its workers and _sync) runs
    # off its ReplicaSets' creates and updates and a resync every
    # resync_period: the copied controller's own watch loop takes one pod
    # event a turn and re-syncs a ReplicaSet for each, ~15,000 of them
    # behind 5,000 pods' creates, binds and status writes, and each of
    # the ~500 evictions, each sync a deep-copying list under the store's
    # lock (ROADMAP queue 3)
    rs = ReplicaSetController(store)
    watch = NodeLossWatch(store, killed_set)
    sched = Scheduler(store, default_config(), device=device)
    nlc = nodelifecycle.NodeLifecycleController(store, **lifecycle)
    monitor, evict, set_ready = nlc._monitor_once, nlc._evict_pods, nlc._set_ready
    passes, since, partial, evicted_at, tainted_at = [], {}, [], {}, {}
    lifecycle_timeline = []

    def timed_monitor():
        t, start = time.perf_counter(), time.time()
        monitor()
        passes.append(time.perf_counter() - t)
        for name, at in list(nlc._not_ready_since.items()):
            since.setdefault(name, at)
        partial.append(metrics.gauge(nodelifecycle.GAUGE_PARTIAL_DISRUPTION))
        lifecycle_timeline.append((start, passes[-1], metrics.gauge(
            nodelifecycle.GAUGE_UNHEALTHY_FRACTION), partial[-1]))

    def timed_evict(node_name, pods):
        pods = list(pods)
        at = time.time()
        for p in pods:
            evicted_at.setdefault(p.metadata.uid, (at, node_name))
        return evict(node_name, pods)

    def timed_set_ready(name, ready):
        set_ready(name, ready)
        if not ready:
            tainted_at.setdefault(name, time.time())

    nlc._monitor_once, nlc._evict_pods, nlc._set_ready = timed_monitor, timed_evict, timed_set_ready

    def owner(p):
        return next((r.name for r in p.metadata.owner_references), None)

    t_ref = [time.time(), "the start", time.time()]
    collections = FullCollections("nodeloss")

    def timelines() -> str:
        """Each lifecycle pass (start, s; unhealthy fraction; partial
        disruption) and heartbeat pass (start, s), from the kill (or
        the start)."""
        life = [(round(a - t_ref[2], 1), round(d, 2), round(f or 0.0, 3), p)
                for a, d, f, p in lifecycle_timeline]
        return (f"lifecycle passes (start s, s, unhealthy, partial) {life}; heartbeat passes "
                f"(start s, s) {beats.timeline(t_ref[2])}")

    def busiest() -> str:
        cpu = sorted(thread_cpu().items(), key=lambda kv: -kv[1])[:10]
        return json.dumps({k: round(v, 1) for k, v in cpu})

    def state():
        beat = beats.passes()
        log(f"[nodeloss] at {time.time() - t_ref[0]:.1f} s after {t_ref[1]}: "
            f"{len(watch.tainted_at)} nodes tainted, others tainted {sorted(watch.stray)[:5]}; "
            f"{len(evicted_at)} pods evicted, {len(watch.deleted)} deleted; partial disruption "
            f"max {max(partial, default=0.0)}, unhealthy fraction "
            f"{metrics.gauge(nodelifecycle.GAUGE_UNHEALTHY_FRACTION) or 0.0:.3f}; {len(passes)} "
            f"lifecycle passes, the last {[round(x, 3) for x in passes[-5:]]} s; {len(beat)} "
            f"heartbeat passes, the last {[round(x, 3) for x in beat[-5:]]} s; "
            f"{collections.summary()}")

    def wait(cond, timeout, what, clock=time.time, period=0.05):
        def report():
            state()
            log(f"[nodeloss] {timelines()}")
            log(f"[nodeloss] thread CPU s {busiest()}")
            per = Counter(o for _n, _node, o in list(watch.pods.values()))
            log(f"[nodeloss] pods by ReplicaSet {dict(sorted(per.items()))}, unbound "
                f"{sum(1 for _n, node, _o in list(watch.pods.values()) if not node)}; "
                f"wanted {want}")

        return wait_for(cond, timeout, what, period=period, phase="nodeloss", clock=clock,
                        report=report)

    want = {f"rs-{k}": replicas for k in range(sets)}

    def live():
        return [p for p in store.list("pods")[0] if p.metadata.deletion_timestamp is None]

    def converged() -> bool:
        """From the phase's watch (no store list): every ReplicaSet at its
        replicas, every pod bound, none but rs-0's on a tainted node."""
        pods = list(watch.pods.values())
        tainted = watch.tainted_now()
        return (Counter(o for _n, _node, o in pods) == Counter(want)
                and all(node for _n, node, _o in pods)
                and not any(node in tainted and o != "rs-0" for _n, node, o in pods))

    rs_keys = []
    stop = threading.Event()

    def resync():
        """The informer resync of the controller's resync_period: every
        ReplicaSet re-queued, which replaces the evicted pods (and a pod
        whose name, 5 hex digits, collided on create)."""
        while not stop.wait(rs.resync):
            for key in list(rs_keys):
                rs.queue.add(key)

    def create_set(k: int, n: int) -> None:
        obj = store.create("replicasets", nodeloss_replicaset(k, n, template))
        rs_keys.append(obj.metadata.key)
        rs.queue.add(obj.metadata.key)
        want[f"rs-{k}"] = n

    pool.start()
    sched.start()
    for i in range(rs.workers):
        threading.Thread(target=rs._worker, daemon=True, name=f"rs-worker-{i}").start()
    threading.Thread(target=resync, daemon=True, name="rs-resync").start()
    counts = RunCounts()
    try:
        for k in range(sets):
            create_set(k, replicas)
        t_setup = wait(converged, 180, f"{sets * replicas} pods bound",
                       clock=time.perf_counter, period=0.25)
        setup_s = t_setup - t0
        nlc.start()
        wait(lambda: len(passes) >= 3, 30, "three lifecycle passes before the kill")
        wait(watch.caught_up, 30, "the phase's watches", period=0.01)
        before = dict(watch.pods)
        on_killed = {u: v for u, v in before.items() if v[1] in killed_set}
        doomed = {u for u, v in on_killed.items() if v[2] != "rs-0"}
        ev0 = metrics.counter(nodelifecycle.COUNTER_EVICTIONS)
        de0 = metrics.counter(nodelifecycle.COUNTER_EVICTIONS_DEFERRED)
        n_pass0 = len(passes)
        k1_setup = fit_kernels.fit_mask.launches
        zero_k(fit_kernels)
        counts.__enter__()
        t_kill = time.time()
        t_ref[:] = [t_kill, "the kill", t_kill]
        for name in killed:
            pool.remove_node(name)
        create_set(sets, replicas)
        wait(lambda: killed_set <= set(tainted_at), 60, f"all {len(killed)} killed nodes tainted")
        t_tainted = max(tainted_at[n] for n in killed)
        wait(lambda: doomed <= set(evicted_at), 60, f"the {len(doomed)} evictions")
        t_bound = wait(converged, 120, "every replacement bound", period=0.25)
        wait(watch.caught_up, 30, "the phase's watches", period=0.01)
        evictions = metrics.counter(nodelifecycle.COUNTER_EVICTIONS) - ev0
        deferred = metrics.counter(nodelifecycle.COUNTER_EVICTIONS_DEFERRED) - de0
        from_killed = [d for d in watch.deleted if d[0] >= t_kill and d[3] in killed_set]
        k1_tainted = fit_kernels.fit_mask.launches
        batches_kill = len(counts.batches)
        nodes_now = {n.metadata.name: n for n in store.list("nodes")[0]}
        missing = [n for n in killed
                   if not set(LIFECYCLE_TAINTS) <= {t.key for t in nodes_now[n].spec.taints}]
        rows_tainted = tainted_rows_match(sched, store, killed, "the killed nodes")
        # the tainted snapshot, encoded afresh on the card from the API
        # server's nodes and bound pods, for the held batch once the
        # phase's threads have stopped (its CPU run takes every core)
        tainted = SnapshotEncoder(EncodingConfig.for_cluster(len(nodes)), device=device)
        for n in nodes_now.values():
            tainted.add_node(n)
        for p in live():
            tainted.add_pod(p.spec.node_name, p)
        tainted.flush()

        # the revival
        t_revive = time.time()
        for name in revived:
            beats.wrap(pool.add_node(name, register=False))
        t_ref[:] = [t_revive, "the revival", t_kill]
        t_untainted = wait(lambda: set(revived) <= set(watch.untainted_at), 60,
                           f"the {len(revived)} revived nodes untainted")
        tainted_rows_match(sched, store, revived, "the revived nodes")
        enc = sched.cache.encoder
        if (enc.fetch_device_rows([enc.row_of(n) for n in revived])["taint_key"] != -1).any():
            raise AssertionError("[nodeloss] a revived node's row is still tainted on the card")
        grown = {u for u, (_n, _node, o) in list(watch.pods.items()) if o == f"rs-{sets}"}

        def grow(cur):
            cur.spec.replicas = 2 * replicas
            return cur

        store.guaranteed_update("replicasets", f"nodeloss-{sets}", f"rs-{sets}", grow)
        rs.queue.add(f"nodeloss-{sets}/rs-{sets}")
        want[f"rs-{sets}"] = 2 * replicas
        t_grown = wait(converged, 120, f"rs-{sets} grown by {replicas}", period=0.25)
        pods_end = live()
        last = [p for p in pods_end if owner(p) == f"rs-{sets}" and p.metadata.uid not in grown]
        on_revived = sum(1 for p in last if p.spec.node_name in set(revived))
        wait(watch.caught_up, 30, "the phase's watches", period=0.01)
        # the auditor (period 5 s) skips while waves are in flight: one
        # clean pass on the settled snapshot
        wait(lambda: defense_counts()["audit_passes"] >= 1, 30, "an auditor pass", period=0.1)
        stray = sorted(watch.stray)
        cpu_by_thread = busiest()
        beat_passes = beats.passes()
        batches = list(counts.batches)
    finally:
        stop.set()
        counts.__exit__()
        collections.close()
        nlc.stop()
        rs.stop()
        sched.stop()
        pool.stop()
        watch.stop()
    k1, k2 = count_k(fit_kernels)

    # one replacement batch on the tainted snapshot, card against CPU
    sets_held = [nodeloss_replicaset(k, 1, template).spec.template for k in range(sets)]

    def replacement(i):
        t = sets_held[i % sets]
        return v1.Pod(metadata=v1.ObjectMeta(name=f"held-{i}", labels=dict(t.metadata.labels)),
                      spec=copy.deepcopy(t.spec))

    mp = {"enc": tainted, "cache": TemplateCache(tainted), "cfg": WavePathConfig(),
          "weights": torch.tensor(weights_for_policy("default"), device=device),
          "rng": torch.Generator(device=device).manual_seed(seed), "factory": replacement}
    held = hold_batch(mp, device, "nodeloss")
    chosen = held["res"].chosen.cpu().numpy()
    placed = held["res"].placed.cpu().numpy()
    killed_rows = {tainted.row_of(n) for n in killed}
    on_taint = [p.metadata.name for i, p in enumerate(held["batch"])
                if placed[i] and int(chosen[i]) in killed_rows and not p.spec.tolerations]
    held_ties, held_cpu_s = held["ties"], held["cpu_s"]
    del mp, held, tainted
    errors.check("nodeloss")
    trips = sum(v for _n, _l, v in metrics.snapshot_counters("kernel_guard_trips_total"))
    d = defense_report("nodeloss", card, sched=sched)
    rs1 = [(evicted_at[u][0] - since[v[1]], evicted_at[u][0] - tainted_at[v[1]])
           for u, v in on_killed.items() if v[2] == "rs-1" and u in evicted_at]
    stayed = [u for u, v in on_killed.items() if v[2] == "rs-0"
              and any(p.metadata.uid == u and p.spec.node_name == v[1] for p in pods_end)]
    evict_times = sorted(at for at, _n in evicted_at.values())
    landed = sum(1 for d_ in from_killed if d_[4] == f"rs-{sets}")
    mon = np.array(passes[n_pass0:] or passes)
    beat = np.array(beat_passes)
    log(f"[nodeloss] {workload}'s {len(nodes)} nodes, {len(managed)} of them ({len(managed_set)} "
        f"zones) with a kubelet (heartbeat {NODELOSS_HEARTBEAT_S} s) and a node lease; {sets} "
        f"ReplicaSets of {replicas} pods "
        f"bound in {setup_s:.3f} s with node creation; lifecycle {json.dumps(lifecycle)}; "
        f"the kubelets of {zone}'s {len(killed)} nodes stopped with rs-{sets} ({replicas} pods) "
        f"created at the same instant; kill -> all {len(killed)} tainted "
        f"{t_tainted - t_kill:.3f} s, -> first eviction {evict_times[0] - t_kill:.3f} s, -> all "
        f"{len(doomed)} evicted {max(evicted_at[u][0] for u in doomed) - t_kill:.3f} s, -> every "
        f"replacement bound {t_bound - t_kill:.3f} s; evictions {evictions:.0f} ({landed} of "
        f"them rs-{sets} pods that landed on a killed node), deferred evictions {deferred:.0f}; "
        f"rs-1 evicted {min(r[0] for r in rs1):.3f}-{max(r[0] for r in rs1):.3f} s after its "
        f"node went NotReady ({min(r[1] for r in rs1):.3f} s after its taint was written at the "
        f"least), {len(stayed)} rs-0 pods stayed; lifecycle pass p50 "
        f"{np.median(mon) * 1e3:.1f} ms, max {mon.max() * 1e3:.1f} ms ({len(passes)} passes); "
        f"heartbeat pass p50 {np.median(beat):.3f} s, max {beat.max():.3f} s ({len(beat)} "
        f"passes); wave batches after the kill {batches_kill} (pods, placed) "
        f"{batches[:batches_kill][:12]}; K1 launches {k1_setup} before the kill, {k1_tainted} "
        f"from the kill to every replacement bound, {k1} from the kill to the end; K2 {k2}; {rows_tainted} tainted rows on the card equal to the host encoding; revive "
        f"{len(revived)} -> untainted {t_untainted - t_revive:.3f} s, rs-{sets} grown by "
        f"{replicas} bound {t_grown - t_untainted:.3f} s later, {on_revived} of them on a revived "
        f"node; held batch of {len(chosen)} replacements on the tainted snapshot: card == CPU "
        f"({held_ties} near-tie chosen differences; the CPU run {held_cpu_s:.2f} s), "
        f"{len(on_taint)} on a taint they do not tolerate; {collections.summary()}; guard "
        f"trips {trips:.0f}; card {card}")
    if any(partial) or stray:
        log(f"[nodeloss] {timelines()}; thread CPU s {cpu_by_thread}")
    if missing or stray:
        raise AssertionError(f"[nodeloss] killed nodes without both taints {missing[:3]}, "
                             f"other nodes tainted {stray[:3]}")
    if any(partial):
        raise AssertionError("[nodeloss] the partial-disruption gauge left 0")
    gone = {d_[2] for d_ in from_killed}
    if not doomed <= gone or len(stayed) != sum(1 for v in on_killed.values() if v[2] == "rs-0"):
        raise AssertionError(f"[nodeloss] {len(doomed - gone)} doomed pods not deleted, "
                             f"{len(stayed)} rs-0 pods stayed")
    if not rs1 or min(r[0] for r in rs1) < NODELOSS_TOLERATION_S:
        raise AssertionError(f"[nodeloss] rs-1 evicted inside its toleration: {rs1[:3]}")
    if evictions != len(from_killed):
        raise AssertionError(f"[nodeloss] {evictions:.0f} evictions counted, "
                             f"{len(from_killed)} pods deleted from killed nodes")
    check_capacity(store, "nodeloss")
    nodes_end = {n.metadata.name: n for n in store.list("nodes")[0]}
    untolerated = [p.metadata.name for p in pods_end if v1.find_untolerated_taint(
        nodes_end[p.spec.node_name].spec.taints, p.spec.tolerations) is not None]
    uids = {p.metadata.uid for p in pods_end}
    twice = {u: n for u, n in store.applied.items() if n != 1}
    if untolerated or not uids <= set(store.applied) or twice:
        raise AssertionError(f"[nodeloss] {len(untolerated)} pods on a taint they do not "
                             f"tolerate, {len(uids - set(store.applied))} never bound, "
                             f"{len(twice)} bound more than once")
    if on_revived <= 0:
        raise AssertionError(f"[nodeloss] none of rs-{sets}'s last {replicas} pods on a revived node")
    if on_taint:
        raise AssertionError(f"[nodeloss] the held batch placed {on_taint[:3]} on a killed node")
    if k1_tainted <= 0 and device.type == "cuda":
        raise AssertionError("[nodeloss] K1 never launched after the kill")
    if trips or sched._device_down or not d["audit_passes"]:
        raise AssertionError(f"[nodeloss] guard trips {trips}, device down "
                             f"{sched._device_down}, auditor passes {d['audit_passes']}")
    return {"k1": k1, "k2": k2}


def phase_audit(server, device, card: str, errors: ErrorLog) -> dict:
    """[audit] on the [scheduler] phase's cluster after its burst (5,000
    nodes and the 6,000 pods the API server holds bound): the snapshot
    encoded on the card and, the same way, on the CPU; 16 rows of
    `requested` and `valid` corrupted in device state on both
    (corrupt_device_rows); one audit_once() on each must report exactly
    those rows in both fields, repair them (the fetched rows equal the
    masters afterwards) and rebuild nothing, and the card's report must
    equal the CPU's. Then the card's clean pass (p50 of 20) and
    fetch_device_rows of 64 rows (p50 of 20) are timed."""
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.scheduler.antientropy import SnapshotAntiEntropy
    from kubernetes_tpu_torch.testing.device_faults import corrupt_device_rows

    errors.check("before audit")
    nodes = server.list("nodes")[0]
    pods = [p for p in server.list("pods")[0] if p.spec.node_name]

    def build(dev):
        enc = SnapshotEncoder(EncodingConfig.for_cluster(len(nodes)), device=dev)
        for n in nodes:
            enc.add_node(n)
        for p in pods:
            enc.add_pod(p.spec.node_name, p)
        enc.flush()
        return enc

    t0 = time.perf_counter()
    encs = {"card": build(device), "cpu": build(torch.device("cpu"))}
    build_s = time.perf_counter() - t0
    live = [r for r, nm in enumerate(encs["card"].row_names) if nm]
    rows = live[0:64:4]  # 16 rows inside the auditor's first 64-row window
    reports = {}
    for where, enc in encs.items():
        corrupt_device_rows(enc, rows, field="requested")
        corrupt_device_rows(enc, rows, field="valid")
        rep = SnapshotAntiEntropy(enc, sample_rows=64).audit_once()
        reports[where] = (
            rep["rows_audited"], rep["device_drift"], rep["master_repaired"], rep["rebuilt"]
        )
        if rep["device_drift"] != {"requested": rows, "valid": rows}:
            raise AssertionError(f"[audit] {where}: drift report {rep['device_drift']}")
        if rep["master_repaired"] or rep["rebuilt"] or rep["rows_audited"] != 64:
            raise AssertionError(f"[audit] {where}: report {rep}")
        fetched = enc.fetch_device_rows(rows)
        for field, got in fetched.items():
            if not np.array_equal(got, enc._master_of(field)[rows]):
                raise AssertionError(f"[audit] {where}: {field} not repaired")
    if reports["card"] != reports["cpu"]:
        raise AssertionError(f"[audit] card report {reports['card']} != CPU {reports['cpu']}")
    enc = encs["card"]
    aud = SnapshotAntiEntropy(enc, sample_rows=64)
    pass_ms, fetch_ms = [], []
    window = live[:64]
    for _ in range(20):
        t0 = time.perf_counter()
        rep = aud.audit_once()
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        if rep["device_drift"] or rep["master_repaired"] or rep["rebuilt"]:
            raise AssertionError(f"[audit] a clean pass reported {rep}")
        t0 = time.perf_counter()
        enc.fetch_device_rows(window)
        fetch_ms.append((time.perf_counter() - t0) * 1e3)
    row_bytes = sum(
        getattr(enc._device, f)[0].numel() * getattr(enc._device, f).element_size()
        for f in enc.ROW_FIELDS
    )
    out = {
        "pass_p50_ms": float(np.median(pass_ms)),
        "fetch_p50_ms": float(np.median(fetch_ms)),
        "fetch_bytes": 64 * row_bytes,
    }
    log(f"[audit] {len(live)} nodes, {len(pods)} pods (built on the card and the CPU "
        f"in {build_s:.1f} s): 16 rows of requested and valid corrupted, one pass "
        f"reported exactly those rows in both fields on both, repaired and confirmed "
        f"them, no rebuild; card report == CPU report {reports['card'][:2]}; clean "
        f"pass p50 {out['pass_p50_ms']:.3f} ms (64 rows), fetch_device_rows of 64 "
        f"rows p50 {out['fetch_p50_ms']:.3f} ms ({out['fetch_bytes']} bytes, "
        f"{len(enc.ROW_FIELDS)} fields); card {card}")
    errors.check("audit")
    return out


def ledger_server(**kw):
    """An APIServer (of `kw`) that counts the binds it applies per pod uid,
    for the fault phases' "every pod bound exactly once"."""
    from collections import defaultdict

    from kubernetes_tpu_torch.client.apiserver import APIServer

    class LedgerServer(APIServer):
        def __init__(self):
            super().__init__(**kw)
            self.applied = defaultdict(int)

        def bind_pods(self, bindings, fence=None):
            errs = super().bind_pods(bindings, fence=fence)
            for b, err in zip(bindings, errs):
                if err is None:
                    self.applied[b.pod_uid] += 1
            return errs

    return LedgerServer()


# the fault phases' cluster: SchedulingPodAffinity's nodes with initial
# pods pre-bound, small enough that a batch quarantined to the host filter
# chain binds in seconds (cut from 500 nodes and 100 initial pods,
# PERF.md §4, so that the script stays inside its time limit), and above
# small_batch_host_node_max (256): at or below it the Scheduler sends a
# batch of at most 4 pods down the host path, so whether a check that
# wants every pod bound on the device passes would turn on how many of
# the measured pods the first pop found
FAULT_CLUSTER = ("SchedulingPodAffinity", 260, 50)


def run_fault(device, what: str, inj_kw: dict, cfg_kw: dict, rounds,
              mesh_devices=None, alive=None) -> dict:
    """One Scheduler (the reference's defaults plus cfg_kw, over
    mesh_devices when given) on the fault cluster with a
    DeviceFaultInjector(**inj_kw); the measured pods arrive in `rounds`
    (each round waits until its pods are bound). With `alive`, the
    ladder's probe of a mesh entry answers the card's real probe AND
    whether the entry's id is in `alive`. Fails unless every pod is
    bound exactly once, no node is oversubscribed, no pod sits outside
    its required zone affinity and no assume leaks. Returns the defense
    counters by label, the injections, the host-path pod count, the
    ladder's probe answers, K1's launches and the mesh at the end."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import default_config
    from kubernetes_tpu_torch.perf.workloads import WorkloadConfig, build_workload
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing.device_faults import DeviceFaultInjector
    from kubernetes_tpu_torch.utils.metrics import metrics

    name, n_nodes, n_init = FAULT_CLUSTER
    nodes, init_pods, factory = build_workload(
        WorkloadConfig(name, n_nodes, n_init, sum(rounds))
    )
    server = ledger_server()
    for n in nodes:
        server.create("nodes", n)
    for i, p in enumerate(init_pods):
        p.spec.node_name = nodes[(7 * i) % len(nodes)].metadata.name
        server.create("pods", p)
    metrics.reset()
    sched = Scheduler(server, default_config(**cfg_kw), device=device, mesh_devices=mesh_devices)
    inj = DeviceFaultInjector(**inj_kw).install(sched)
    host = []
    one_host = sched._schedule_one_host

    def counted_host(pi, moves):
        host.append(pi.pod.metadata.name)
        return one_host(pi, moves)

    sched._schedule_one_host = counted_host
    probes = []

    def probe(dev):
        ok = type(sched)._device_probe(dev)
        if alive is not None:
            ok = ok and dev is not None and dev.id in alive
        probes.append(ok)
        return ok

    sched._device_probe = probe
    fit_kernels.fit_mask.launches = 0
    created = 0
    t0 = time.perf_counter()
    try:
        sched.start()
        for n in rounds:
            for i in range(created, created + n):
                server.create("pods", factory(i))
            created += n
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                bound = server.count(
                    "pods", lambda p: p.metadata.name.startswith("pod-") and bool(p.spec.node_name)
                )
                if bound >= created:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError(f"[{what}] {bound}/{created} pods bound")
        deadline = time.monotonic() + 10
        while sched.cache.assumed_keys() and time.monotonic() < deadline:
            time.sleep(0.02)
        leaked = list(sched.cache.assumed_keys())
    finally:
        sched.stop()
        inj.uninstall()
    wall = time.perf_counter() - t0
    if leaked:
        raise AssertionError(f"[{what}] leaked assumes: {leaked[:3]}")
    twice = {u: c for u, c in server.applied.items() if c != 1}
    if twice:
        raise AssertionError(f"[{what}] {len(twice)} pods bound more than once")
    check_bindings(server, created, what)

    def by_label(name):
        return {
            next(iter(labels.values()), ""): int(v)
            for _n, labels, v in metrics.snapshot_counters(name) if v
        }

    return {
        "pods": created, "wall_s": wall, "host": len(host),
        "trips": by_label("kernel_guard_trips_total"),
        "losses": by_label("scheduler_device_loss_total"),
        "retries": by_label("scheduler_device_retries_total"),
        "unwound": int(metrics.counter("scheduler_wave_trailing_unwound_assumes_total")),
        "device_down": int(sched._device_down),
        "injected": sorted({k for k, _ in inj.injected}),
        "probes": probes, "k1": fit_kernels.fit_mask.launches,
        "mesh": [d.id for d in sched._mesh.devices] if sched._mesh is not None else None,
        "pinned": getattr(sched.cache.encoder.pinned_device, "id", None),
        "shrinks": int(metrics.counter("scheduler_mesh_shrinks_total")),
        "mesh_devices": metrics.gauge("scheduler_mesh_devices"),
        "snapshot": type(sched.cache.encoder._device).__name__,
    }


def fault_line(what: str, case: str, r: dict, card: str) -> None:
    log(f"[{what}] {case}: {r['pods']} pods bound exactly once in {r['wall_s']:.2f} s "
        f"({r['host']} through the host path), none oversubscribed, no leaked "
        f"assume; injected {r['injected']}; guard trips {json.dumps(r['trips'], sort_keys=True)}; "
        f"device losses {json.dumps(r['losses'], sort_keys=True)}, retries "
        f"{json.dumps(r['retries'], sort_keys=True)}; unwound assumes {r['unwound']}; "
        f"probe answers {r['probes']}; scheduler_device_down {r['device_down']}; "
        f"K1 launches {r['k1']}; card {card}")


GUARD_ERRORS = (
    "kernel output guard tripped",
    "trailing readback validation tripped",
    "consecutive kernel guard trips: abandoning the device path",
)
LOSS_ERRORS = (
    "wave launch failed with device loss",
    "device loss on serial batch kernel persists",
    "consecutive device-loss events without a successful launch",
)


def phase_guards(device, card: str, errors: ErrorLog) -> dict:
    """[guards] on the fault cluster (260 nodes, 50 pre-bound pods):
    NaN scores on the first trailing (score) readback and a wild chosen
    row on the second index readback, 100 + 100 pods: both trips counted
    by reason, the wild batch quarantined to the host path, the device not
    latched. Then a fresh Scheduler whose first K index readbacks are all
    wild (K = device_loss_disable_after): K consecutive trips latch the
    device down and the host path binds the rest (4 rounds of 30 pods)."""
    from kubernetes_tpu_torch.perf.harness import default_config

    errors.check("before guards")
    k = default_config().device_loss_disable_after
    one = run_fault(
        device, "guards", dict(nan_scores_on_readbacks={0}, wild_rows_on_readbacks={1}),
        {}, [100, 100],
    )
    fault_line("guards", "NaN score on readback 0, wild row on readback 1", one, card)
    if not (one["trips"].get("nonfinite_score") and one["trips"].get("row_out_of_range")):
        raise AssertionError(f"[guards] trips {one['trips']}")
    if one["host"] <= 0 or one["device_down"]:
        raise AssertionError("[guards] no host-path quarantine, or the device latched")
    latch = run_fault(
        device, "guards", dict(wild_rows_on_readbacks=set(range(k))), {}, [30] * (k + 1),
    )
    fault_line("guards", f"{k} consecutive wild-row readbacks", latch, card)
    if latch["trips"].get("row_out_of_range") != k or not latch["device_down"]:
        raise AssertionError(f"[guards] {k} trips did not latch the device down")
    n_err = errors.expect("guards", GUARD_ERRORS)
    log(f"[guards] {n_err} ERROR records, all caused by the injected faults")
    return {"one": one, "latch": latch}


def phase_device_loss(device, card: str, errors: ErrorLog) -> dict:
    """[device-loss] on the fault cluster, three cases: (a) the first wave
    launch lost with no retry budget (device_retry_attempts=0): the ladder
    probes the real card, which answers, the device stays up and the
    requeued batch binds on the device; (b) every wave launch lost: after
    device_loss_disable_after losses (each after its retries) the device
    latches down and the host path binds the rest; (c) the same on the
    serial path (use_wave=False, every serial launch lost, one 30-pod
    batch per round)."""
    from kubernetes_tpu_torch.perf.harness import default_config
    from kubernetes_tpu_torch.scheduler import Scheduler

    errors.check("before device-loss")
    k = default_config().device_loss_disable_after
    if not Scheduler._device_probe(device):
        raise AssertionError("[device-loss] the card's probe answered False")
    blip = run_fault(
        device, "device-loss", dict(fail_launches={0}), dict(device_retry_attempts=0), [120],
    )
    fault_line("device-loss", "launch 0 lost, no retry budget", blip, card)
    if blip["losses"] != {"launch": 1} or blip["probes"] != [True] or blip["device_down"]:
        raise AssertionError("[device-loss] a single loss did not recover on the device")
    if blip["host"] or (device.type == "cuda" and blip["k1"] <= 0):
        raise AssertionError("[device-loss] the recovered batch did not bind on the device")
    dead = run_fault(device, "device-loss", dict(fail_all_launches=True), {}, [120])
    fault_line("device-loss", "every wave launch lost", dead, card)
    if dead["losses"] != {"launch": k} or not dead["device_down"] or dead["host"] != 120:
        raise AssertionError("[device-loss] the wave path did not latch to the host path")
    serial = run_fault(
        device, "device-loss", dict(fail_all_serials=True), dict(use_wave=False),
        [30] * (k + 1),
    )
    fault_line("device-loss", "every serial launch lost (use_wave=False)", serial, card)
    if serial["losses"] != {"serial": k} or not serial["device_down"]:
        raise AssertionError("[device-loss] the serial path did not latch")
    n_err = errors.expect("device-loss", LOSS_ERRORS)
    log(f"[device-loss] {n_err} ERROR records, all caused by the injected losses")
    return {"blip": blip, "dead": dead, "serial": serial}


MESH_SHARDS = 4
MESH_ERRORS = ("mesh shrunk to", "wave launch failed with device loss")


def phase_mesh(mp, device, card: str, errors: ErrorLog) -> dict:
    """[mesh]: node-axis sharding over MESH_SHARDS virtual entries of the
    card (parallel/mesh.virtual_devices), SchedulingPodAffinity/5000's
    snapshot (n_cap 8192, 2,048 rows a shard):
    (a) one 4096-pod wave batch of the main path through the sharded wave
        kernel and the single-device WaveKernel, same snapshot (cloned)
        and noise: chosen, placed, deferred, feasible_count, score,
        resolvable_tpl, feasible_tpl and every committed snapshot field
        equal; K1 on each shard's rows equals its plain version, and the
        sharded batch launches K1 once a shard; walls and a profile of
        each;
    (b) one 64-pod serial batch, sharded against single, every output
        equal;
    (c) the burst through run_benchmark with mesh_devices = the 4
        entries: 5000/5000 bound once, affinity held, 0 trips, drift,
        rebuilds, device-down, no ERROR; pods/s, batches, K1 launches,
        blocking readbacks;
    (d) the shrink on the fault cluster: entries 2 and 3 fail the probe
        and launch 0 is lost: the mesh shrinks to [0, 1], every pod bound
        once, scheduler_mesh_devices 2; then only entry 1 answers: the
        encoder pins the snapshot to entry 1."""
    from kubernetes_tpu_torch.client.apiserver import APIServer
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.encoding import gather_snapshot
    from kubernetes_tpu_torch.ops.lattice import make_schedule_batch
    from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel
    from kubernetes_tpu_torch.parallel import make_mesh, shard_snapshot
    from kubernetes_tpu_torch.parallel.mesh import virtual_devices
    from kubernetes_tpu_torch.parallel.sharded import (
        make_sharded_schedule_batch,
        make_sharded_wave_kernel,
    )
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.scheduler.wavepath import prepare_batch
    from kubernetes_tpu_torch.utils.metrics import metrics

    t_phase = time.perf_counter()
    entries = virtual_devices(device, MESH_SHARDS)
    mesh = make_mesh(entries)
    enc, cfg = mp["enc"], mp["cfg"]
    pods = [mp["factory"](300000 + i) for i in range(cfg.batch_size)]
    prep = prepare_batch(enc, mp["cache"], pods, cfg)
    snap = enc.flush()
    k = prep.kern
    variant = (k.v_cap, k.m_cand, k.n_waves, k.hard_pod_affinity_weight, True,
               k.score_refresh, k.rtc_shape, k.has_pinned)
    single = make_wave_kernel(*variant)
    sharded = make_sharded_wave_kernel(*variant[:4], mesh, *variant[4:])
    n = snap.valid.shape[0]
    m_c = min(k.m_cand, n)
    noise = torch.rand((cfg.batch_size, m_c), generator=mp["rng"], device=device) * 0.999

    def clone(nt):
        return type(nt)(*(t.clone() for t in nt))

    base = shard_snapshot(snap, mesh)
    # K1 on each shard's rows against its plain version (comparison launches)
    for i, blk in enumerate(base.blocks):
        free = (blk.allocatable - blk.requested).contiguous()
        req = prep.eb.batch.tpl.req.contiguous()
        if not torch.equal(fit_kernels.fit_mask(req, free), fit_kernels.fit_mask_plain(req, free)):
            raise AssertionError(f"[mesh] K1 on shard {i} differs from its plain version")
    rows = base.rows
    run1 = lambda: single.with_noise(clone(snap), prep.eb.batch, prep.ptab, mp["weights"], noise)  # noqa: E731
    run4 = lambda: sharded.with_noise(  # noqa: E731
        shard_snapshot(snap, mesh), prep.eb.batch, prep.ptab, mp["weights"], noise)
    s1, r1 = run1()
    zero_k(fit_kernels)
    s4, r4 = run4()
    torch.cuda.synchronize()
    k1_batch = fit_kernels.fit_mask.launches
    for f in ("chosen", "placed", "deferred", "feasible_count", "score"):
        if not torch.equal(getattr(r1, f), getattr(r4, f)):
            raise AssertionError(f"[mesh] sharded wave batch: {f} differs from one device")
    for f in ("resolvable_tpl", "feasible_tpl"):
        if not torch.equal(getattr(r1, f).cpu(), getattr(r4, f).cpu()):
            raise AssertionError(f"[mesh] sharded wave batch: {f} differs from one device")
    g = gather_snapshot(s4)
    for f in s1._fields:
        if not torch.equal(getattr(s1, f), getattr(g, f)):
            raise AssertionError(f"[mesh] sharded wave batch: committed {f} differs")
    if k1_batch != MESH_SHARDS:
        raise AssertionError(f"[mesh] K1 launched {k1_batch} times for {MESH_SHARDS} shards")

    def wall(fn, reps=3):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]

    w1, w4 = wall(run1), wall(run4)
    log(f"[mesh] one {cfg.batch_size}-pod wave batch, {prep.n_waves} waves, on "
        f"{MESH_SHARDS} virtual shards of {rows} rows (n_cap {n}) equals one device: "
        f"chosen, placed, deferred, feasible_count, score, resolvable_tpl, "
        f"feasible_tpl and the committed snapshot ({int(r4.placed.sum())} placed); "
        f"K1 {k1_batch} launches (one a shard), each shard's mask equal to its plain "
        f"version; wall p50 of 3: single {w1:.2f} ms, sharded {w4:.2f} ms; card {card}")
    prof1 = prof4 = {}
    try:
        prof1 = profile_device(f"[mesh] single-device wave batch ({cfg.batch_size} pods)", run1)
        prof4 = profile_device(f"[mesh] sharded wave batch ({MESH_SHARDS} shards)", run4)
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] mesh wave batch device time not measured: {e}")

    # (b) the serial kernel
    spods = [mp["factory"](400000 + i) for i in range(64)]
    eb = encode_pod_batch(enc, spods, pad_to=64)
    snap = enc.flush()
    snoise = torch.rand((64, n), generator=mp["rng"], device=device)
    ks1 = make_schedule_batch(enc.cfg.v_cap)
    ks4 = make_sharded_schedule_batch(enc.cfg.v_cap, mesh)
    sbase = shard_snapshot(snap, mesh)
    ks1(snap, eb.batch, mp["weights"], snoise)  # allocator warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = ks1(snap, eb.batch, mp["weights"], snoise)
    torch.cuda.synchronize()
    sw1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = ks4(sbase, eb.batch, mp["weights"], snoise)
    torch.cuda.synchronize()
    sw4 = time.perf_counter() - t0
    for f in ("chosen", "score", "feasible_count"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"[mesh] sharded serial batch: {f} differs from one device")
    if not torch.equal(a.resolvable.cpu(), b.resolvable.cpu()):
        raise AssertionError("[mesh] sharded serial batch: resolvable differs from one device")
    log(f"[mesh] one 64-pod serial batch on {MESH_SHARDS} shards equals one device "
        f"(chosen, score, feasible_count, resolvable; {int((a.chosen >= 0).sum())} placed): "
        f"single {sw1:.3f} s = {sw1 / 64 * 1e3:.2f} ms a pod step, sharded {sw4:.3f} s = "
        f"{sw4 / 64 * 1e3:.2f} ms a pod step; card {card}")
    del s1, s4, g, base, sbase

    # (c) the Scheduler's burst on the mesh
    errors.check("before mesh")
    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    server = APIServer()
    zero_k(fit_kernels)
    res = run_benchmark(wl, device=device, server=server, timeout_s=300,
                        mesh_devices=virtual_devices(device, MESH_SHARDS))
    k1_burst, k2_burst = count_k(fit_kernels)
    blocking = metrics.counter("scheduler_wave_readbacks_blocking_total")
    log(f"[mesh] SchedulingPodAffinity/5000 through APIServer + Scheduler on "
        f"{MESH_SHARDS} virtual shards: {res.scheduled}/{res.num_measured_pods} bound "
        f"in {res.duration_s:.3f} s = {res.throughput_pods_per_s:.1f} pods/s; e2e p99 "
        f"{res.e2e_p99_ms:.1f} ms; {res.n_batches} batches, {res.n_readbacks} blocking "
        f"readbacks ({blocking:.0f} blocking syncs in all); K1 launches {k1_burst}, "
        f"K2 launches {k2_burst}; guard trips {res.guard_trips}; card {card}")
    errors.check("mesh")
    defense_report("mesh", card, res=res)
    if res.scheduled != res.num_measured_pods or res.unscheduled or res.guard_trips:
        raise AssertionError("[mesh] the burst on the mesh left pods unbound or tripped")
    if k1_burst <= 0:
        raise AssertionError("[mesh] the Scheduler on the mesh never launched K1")
    check_bindings(server, wl.num_measured_pods, "mesh")
    del server

    # (d) the shrink rungs of the device-loss ladder
    t0 = time.perf_counter()
    two = run_fault(device, "mesh", dict(fail_launches={0}), dict(device_retry_attempts=0),
                    [120], mesh_devices=entries, alive={0, 1})
    fault_line("mesh", f"entries 2, 3 dead, launch 0 lost ({MESH_SHARDS} shards)", two, card)
    if two["mesh"] != [0, 1] or two["shrinks"] != 1 or two["mesh_devices"] != 2.0:
        raise AssertionError(f"[mesh] no shrink to 2: mesh {two['mesh']}, shrinks "
                             f"{two['shrinks']}, gauge {two['mesh_devices']}")
    if two["device_down"] or two["host"] or two["snapshot"] != "ShardedSnapshot":
        raise AssertionError("[mesh] the shrunk mesh did not bind on the device")
    one = run_fault(device, "mesh", dict(fail_launches={0}), dict(device_retry_attempts=0),
                    [120], mesh_devices=entries, alive={1})
    fault_line("mesh", "only entry 1 answers, launch 0 lost", one, card)
    if one["mesh"] is not None or one["pinned"] != 1 or one["mesh_devices"] != 1.0:
        raise AssertionError(f"[mesh] no pin to the survivor: mesh {one['mesh']}, "
                             f"pinned {one['pinned']}")
    if one["device_down"] or one["host"] or one["snapshot"] != "DeviceSnapshot":
        raise AssertionError("[mesh] the survivor did not bind on the device")
    shrink_s = time.perf_counter() - t0
    n_err = errors.expect("mesh", MESH_ERRORS)
    log(f"[mesh] shrinks: 4 -> 2 ({two['pods']} pods in {two['wall_s']:.2f} s) and 4 -> "
        f"entry 1 pinned ({one['pods']} pods in {one['wall_s']:.2f} s), {shrink_s:.1f} s "
        f"together; {n_err} ERROR records, all from the injected losses and the "
        f"shrinks; [mesh] {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return {
        "k1": k1_burst, "k2": k2_burst, "pods_per_s": res.throughput_pods_per_s,
        "wall_single_ms": w1, "wall_sharded_ms": w4, "k1_batch": k1_batch,
        "serial_single_s": sw1, "serial_sharded_s": sw4,
        "launches_single": prof1.get("launches"), "launches_sharded": prof4.get("launches"),
    }


DIST_WORKERS = 2  # processes of the gloo group, all on the one card
DIST_ENTRIES = 2  # virtual mesh entries a process
DIST_TIMEOUT_S = 150  # each spawn of workers, killed past it
DIST_GROUP_TIMEOUT_S = 60.0  # a collective waiting on a dead peer raises
DIST_RESULT = "[dist result] "
DIST_WAVE_RUNS = 5
WAVE_FIELDS = ("chosen", "placed", "deferred", "feasible_count", "score")
SERIAL_FIELDS = ("chosen", "score", "feasible_count")


def dist_case(device, seed: int, workload: str, wave_pods: int, serial_pods: int) -> dict:
    """[dist]'s inputs, built alike from `seed` in the parent and in every
    worker (the SPMD contract: identical host state): the workload's
    nodes encoded on `device` and its initial pods placed through the
    wave path, as the main path starts; one `wave_pods` wave batch
    prepared at full width and one `serial_pods` serial batch; each
    batch's tie noise drawn from a generator on `device` seeded from
    `seed`."""
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.ops.lattice import weights_for_policy
    from kubernetes_tpu_torch.ops.templates import TemplateCache
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler.wavepath import WavePathConfig, prepare_batch, schedule_pods

    wl = WORKLOADS[workload]
    nodes, init_pods, factory = build_workload(wl)
    enc = SnapshotEncoder(EncodingConfig.for_cluster(wl.num_nodes), device=device)
    for n in nodes:
        enc.add_node(n)
    cache = TemplateCache(enc)
    weights = torch.tensor(weights_for_policy("default"), device=device)
    cfg = WavePathConfig()
    init = schedule_pods(enc, cache, init_pods, weights,
                         torch.Generator(device=device).manual_seed(seed), cfg)
    if init.unscheduled or init.fallback or len(init.placed) != len(init_pods):
        raise AssertionError(f"[dist] init pods: {len(init.placed)}/{len(init_pods)} placed")
    prep = prepare_batch(enc, cache, [factory(300000 + i) for i in range(wave_pods)], cfg)
    sb = encode_pod_batch(enc, [factory(400000 + i) for i in range(serial_pods)],
                          pad_to=serial_pods)
    snap = enc.flush()
    n = snap.valid.shape[0]
    k = prep.kern
    g = torch.Generator(device=device).manual_seed(seed + 1)
    noise = torch.rand((prep.eb.batch.pod_tpl.shape[0], min(k.m_cand, n)), generator=g,
                       device=device) * 0.999
    snoise = torch.rand((serial_pods, n), generator=g, device=device)
    return {
        "enc": enc, "prep": prep, "sb": sb, "weights": weights, "noise": noise,
        "snoise": snoise, "n": n,
        "variant": (k.v_cap, k.m_cand, k.n_waves, k.hard_pod_affinity_weight, True,
                    k.score_refresh, k.rtc_shape, k.has_pinned),
    }


def clone_sharded(snap):
    """A ShardedSnapshot of clones of this process's blocks."""
    from kubernetes_tpu_torch.ops.encoding import DeviceSnapshot, RemoteBlock, ShardedSnapshot

    return ShardedSnapshot(snap.mesh, [
        b if isinstance(b, RemoteBlock) else DeviceSnapshot(*(t.clone() for t in b))
        for b in snap.blocks
    ])


def dist_worker_main(spec: dict) -> int:
    """One process of [dist] (this script with --dist-worker SPEC): joins
    the group (spec's backend, file store, world and rank), builds
    dist_case, adopts a mesh of spec["entries"] virtual entries of its
    device per process through set_sharding, checks K1 on each of its
    shards against the plain version, then runs the wave batch (counted:
    K1 launches, collectives, bytes; then timed DIST_WAVE_RUNS times,
    each from a clone of the flushed blocks) and the serial batch.
    Saves its outputs and committed blocks to spec["out"] and prints a
    summary after DIST_RESULT."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.parallel import distributed
    from kubernetes_tpu_torch.parallel.mesh import (
        make_mesh, replicated, snapshot_shardings, virtual_devices,
    )
    from kubernetes_tpu_torch.parallel.sharded import (
        make_sharded_schedule_batch, make_sharded_wave_kernel,
    )
    from kubernetes_tpu_torch.utils.metrics import metrics

    device = torch.device(spec["device"])
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        fit_kernels.build_all()  # built by the parent: loads the libraries
    distributed.initialize(spec["init"], spec["world"], spec["rank"], spec["backend"],
                           timeout_s=DIST_GROUP_TIMEOUT_S)
    c = dist_case(device, spec["seed"], spec["workload"], spec["wave_pods"], spec["serial_pods"])
    mesh = make_mesh(virtual_devices(device, spec["entries"]))
    enc, prep = c["enc"], c["prep"]
    enc.set_sharding(snapshot_shardings(mesh), replicated(mesh))
    base = enc.flush()
    req = prep.eb.batch.tpl.req.contiguous()
    for s, blk in base.local:  # comparison launches, before the count
        free = (blk.allocatable - blk.requested).contiguous()
        if not torch.equal(fit_kernels.fit_mask(req, free), fit_kernels.fit_mask_plain(req, free)):
            raise AssertionError(f"[dist] K1 on shard {s} differs from its plain version")
    v = c["variant"]
    kern = make_sharded_wave_kernel(*v[:4], mesh, *v[4:])
    skern = make_sharded_schedule_batch(v[0], mesh)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def wave():
        return kern.with_noise(clone_sharded(base), prep.eb.batch, prep.ptab, c["weights"],
                               c["noise"])

    def serial():
        return skern(base, c["sb"].batch, c["weights"], c["snoise"])

    def counted(fn):
        sync()
        c0 = metrics.counter("distributed_collectives_total")
        b0 = metrics.counter("distributed_bytes_total")
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (out, time.perf_counter() - t0,
                metrics.counter("distributed_collectives_total") - c0,
                metrics.counter("distributed_bytes_total") - b0)

    zero_k(fit_kernels)
    (snap, res), _t, w_coll, w_bytes = counted(wave)
    k1, k2 = count_k(fit_kernels)
    walls = [counted(wave)[1] * 1e3 for _ in range(DIST_WAVE_RUNS)]
    sres, s_wall, s_coll, s_bytes = counted(serial)
    torch.save({
        "wave": {f: getattr(res, f).cpu() for f in WAVE_FIELDS},
        "wave_masks": {f: {s: p.cpu() for s, p in enumerate(getattr(res, f).parts) if p is not None}
                       for f in ("resolvable_tpl", "feasible_tpl")},
        "blocks": {s: {f: t.cpu() for f, t in zip(blk._fields, blk)} for s, blk in snap.local},
        "serial": {f: getattr(sres, f).cpu() for f in SERIAL_FIELDS},
        "serial_resolvable": {s: p.cpu() for s, p in enumerate(sres.resolvable.parts)
                              if p is not None},
    }, spec["out"])
    print(DIST_RESULT + json.dumps({
        "rank": spec["rank"], "backend": spec["backend"], "mesh": repr(mesh),
        "local": [e.id for e in mesh.local], "k1": k1, "k2": k2,
        "wave_walls_ms": walls, "wave_p50_ms": sorted(walls)[len(walls) // 2],
        "wave_collectives": w_coll, "wave_bytes": w_bytes, "serial_s": s_wall,
        "serial_collectives": s_coll, "serial_bytes": s_bytes,
        "placed": int(res.placed.sum()),
    }), flush=True)
    distributed.shutdown()
    return 0


def spawn_dist(world: int, backend: str, tmp: Path, tag: str, common: dict) -> list:
    """Starts `world` workers together (this script with --dist-worker),
    each in a session of its own, with gloo on the loopback interface;
    waits for all of them up to DIST_TIMEOUT_S in all, then kills every
    one still running. Fails unless each exits 0 with its result line.
    Returns [(summary, outputs)] in rank order."""
    import os
    import signal

    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    init = "file://" + str(tmp / f"{tag}.store")
    procs = []
    for rank in range(world):
        spec = dict(common, rank=rank, world=world, backend=backend, init=init,
                    out=str(tmp / f"{tag}{rank}.pt"))
        log_f = open(tmp / f"{tag}{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-worker", json.dumps(spec)],
            stdout=log_f, stderr=subprocess.STDOUT, env=env, start_new_session=True,
        ), log_f))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    rcs = []
    try:
        for p, _f in procs:
            try:
                rcs.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p, f in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
            f.close()
    out = []
    for rank, rc in enumerate(rcs):
        text = (tmp / f"{tag}{rank}.log").read_text()
        lines = [x for x in text.splitlines() if x.startswith(DIST_RESULT)]
        if rc != 0 or not lines:
            why = "killed after the timeout" if rc is None else f"exit code {rc}"
            raise AssertionError(f"[dist] {backend} worker {rank} of {world}: {why}\n{text[-3000:]}")
        out.append((json.loads(lines[0][len(DIST_RESULT):]),
                    torch.load(tmp / f"{tag}{rank}.pt", map_location="cpu")))
    return out


def check_dist(w: dict, s: dict, r1, s1, a, rows: int, k1_each: int, what: str) -> None:
    """A worker's outputs against the parent's single-device runs: the
    wave batch's outputs (r1), its local mask parts and committed blocks
    (s1's rows), the serial batch's outputs (a); all exactly. K1 must
    have launched `k1_each` times a local shard in the counted batch."""
    from kubernetes_tpu_torch.ops.encoding import _GLOBAL_FIELDS

    for f in WAVE_FIELDS:
        if not torch.equal(getattr(r1, f).cpu(), w["wave"][f]):
            raise AssertionError(f"[dist] {what}: wave {f} differs from one device")
    for f, parts in w["wave_masks"].items():
        full = getattr(r1, f).cpu()
        for sh, p in parts.items():
            if not torch.equal(full[:, sh * rows:(sh + 1) * rows], p):
                raise AssertionError(f"[dist] {what}: wave {f} part {sh} differs")
    for sh, blk in w["blocks"].items():
        for f, t in blk.items():
            want = getattr(s1, f).cpu()
            if f not in _GLOBAL_FIELDS:
                want = want[sh * rows:(sh + 1) * rows]
            if not torch.equal(want, t):
                raise AssertionError(f"[dist] {what}: committed {f} of block {sh} differs")
    for f in SERIAL_FIELDS:
        if not torch.equal(getattr(a, f).cpu(), w["serial"][f]):
            raise AssertionError(f"[dist] {what}: serial {f} differs from one device")
    for sh, p in w["serial_resolvable"].items():
        if not torch.equal(a.resolvable.cpu()[:, sh * rows:(sh + 1) * rows], p):
            raise AssertionError(f"[dist] {what}: serial resolvable part {sh} differs")
    if len(w["blocks"]) != DIST_ENTRIES or s["k1"] != k1_each * DIST_ENTRIES:
        raise AssertionError(f"[dist] {what}: {len(w['blocks'])} blocks, K1 launched "
                             f"{s['k1']} times for {DIST_ENTRIES} local shards")


def phase_dist(device, card: str, seed: int, mesh_figs: dict,
               workload: str = "SchedulingPodAffinity/5000", wave_pods: int = 4096,
               serial_pods: int = 64, one_rank_backend: str = "nccl") -> dict:
    """[dist]: the mesh over processes. DIST_WORKERS processes on the card
    form a gloo group through a file store, each adding DIST_ENTRIES
    virtual entries (4 entries of 2,048 rows at n_cap 8192); each builds
    dist_case from the same seed and runs the wave batch (4096 pods, 512
    candidates) and the serial batch (64 pods) over the global mesh, the
    merges and row reads going through the group's collectives. Each
    process's outputs and committed local blocks must equal this
    process's single-device run of the same batches exactly; K1 launches
    once a local shard and equals its plain version on each. Then the
    same batches in one process under a 1-rank NCCL group (one card
    admits no second NCCL rank): equal too. Prints each worker's wave
    wall p50 of DIST_WAVE_RUNS, collectives and bytes a batch beside
    [mesh]'s one-process figures."""
    import shutil
    import tempfile

    from kubernetes_tpu_torch.ops.lattice import make_schedule_batch
    from kubernetes_tpu_torch.ops.wavelattice import make_wave_kernel

    t_phase = time.perf_counter()
    c = dist_case(device, seed, workload, wave_pods, serial_pods)
    snap = c["enc"].flush()
    s1, r1 = make_wave_kernel(*c["variant"]).with_noise(
        type(snap)(*(t.clone() for t in snap)), c["prep"].eb.batch, c["prep"].ptab,
        c["weights"], c["noise"])
    a = make_schedule_batch(c["variant"][0])(snap, c["sb"].batch, c["weights"], c["snoise"])
    rows = c["n"] // (DIST_WORKERS * DIST_ENTRIES)
    k1_each = 1 if device.type == "cuda" else 0  # the CPU runs K1's plain version
    common = {"device": str(device), "seed": seed, "workload": workload, "wave_pods": wave_pods,
              "serial_pods": serial_pods, "entries": DIST_ENTRIES}
    tmp = Path(tempfile.mkdtemp(prefix="dist-smoke-"))
    try:
        t0 = time.perf_counter()
        gloo = spawn_dist(DIST_WORKERS, "gloo", tmp, "gloo", common)
        gloo_s = time.perf_counter() - t0
        for s, w in gloo:
            check_dist(w, s, r1, s1, a, rows, k1_each, f"gloo process {s['rank']}")
        t0 = time.perf_counter()
        ((one, w1),) = spawn_dist(1, one_rank_backend, tmp, "one", common)
        one_s = time.perf_counter() - t0
        check_dist(w1, one, r1, s1, a, c["n"] // DIST_ENTRIES, k1_each,
                   f"1-rank {one_rank_backend}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for s, _w in gloo:
        log(f"[dist] gloo process {s['rank']} of {DIST_WORKERS} on {device} ({DIST_ENTRIES} "
            f"entries {s['local']} of {s['mesh']}, {rows} rows a shard, n_cap {c['n']}): the "
            f"{wave_pods}-pod wave batch ({s['placed']} placed) and the {serial_pods}-pod serial "
            f"batch equal one device exactly (outputs, local mask parts, committed local "
            f"blocks); K1 {s['k1']} launches (one a local shard), each local shard's mask "
            f"equal to its plain version; wave wall p50 of {DIST_WAVE_RUNS} "
            f"{s['wave_p50_ms']:.2f} ms (runs {_fmt([x / 1e3 for x in s['wave_walls_ms']])} "
            f"ms), {s['wave_collectives']:.0f} collectives and {s['wave_bytes']:.0f} bytes "
            f"a wave batch; serial {s['serial_s']:.3f} s = "
            f"{s['serial_s'] / serial_pods * 1e3:.2f} ms a pod step, "
            f"{s['serial_collectives']:.0f} collectives and {s['serial_bytes']:.0f} bytes; "
            f"card {card}")
    log(f"[dist] beside [mesh] (one process, {MESH_SHARDS} entries, no collectives): wave "
        f"wall single {mesh_figs.get('wall_single_ms', float('nan')):.2f} ms, sharded "
        f"{mesh_figs.get('wall_sharded_ms', float('nan')):.2f} ms; serial single "
        f"{mesh_figs.get('serial_single_s', float('nan')):.3f} s, sharded "
        f"{mesh_figs.get('serial_sharded_s', float('nan')):.3f} s; card {card}")
    log(f"[dist] 1-rank {one_rank_backend} group ({DIST_ENTRIES} entries): wave and serial "
        f"batches equal one device; wave wall p50 {one['wave_p50_ms']:.2f} ms, "
        f"{one['wave_collectives']:.0f} collectives and {one['wave_bytes']:.0f} bytes a wave "
        f"batch; serial {one['serial_s']:.3f} s, {one['serial_collectives']:.0f} "
        f"collectives; K1 {one['k1']} launches; card {card}")
    log(f"[dist] workers: gloo pair {gloo_s:.1f} s, 1-rank {one_rank_backend} {one_s:.1f} s; "
        f"[dist] {time.perf_counter() - t_phase:.1f} s in all; card {card}")
    return {"k1": sum(s["k1"] for s, _w in gloo), "k2": sum(s["k2"] for s, _w in gloo),
            "wave_p50_ms": [s["wave_p50_ms"] for s, _w in gloo],
            "one_rank_k1": one["k1"]}


def phase_hostcb(device, card: str, errors: ErrorLog) -> dict:
    """[hostcb] SchedulingPodAffinity/5000 through run_benchmark with
    host_callback_binds=True: every fast payload delivered by the delivery
    thread. Fails unless 5000/5000 bound (bindings checked), 0 guard trips,
    0 blocking readbacks, deliveries == launched wave batches, the ticket
    registry's backlog back where it started, and K1 launched."""
    from kubernetes_tpu_torch.ops import fit_kernels, hostcallback
    from kubernetes_tpu_torch.perf.harness import default_config, run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.utils.metrics import metrics

    errors.check("before hostcb")
    wl = WORKLOADS["SchedulingPodAffinity/5000"]
    server = ledger_server()
    backlog0 = hostcallback.backlog()
    zero_k(fit_kernels)
    res = run_benchmark(
        wl, sched_config=default_config(host_callback_binds=True), device=device,
        server=server, timeout_s=300,
    )
    k1, k2 = count_k(fit_kernels)
    delivered = int(metrics.counter("scheduler_wave_hostcb_deliveries_total"))
    launched = int(metrics.counter("scheduler_wave_batches_total"))
    blocking = int(metrics.counter("scheduler_wave_readbacks_blocking_total"))
    backlog = hostcallback.backlog() - backlog0
    log(f"[hostcb] SchedulingPodAffinity/5000, host_callback_binds=True: "
        f"{res.scheduled}/{res.num_measured_pods} bound in {res.duration_s:.3f} s = "
        f"{res.throughput_pods_per_s:.1f} pods/s; e2e p50/p99 {res.e2e_p50_ms:.1f}/"
        f"{res.e2e_p99_ms:.1f} ms; {launched} wave batches, {delivered} payloads "
        f"taken from deliveries, {blocking} blocking readbacks, registry backlog "
        f"{backlog:+d}; guard trips {res.guard_trips}; K1 launches {k1}, K2 "
        f"launches {k2}; card {card}")
    errors.check("hostcb")
    defense_report("hostcb", card, res=res)
    if res.scheduled != res.num_measured_pods or res.guard_trips:
        raise AssertionError("[hostcb] pods unbound or guard trips")
    if blocking or delivered != launched or launched <= 0 or backlog:
        raise AssertionError("[hostcb] a payload was not delivered, or a ticket leaked")
    if k1 <= 0:
        raise AssertionError("[hostcb] the Scheduler never launched K1")
    if any(c != 1 for c in server.applied.values()):
        raise AssertionError("[hostcb] a pod was bound more than once")
    check_bindings(server, wl.num_measured_pods, "hostcb")
    return {"res": res, "k1": k1, "k2": k2}


class SeededNoise:
    """A what-if pass's tie noise, the same on any device: ``noise(P, N)``
    draws [P, N] uniform floats from a CPU Generator seeded `seed` and
    moves them to `device`, so two simulators given equal seeds see equal
    noise."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def __call__(self, p: int, n: int) -> torch.Tensor:
        return torch.rand((p, n), generator=self.gen).to(self.device)


def whatif_request(factory, n_pods: int = 256, per_group: int = 16, n_big: int = 16):
    """The [whatif] request: 16 virtual nodes of each of the autoscaler
    bench's four shapes (the planner's stable slot names), 16 live nodes
    to mask, and `n_pods` pending pods: SchedulingPodAffinity's measured
    pods, and `n_big` 12-cpu pods that only a 16- or 32-cpu virtual node
    can hold."""
    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.perf.workloads import autoscaler_candidate_shapes

    virtual = [
        g.make_node(f"whatif.{g.name}.{i}")
        for g in autoscaler_candidate_shapes() for i in range(per_group)
    ]
    masked = [f"node-{i}" for i in range(0, 16 * 97, 97)]
    pods = [factory(300000 + i) for i in range(n_pods - n_big)] + [
        v1.Pod(
            metadata=v1.ObjectMeta(name=f"whatif-big-{i}"),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": "12"})]),
        )
        for i in range(n_big)
    ]
    return virtual, masked, pods


def cluster_caches(server, device) -> dict:
    """The API server's nodes and bound pods encoded into a SchedulerCache
    on the card and one on the CPU ({"card": ..., "cpu": ...}), each
    flushed, presized to the cluster."""
    from kubernetes_tpu_torch.ops.encoding import EncodingConfig, SnapshotEncoder
    from kubernetes_tpu_torch.scheduler.cache.cache import SchedulerCache

    nodes = server.list("nodes")[0]
    pods = [p for p in server.list("pods")[0] if p.spec.node_name]

    def build(dev):
        enc = SnapshotEncoder(EncodingConfig.for_cluster(len(nodes)), device=dev)
        cache = SchedulerCache(encoder=enc)
        for n in nodes:
            cache.add_node(n)
        for p in pods:
            cache.add_pod(p)
        with cache.lock:
            enc.flush()
        return cache

    return {"card": build(device), "cpu": build(torch.device("cpu"))}


def phase_whatif(server, device, card: str, errors: ErrorLog, caches: dict) -> dict:
    """[whatif] on the [scheduler] phase's cluster (the API server's 5,000
    nodes and 6,000 bound pods; n_cap 8192, so 3,192 rows are free),
    encoded into a SchedulerCache on the card and one on the CPU. One
    overlay of 64 virtual nodes (16 of each autoscaler bench shape) and 16
    masked rows on both: every field equal, the card's live generation the
    same object and bit-identical afterwards (compared on the card), no
    overlay tensor sharing its storage. Then one WhatIfSimulator.simulate
    of 256 pending pods over that request on both, with the same tie
    noise: chosen and fallback equal. Times the overlay build (p50 of 20)
    and the card's pass; profiles one more pass (device busy, launches).
    `caches`: cluster_caches(server, device)."""
    from kubernetes_tpu_torch.autoscaler import WhatIfSimulator
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload

    errors.check("before whatif")
    nodes = server.list("nodes")[0]
    pods = [p for p in server.list("pods")[0] if p.spec.node_name]
    _n, _i, factory = build_workload(WORKLOADS["SchedulingPodAffinity/5000"])
    enc = caches["card"].encoder
    n_cap = enc.cfg.n_cap
    n_free = len(enc.free_row_indices())
    virtual, masked, pending = whatif_request(factory)
    live = enc._device
    before = [t.clone() for t in live]
    rows = [enc.row_of(m) for m in masked]
    overlays = {}
    for where, cache in caches.items():
        with cache.lock:
            overlays[where] = cache.encoder.whatif_overlay(virtual, rows)
    (snap, vrows), (cpu_snap, cpu_rows) = overlays["card"], overlays["cpu"]
    if vrows != cpu_rows or len(vrows) != len(virtual):
        raise AssertionError(f"[whatif] virtual rows {vrows[:4]}... vs CPU {cpu_rows[:4]}...")
    for f in snap._fields:
        if not torch.equal(getattr(snap, f).cpu(), getattr(cpu_snap, f)):
            raise AssertionError(f"[whatif] overlay field {f}: card != CPU")
    if enc._device is not live:
        raise AssertionError("[whatif] the overlay replaced the live generation")
    for f, b, now in zip(live._fields, before, live):
        if not torch.equal(b, now):
            raise AssertionError(f"[whatif] the overlay changed live field {f}")
    ptrs = {t.untyped_storage().data_ptr() for t in live}
    if any(t.untyped_storage().data_ptr() in ptrs for t in snap):
        raise AssertionError("[whatif] an overlay tensor shares the live generation's storage")
    del snap, cpu_snap, overlays
    build_ms = []
    for _ in range(20):
        with caches["card"].lock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ov = enc.whatif_overlay(virtual, rows)
            torch.cuda.synchronize()
            build_ms.append((time.perf_counter() - t0) * 1e3)
        del ov

    sims = {
        where: WhatIfSimulator(cache, noise=SeededNoise(7, cache.encoder.device))
        for where, cache in caches.items()
    }
    res, wall = {}, {}
    for where in ("card", "cpu"):
        t0 = time.perf_counter()
        res[where] = sims[where].simulate(pending, virtual, mask_nodes=masked)
        wall[where] = time.perf_counter() - t0
    rc, rp = res["card"], res["cpu"]
    if not (np.array_equal(rc.chosen, rp.chosen) and np.array_equal(rc.fallback, rp.fallback)):
        bad = int((rc.chosen != rp.chosen).sum())
        raise AssertionError(f"[whatif] simulate: chosen differs at {bad} pods (card vs CPU)")
    if rc.virtual_rows != rp.virtual_rows:
        raise AssertionError("[whatif] simulate: virtual rows differ")
    placed = int((rc.chosen >= 0).sum())
    on_virtual = int(np.isin(rc.chosen, list(rc.virtual_rows)).sum())
    masked_rows = {enc.row_of(m) for m in masked}
    if placed == 0 or on_virtual == 0 or masked_rows & set(rc.chosen.tolist()):
        raise AssertionError(
            f"[whatif] {placed} placed, {on_virtual} on virtual rows, or a pod on a masked row"
        )
    if enc._device is not live or any(not torch.equal(b, t) for b, t in zip(before, live)):
        raise AssertionError("[whatif] the pass changed the live generation")
    pad = sims["card"]._pad(len(pending))
    try:
        prof = profile_device(
            f"what-if pass, {len(pending)} pods (pad {pad}) over {n_cap} rows",
            lambda: sims["card"].simulate(pending, virtual, mask_nodes=masked),
        )
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] what-if pass device time not measured: {e}")
        prof = {"wall_ms": None, "busy_ms": None, "launches": None}
    out = {
        "build_p50_ms": float(np.median(build_ms)),
        "pass_s": wall["card"], "cpu_pass_s": wall["cpu"],
        "ms_per_step": wall["card"] * 1e3 / pad, "pad": pad, **prof,
    }
    busy = "not measured" if prof["busy_ms"] is None else f"{prof['busy_ms']:.3f} ms"
    log(f"[whatif] {len(nodes)} nodes, {len(pods)} pods, n_cap {n_cap} ({n_free} rows "
        f"free): overlay of {len(virtual)} virtual nodes + {len(masked)} masked rows "
        f"equal to the CPU's field by field, the live generation untouched and "
        f"sharing no storage; overlay build p50 {out['build_p50_ms']:.3f} ms; "
        f"simulate {len(pending)} pods (pad {pad}): card {wall['card']:.3f} s "
        f"({out['ms_per_step']:.3f} ms per pod step), CPU {wall['cpu']:.3f} s, chosen "
        f"and fallback equal ({placed} placed, {on_virtual} on virtual rows); "
        f"profiled pass: wall {prof['wall_ms'] and round(prof['wall_ms'], 2)} ms, "
        f"device busy {busy}, {prof['launches']} launches; card {card}")
    errors.check("whatif")
    return out


def phase_tuner(device, card: str, errors: ErrorLog) -> dict:
    """[tuner] run_tuner_benchmark() at the reference's defaults (8 nodes,
    4 rounds, the cost flip, timeout 120 s) on the card: the serial path,
    the gym replaying every recorded wave in the background. Fails unless
    every burst is bound, nothing promotes before the flip, the gym
    converges on a vector with a cost weight, the defense counters are 0
    (the harness raises otherwise) and no ERROR is logged. K1 is not on
    this path (serial lattice)."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_tuner_benchmark

    errors.check("before tuner")
    zero_k(fit_kernels)
    res = run_tuner_benchmark(device=device)
    k1, k2 = count_k(fit_kernels)
    log(f"[tuner] {res.num_nodes} nodes, {res.pre_flip_rounds} full-width rounds: "
        f"baseline {res.baseline_pods_per_s} pods/s, tuner on "
        f"{res.tuner_on_pods_per_s} pods/s (overhead {res.overhead_pct} %); "
        f"{res.bursts_bound}/{res.bursts} bursts bound; pre-flip promotions "
        f"{res.pre_flip_promotions}; converged {res.converged} in "
        f"{res.time_to_converge_s} s on {res.promoted_policy!r} (cost weight "
        f"{res.promoted_cost_weight}); {res.promotions} promotions, "
        f"{res.waves_recorded} waves recorded, {res.gym_passes} gym passes, pass "
        f"p50/p99 {res.gym_pass_p50_ms}/{res.gym_pass_p99_ms} ms; guard trips "
        f"{res.guard_trips}; K1 launches {k1}, K2 launches {k2}; card {card}")
    errors.check("tuner")
    defense_report("tuner", card, res=res)
    if res.bursts_bound != res.bursts:
        raise AssertionError(f"[tuner] {res.bursts - res.bursts_bound} bursts left pods unbound")
    if res.pre_flip_promotions:
        raise AssertionError("[tuner] a policy promoted before the flip")
    if not res.converged or res.promoted_cost_weight <= 0:
        raise AssertionError(f"[tuner] no cost-aware promotion ({res.promoted_policy!r})")
    return {"res": res, "k1": k1, "k2": k2}


class GymHost:
    """Just enough scheduler for one PolicyTuner pass over a cache: the
    cache, the default weights and configuration, a no-op policy swap."""

    def __init__(self, cache):
        from kubernetes_tpu_torch.ops.lattice import DEFAULT_WEIGHTS
        from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration

        self.cache = cache
        self.cfg = KubeSchedulerConfiguration()
        self._weights = DEFAULT_WEIGHTS.copy()
        self._score_policy_name = "default"
        self._ha_identity = "gym-0"
        self.wave_recorder = None

    def set_score_policy(self, policy):
        pass


# [gym]'s pods an arm replays, cut from 128 (PERF.md §4) so that
# the script stays inside its time limit
GYM_PODS = 64


def phase_gym(caches: dict, device, card: str, errors: ErrorLog) -> dict:
    """[gym] on the [scheduler] phase's cluster (caches: cluster_caches of
    its API server, 5,000 nodes and 6,000 bound pods, on the card and on
    the CPU). One build_overlay of GYM_PODS of SchedulingPodAffinity's pods on
    each: the host columns equal. Then four arms (the incumbent, `pack`,
    the TOPSIS arm, one perturbation) replayed on both with the same tie
    noise: every arm's chosen rows and WaveOutcome equal, and the card's
    live generation the same object and bit-identical afterwards
    (compared on the card). Times each arm on the card, profiles one, and
    times one whole PolicyTuner pass (every arm the tuner assembles) on
    the card."""
    import dataclasses

    from kubernetes_tpu_torch.ops.lattice import DEFAULT_WEIGHTS, WEIGHT_PROFILES
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.tuner import candidates as cand_gen
    from kubernetes_tpu_torch.tuner.controller import PolicyTuner
    from kubernetes_tpu_torch.tuner.policy import COUNTER_GYM_CANDIDATES
    from kubernetes_tpu_torch.tuner.scoring import (
        build_overlay, replay_candidate, score_assignment)
    from kubernetes_tpu_torch.utils.metrics import metrics

    errors.check("before gym")
    _n, _i, factory = build_workload(WORKLOADS["SchedulingPodAffinity/5000"])
    pods = [factory(400000 + i) for i in range(GYM_PODS)]
    enc = caches["card"].encoder
    live = enc._device
    before = [t.clone() for t in live]

    def check_live(what):
        if enc._device is not live or any(not torch.equal(b, t) for b, t in zip(before, live)):
            raise AssertionError(f"[gym] {what} changed the live generation")

    ovs = {where: build_overlay(cache, pods) for where, cache in caches.items()}
    ov, cpu_ov = ovs["card"], ovs["cpu"]
    for f in ("pod_valid", "req", "node_valid", "free0", "alloc", "cost_milli",
              "energy_milli", "accel_class"):
        if not np.array_equal(getattr(ov, f), getattr(cpu_ov, f)):
            raise AssertionError(f"[gym] overlay column {f}: card != CPU")
    if ov.row_names != cpu_ov.row_names or not ov.pod_valid.any():
        raise AssertionError("[gym] overlay rows differ or no pod encoded")
    p, n = ov.req.shape[0], ov.node_valid.shape[0]
    noise = torch.rand((p, n), generator=torch.Generator().manual_seed(7))
    arms = [
        ("incumbent", DEFAULT_WEIGHTS.copy()),
        ("pack", WEIGHT_PROFILES["pack"].copy()),
        ("topsis", cand_gen.topsis_candidates(
            ov.alloc - ov.free0, ov.alloc, ov.node_valid, ov.cost_milli,
            ov.energy_milli)[0]),
        ("perturb", cand_gen.perturbation_candidates(
            DEFAULT_WEIGHTS, np.random.default_rng(7), 1)[0]),
    ]
    walls, placed, cpu_s = {}, {}, 0.0
    for name, vec in arms:
        got = {}
        for where, o in (("card", ov), ("cpu", cpu_ov)):
            t0 = time.perf_counter()
            got[where] = replay_candidate(o, vec, noise.to(o.snap.valid.device), 1.0)
            if where == "card":
                walls[name] = time.perf_counter() - t0
            else:
                cpu_s += time.perf_counter() - t0
        if not np.array_equal(got["card"], got["cpu"]):
            bad = int((got["card"] != got["cpu"]).sum())
            raise AssertionError(f"[gym] arm {name}: chosen differs at {bad} pods (card vs CPU)")
        a, b = score_assignment(ov, got["card"]), score_assignment(cpu_ov, got["cpu"])
        if dataclasses.astuple(a) != dataclasses.astuple(b):
            raise AssertionError(f"[gym] arm {name}: outcome {a} != CPU {b}")
        placed[name] = a.placed
    check_live("the replays")
    card_noise = noise.to(device)
    try:
        prof = profile_device(
            f"gym arm, {p} pods over {n} rows",
            lambda: replay_candidate(ov, DEFAULT_WEIGHTS, card_noise, 1.0),
        )
    except (RuntimeError, AttributeError) as e:  # measurement only
        log(f"[profile] gym arm device time not measured: {e}")
        prof = {"wall_ms": None, "busy_ms": None, "launches": None}
    # one whole gym pass on the card: every arm the tuner assembles
    tuner = PolicyTuner(GymHost(caches["card"]), None, seed=7)
    tuner.ring.record_wave(pods, DEFAULT_WEIGHTS, [""] * len(pods))

    def n_arms():
        return sum(v for _n, _l, v in metrics.snapshot_counters(COUNTER_GYM_CANDIDATES))

    arms0 = n_arms()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tuner.tick()
    torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    pass_arms = int(n_arms() - arms0)
    check_live("the gym pass")
    steps = pass_arms * p
    out = {
        "arm_s": walls, "cpu_arms_s": cpu_s, "pass_s": pass_s, "pass_arms": pass_arms,
        "ms_per_step": pass_s * 1e3 / max(steps, 1), "pad": p, **prof,
        "pass_launches_est": (
            None if prof["launches"] is None else prof["launches"] * pass_arms
        ),
    }
    busy = "not measured" if prof["busy_ms"] is None else f"{prof['busy_ms']:.3f} ms"
    log(f"[gym] {n} rows, {p} pods (overlay host columns equal to the CPU's): arms "
        + ", ".join(f"{k} {walls[k]:.3f} s ({walls[k] * 1e3 / p:.3f} ms per pod step, "
                    f"{placed[k]} placed)" for k, _v in arms)
        + f"; the CPU's four arms {cpu_s:.3f} s; chosen rows and outcomes equal "
        f"card vs CPU, the live generation "
        f"untouched; profiled arm: wall {prof['wall_ms'] and round(prof['wall_ms'], 2)} "
        f"ms, device busy {busy}, {prof['launches']} launches; one PolicyTuner pass: "
        f"{pass_arms} arms in {pass_s:.3f} s ({out['ms_per_step']:.3f} ms per pod "
        f"step, ~{out['pass_launches_est']} launches); card {card}")
    errors.check("gym")
    return out


def phase_cmd(device, card: str, errors: ErrorLog,
              workload: str = "SchedulingPodAffinity/5000") -> dict:
    """[cmd] the scheduler process's entry point on the card:
    cmd.scheduler.run(server, KubeSchedulerConfiguration(tune_policy=True),
    block=False) from the main thread (the cache debugger's SIGUSR2
    handler needs it), its health endpoints on a free port, then
    SchedulingPodAffinity/5000's nodes, initial pods and measured pods
    created through the server. Fails unless every pod is bound once with
    requested <= allocatable (from the API server's bindings), /healthz,
    /readyz and /metrics answer 200, the cache debugger's dump holds the
    policy-gym section, the gym made a pass after the burst (on the
    5,000-node snapshot), K1 was launched, the defense counters are 0 and
    no ERROR is logged. Tears down the tuner, then sched.stop(), which
    stops the run()-owned Cacher."""
    import socket
    import urllib.request

    from kubernetes_tpu_torch.cmd import scheduler as cmd_scheduler
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.scheduler import KubeSchedulerConfiguration
    from kubernetes_tpu_torch.scheduler.cache.debugger import CacheDebugger
    from kubernetes_tpu_torch.tuner.policy import COUNTER_GYM_PASSES, HIST_GYM_PASS_SECONDS
    from kubernetes_tpu_torch.utils.metrics import metrics

    errors.check("before cmd")
    wl = WORKLOADS[workload]
    nodes, init, factory = build_workload(wl)
    server = ledger_server()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    metrics.reset()
    zero_k(fit_kernels)
    sched = cmd_scheduler.run(
        server, KubeSchedulerConfiguration(tune_policy=True), healthz_port=port,
        block=False,
    )
    tuner = sched._tuner
    try:
        if sched.device.type != device.type or tuner is None:
            raise AssertionError("[cmd] run() did not start on the card with the gym")

        def bound():
            return server.count("pods", lambda p: bool(p.spec.node_name))

        def wait_bound(count, what):
            deadline = time.monotonic() + 300
            while bound() < count:
                if time.monotonic() > deadline:
                    raise AssertionError(f"[cmd] {bound()}/{count} bound ({what})")
                time.sleep(0.05)

        t0 = time.monotonic()
        for nd in nodes:
            server.create("nodes", nd)
        for p in init:
            server.create("pods", p)
        wait_bound(len(init), "initial pods")
        setup_s = time.monotonic() - t0
        measured = [factory(i) for i in range(wl.num_measured_pods)]
        t0 = time.monotonic()
        for p in measured:
            server.create("pods", p)
        wait_bound(len(init) + len(measured), "measured pods")
        burst_s = time.monotonic() - t0
        passes_at_bound = metrics.counter(COUNTER_GYM_PASSES)
        deadline = time.monotonic() + 120
        while metrics.counter(COUNTER_GYM_PASSES) <= passes_at_bound:
            if time.monotonic() > deadline:
                raise AssertionError(f"[cmd] the gym made no pass on the {len(nodes)}-node snapshot")
            time.sleep(0.1)
        codes = {}
        for path in ("/healthz", "/readyz", "/metrics"):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                codes[path] = r.status
        dump = CacheDebugger(sched).dump()
    finally:
        if tuner is not None:
            # a pass in flight finishes before the Scheduler stops
            thread = tuner._thread
            tuner.stop()
            if thread is not None:
                thread.join(timeout=120)
        sched.stop()
    k1, k2 = count_k(fit_kernels)
    passes = int(metrics.counter(COUNTER_GYM_PASSES))
    h = metrics.histogram(HIST_GYM_PASS_SECONDS)
    p50, p99 = h.quantiles([0.5, 0.99]) if h is not None else (0.0, 0.0)
    waves = len(tuner.ring)
    rate = len(measured) / burst_s
    log(f"[cmd] cmd.scheduler.run(tune_policy=True) on the card, "
        f"{workload} created through the server: {len(init)} "
        f"initial pods bound in {setup_s:.3f} s (nodes included), "
        f"{len(measured)} measured pods in {burst_s:.3f} s = {rate:.1f} pods/s with "
        f"the gym on; {passes} gym passes, pass p50/p99 {p50 * 1e3:.1f}/"
        f"{p99 * 1e3:.1f} ms; {waves} waves in the ring; HTTP {codes}; K1 launches "
        f"{k1}, K2 launches {k2}; card {card}")
    errors.check("cmd")
    defense_report("cmd", card, sched=sched)
    trips = sum(v for _n, _l, v in metrics.snapshot_counters("kernel_guard_trips_total"))
    if trips:
        raise AssertionError(f"[cmd] {trips} kernel guard trips")
    if any(c != 200 for c in codes.values()):
        raise AssertionError(f"[cmd] health endpoints answered {codes}")
    if "Dump of policy-gym (self-tuning scheduler) state:" not in dump:
        raise AssertionError("[cmd] the cache debugger's dump has no policy-gym section")
    if not sched._owned_read_cache._stop.is_set():
        raise AssertionError("[cmd] sched.stop() left the run()-owned Cacher running")
    if k1 <= 0:
        raise AssertionError("[cmd] the Scheduler never launched K1")
    check_capacity(server, "cmd")
    if len(server.applied) != len(init) + len(measured) or any(
        c != 1 for c in server.applied.values()
    ):
        raise AssertionError("[cmd] a pod was not bound exactly once")
    log(f"[cmd] checked from the API server: {len(init) + len(measured)} pods bound "
        f"once, requested <= allocatable on all {len(nodes)} nodes")
    return {"rate": rate, "passes": passes, "pass_p50_ms": p50 * 1e3, "k1": k1, "k2": k2}


# [autoscaler]'s pending pods, cut from bench.py's 1,000 (its burst took
# 62.2 s, PERF.md §5; then 500) so that the script, [soak]
# and [ha] included, stays inside its time limit
AUTOSCALER_PODS = 250

# [hetero]'s pending pods, cut from 300 (PERF.md §4) for the
# same limit
HETERO_PODS = 150


def phase_autoscaler(device, card: str, errors: ErrorLog) -> dict:
    """[autoscaler] run_autoscaler_benchmark(n_pods=AUTOSCALER_PODS):
    bench.py's Autoscaler/1k-pending-4-shapes at half its pods, 500
    pending 500m pods against an empty cluster and the four-shape catalog.
    Fails unless every pod is bound (checked from the API server, each pod bound once), every node
    comes from the catalog, no ERROR is logged, guard trips, drift rows,
    rebuilds and device-down are 0 (the harness raises otherwise), and K1
    was launched."""
    from kubernetes_tpu_torch.autoscaler import NodeGroupCatalog
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_autoscaler_benchmark
    from kubernetes_tpu_torch.perf.workloads import autoscaler_candidate_shapes

    errors.check("before autoscaler")
    server = ledger_server()
    zero_k(fit_kernels)
    res = run_autoscaler_benchmark(n_pods=AUTOSCALER_PODS, device=device, server=server)
    k1, k2 = count_k(fit_kernels)
    log(f"[autoscaler] {AUTOSCALER_PODS} pending 500m pods, 4 shapes: {res.scheduled}/{res.num_pods} "
        f"bound in {res.time_to_all_bound_s:.3f} s; {res.nodes_provisioned} nodes "
        f"{json.dumps(res.nodes_by_group, sort_keys=True)}; {res.simulation_passes} "
        f"simulation passes, p50/p99 {res.simulation_p50_ms:.1f}/"
        f"{res.simulation_p99_ms:.1f} ms; guard trips {res.guard_trips}, unwound "
        f"assumes {res.unwound_assumes}; K1 launches {k1}, K2 launches {k2}; card {card}")
    errors.check("autoscaler")
    defense_report("autoscaler", card, res=res)
    if res.scheduled != res.num_pods or res.guard_trips:
        raise AssertionError(f"[autoscaler] {res.scheduled}/{res.num_pods} bound")
    nodes, _pods = check_capacity(server, "autoscaler")
    catalog = NodeGroupCatalog(autoscaler_candidate_shapes())
    stray = [n.metadata.name for n in nodes if catalog.group_of_node(n) is None]
    if stray or len(nodes) != res.nodes_provisioned:
        raise AssertionError(f"[autoscaler] nodes outside the catalog: {stray[:3]}")
    if any(c != 1 for c in server.applied.values()):
        raise AssertionError("[autoscaler] a pod was bound more than once")
    if k1 <= 0:
        raise AssertionError("[autoscaler] the Scheduler never launched K1")
    log(f"[autoscaler] checked from the API server: {res.num_pods} pods bound once, "
        f"requested <= allocatable on all {len(nodes)} nodes, every node from the catalog")
    return {"res": res, "k1": k1, "k2": k2}


def phase_hetero(device, card: str, errors: ErrorLog) -> dict:
    """[hetero] run_hetero_benchmark(n_pods=HETERO_PODS): the same pending
    burst autoscaled cost-aware and cost-blind on the mixed-cost catalog.
    Fails unless both arms bind every pod and the cost-aware fleet is
    strictly cheaper, with no ERROR logged."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_hetero_benchmark

    errors.check("before hetero")
    zero_k(fit_kernels)
    res = run_hetero_benchmark(n_pods=HETERO_PODS, device=device)
    k1, k2 = count_k(fit_kernels)
    log(f"[hetero] {res.num_pods} pods, {res.num_shapes} shapes: cost-aware "
        f"{res.cost_aware_scheduled} bound, ${res.cost_aware_fleet_per_hour}/h "
        f"{json.dumps(res.cost_aware_nodes, sort_keys=True)} in {res.cost_aware_time_s} s; "
        f"cost-blind {res.blind_scheduled} bound, ${res.blind_fleet_per_hour}/h "
        f"{json.dumps(res.blind_nodes, sort_keys=True)} in {res.blind_time_s} s; "
        f"strictly cheaper {res.strictly_cheaper}; guard trips {res.guard_trips}; "
        f"K1 launches {k1}, K2 launches {k2}; card {card}")
    errors.check("hetero")
    defense_report("hetero", card, res=res)
    if res.cost_aware_scheduled != res.num_pods or res.blind_scheduled != res.num_pods:
        raise AssertionError("[hetero] an arm left pods unbound")
    if not res.strictly_cheaper:
        raise AssertionError("[hetero] the cost-aware fleet is not strictly cheaper")
    if k1 <= 0:
        raise AssertionError("[hetero] the Schedulers never launched K1")
    return {"res": res, "k1": k1, "k2": k2}


def phase_defrag(device, card: str, errors: ErrorLog) -> dict:
    """[defrag] run_defrag_benchmark() at its defaults (8 nodes, 32 pods
    under a ReplicaSet, half the nodes nearly empty). Fails unless every
    replica is bound after, the fleet is strictly tighter (fewer nodes, a
    lower bill), every plan abort is a drift abort whose cordons were
    rolled back, and no ERROR is logged. Prints aborts and rejections by
    reason."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_defrag_benchmark

    from kubernetes_tpu_torch.utils.metrics import metrics

    def by_reason(name):
        out = {}
        for _n, labels, v in metrics.snapshot_counters(name):
            out[labels.get("reason", "")] = out.get(labels.get("reason", ""), 0) + int(v)
        return out

    errors.check("before defrag")
    zero_k(fit_kernels)
    res = run_defrag_benchmark(device=device)
    k1, k2 = count_k(fit_kernels)
    aborts = by_reason("descheduler_plan_aborts_total")
    uncordons = int(metrics.counter("descheduler_rollback_uncordons_total"))
    log(f"[defrag] {res.num_pods} pods: nodes {res.nodes_before} -> {res.nodes_after}, "
        f"${res.fleet_per_hour_before}/h -> ${res.fleet_per_hour_after}/h, "
        f"fragmentation {res.fragmentation_before} -> {res.fragmentation_after}; "
        f"{res.plans} plans, {res.evictions} evictions, {res.aborts} aborts "
        f"{json.dumps(aborts, sort_keys=True)}, rejections "
        f"{json.dumps(by_reason('descheduler_plan_rejected_total'), sort_keys=True)}, "
        f"rollback uncordons {uncordons}; "
        f"{res.bound_after} bound after; quiesced in {res.time_to_quiesce_s} s; "
        f"strictly tighter {res.strictly_tighter}; K1 launches {k1}, K2 launches "
        f"{k2}; card {card}")
    errors.check("defrag")
    defense_report("defrag", card, res=res)
    if res.bound_after != res.num_pods or not res.strictly_tighter:
        raise AssertionError("[defrag] not every replica bound, or not strictly tighter")
    # an abort is the executor refusing a plan whose proof went stale; the
    # only one this run can meet is drift (a replacement pod bound onto a
    # planned node before the scheduler saw its cordon), rolled back
    if set(aborts) - {"drift"} or (res.aborts and uncordons < res.aborts):
        raise AssertionError(f"[defrag] aborts {aborts} not rolled-back drift aborts")
    if k1 <= 0:
        raise AssertionError("[defrag] the Scheduler never launched K1")
    return {"res": res, "k1": k1, "k2": k2}


def phase_hardpair(device, card: str, errors: ErrorLog) -> dict:
    """[hardpair] SchedulingPodAntiAffinity/5000 (5,000 nodes, 1,000
    initial pods, 4,000 measured pods with required hostname
    anti-affinity among app=bench) through run_benchmark: the hard-pair
    path. The gate of [scheduler]: all bound, bindings checked from the
    API server (capacity, and no node holding two measured pods), 0 guard
    trips, no ERROR logged, K1 launched. Prints the waves of every
    launched batch."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.scheduler import scheduler as sched_mod

    errors.check("before hardpair")
    wl = WORKLOADS["SchedulingPodAntiAffinity/5000"]
    server = ledger_server()
    waves = []
    real = sched_mod.make_wave_kernel

    def recorded(*variant):
        waves.append(variant[2])
        return real(*variant)

    zero_k(fit_kernels)
    sched_mod.make_wave_kernel = recorded
    try:
        res = run_benchmark(wl, device=device, server=server, timeout_s=300)
    finally:
        sched_mod.make_wave_kernel = real
    k1, k2 = count_k(fit_kernels)
    log(f"[hardpair] SchedulingPodAntiAffinity/5000 through APIServer + Scheduler: "
        f"{res.scheduled}/{res.num_measured_pods} bound in {res.duration_s:.3f} s = "
        f"{res.throughput_pods_per_s:.1f} pods/s; e2e p50/p99 {res.e2e_p50_ms:.1f}/"
        f"{res.e2e_p99_ms:.1f} ms; {res.n_batches} measured batches; waves per "
        f"launched batch {waves}; guard trips {res.guard_trips}, unwound assumes "
        f"{res.unwound_assumes}; K1 launches {k1}, K2 launches {k2}; card {card}")
    errors.check("hardpair")
    defense_report("hardpair", card, res=res)
    if res.scheduled != res.num_measured_pods or res.unscheduled:
        raise AssertionError(f"[hardpair] {res.unscheduled} measured pods not bound")
    if res.guard_trips or res.unwound_assumes:
        raise AssertionError(f"[hardpair] {res.guard_trips} guard trips")
    if k1 <= 0:
        raise AssertionError("[hardpair] the Scheduler never launched K1")
    _nodes, pods = check_capacity(server, "hardpair")
    hosts = [p.spec.node_name for p in pods if p.metadata.name.startswith("pod-")]
    if len(hosts) != wl.num_measured_pods or len(set(hosts)) != len(hosts):
        raise AssertionError("[hardpair] two measured pods share a node (anti-affinity)")
    if any(c != 1 for c in server.applied.values()):
        raise AssertionError("[hardpair] a pod was bound more than once")
    log(f"[hardpair] checked from the API server: {len(pods)} pods bound once, "
        f"requested <= allocatable everywhere, the {len(hosts)} measured pods on "
        f"{len(set(hosts))} distinct nodes")
    return {"res": res, "k1": k1, "k2": k2, "waves": waves}


# [suite]: every scheduling workload of perf/workloads.py that the other
# phases do not drive, at its defined size, in this order (Gang first)
SUITE = (
    "Gang/5000",
    "TopologySpreading/5000",
    "SchedulingBasic/5000",
    "SchedulingNodeAffinity/5000",
    "SchedulingPreferredPodAffinity/5000",
    "SchedulingSecrets/5000",
    "SchedulingDensity/1000",
    "SchedulingInTreePVs/500",
)
# workloads whose measured pods the encoder sends to the host lane
HOST_LANE = ("SchedulingInTreePVs",)
GCE_PD_LIMIT = 16  # non_csi.go: default max GCE PD volumes a node attaches
ZONE = "topology.kubernetes.io/zone"


class RunCounts:
    """Counts, while installed, the pods whose Permit returned WAIT (parked
    in the waiting-pods map), the waits that ended in the permit timeout
    or in a reject, and the pods the Scheduler requeued through backoff
    (an all-deferred wave batch's stall breaker among them), by wrapping
    the framework's two Permit entry points and the queue's
    requeue_backoff; and lists each wave batch the Scheduler commits as
    (pods, placed), in commit order, by wrapping Scheduler._commit_batch."""

    def __init__(self):
        from kubernetes_tpu_torch.scheduler import scheduler
        from kubernetes_tpu_torch.scheduler.framework import runtime
        from kubernetes_tpu_torch.scheduler.queue import scheduling_queue

        self.fw = runtime.Framework
        self.queue = scheduling_queue.PriorityQueue
        self.sched = scheduler.Scheduler
        self.waits = self.timeouts = self.rejects = self.backoffs = 0
        self.batches = []
        self._lock = threading.Lock()
        self._real = (self.fw.run_permit_plugins, self.fw.wait_on_permit,
                      self.queue.requeue_backoff, self.sched._commit_batch)

    def _add(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def __enter__(self):
        from kubernetes_tpu_torch.scheduler.framework.interface import Code

        run_permit, wait_on, requeue_backoff, commit_batch = self._real
        count = self

        def run_permit_plugins(fw, state, pod, node_name):
            st = run_permit(fw, state, pod, node_name)
            if st is not None and st.code == Code.WAIT:
                count._add("waits")
            return st

        def wait_on_permit(fw, pod):
            st = wait_on(fw, pod)
            if st is not None and st.code != Code.SUCCESS:
                count._add("timeouts" if "timeout" in st.message else "rejects")
            return st

        def backoff(queue, pi):
            count._add("backoffs")
            return requeue_backoff(queue, pi)

        def commit(sched, p, arrays, *rest):
            placed = np.asarray(arrays[1])[: len(p.pis)]
            with count._lock:
                count.batches.append((len(p.pis), int(placed.sum())))
            return commit_batch(sched, p, arrays, *rest)

        self.fw.run_permit_plugins = run_permit_plugins
        self.fw.wait_on_permit = wait_on_permit
        self.queue.requeue_backoff = backoff
        self.sched._commit_batch = commit
        return self

    def __exit__(self, *exc):
        (self.fw.run_permit_plugins, self.fw.wait_on_permit,
         self.queue.requeue_backoff, self.sched._commit_batch) = self._real


def check_suite_placements(server, wl, what: str) -> str:
    """The placement check of one [suite] workload, from the API server's
    objects and the workload's own spec: every pod bound exactly once and
    requested <= allocatable on every node; then the workload's own rule.
    Returns what it checked, for the log."""
    from collections import Counter, defaultdict

    from kubernetes_tpu_torch.scheduler.framework.plugins.coscheduling import (
        GROUP_LABEL, MIN_MEMBER_ANNOTATION,
    )

    nodes, pods = check_capacity(server, what)
    if len(pods) != wl.num_measured_pods + wl.num_init_pods:
        raise AssertionError(f"[{what}] {len(pods)} pods in the API server")
    once = Counter(server.applied.values())
    if set(once) != {1} or sum(once.values()) != len(pods):
        raise AssertionError(f"[{what}] binds per pod {dict(once)} for {len(pods)} pods")
    zone_of = {n.metadata.name: n.metadata.labels.get(ZONE) for n in nodes}
    measured = [p for p in pods if p.metadata.name.startswith("pod-")]
    if len(measured) != wl.num_measured_pods:
        raise AssertionError(f"[{what}] {len(measured)} measured pods")
    done = f"{len(pods)} pods bound once, requested <= allocatable on all {len(nodes)} nodes"
    if wl.name == "Gang":
        # each gang and its quorum as its pods state them: the group label
        # and the min-member annotation
        members = defaultdict(list)
        quorum = {}
        for p in measured:
            g = p.metadata.labels[GROUP_LABEL]
            members[g].append(bool(p.spec.node_name))
            quorum.setdefault(g, set()).add(int(p.metadata.annotations[MIN_MEMBER_ANNOTATION]))
        partial = [g for g, b in members.items() if any(b) and not all(b)]
        whole = [g for g, b in members.items()
                 if all(b) and len(quorum[g]) == 1 and len(b) >= min(quorum[g])]
        if partial or len(whole) != len(members):
            raise AssertionError(
                f"[{what}] {len(whole)} of {len(members)} gangs wholly bound with their "
                f"min-member, {len(partial)} partly bound (e.g. {partial[:3]})")
        sizes = sorted(Counter(len(b) for b in members.values()).items())
        mins = sorted(Counter(min(q) for q in quorum.values()).items())
        return (f"{done}; {len(whole)} gangs wholly bound (members: count {sizes}; "
                f"min-member: count {mins}), 0 partly bound")
    if wl.name == "TopologySpreading":
        per_zone = Counter(zone_of[p.spec.node_name] for p in pods
                           if p.metadata.labels.get("app") == "bench")
        counts = [per_zone.get(z, 0) for z in sorted(set(zone_of.values()))]
        skew = max(counts) - min(counts)
        if skew > 1:
            raise AssertionError(f"[{what}] app=bench pods per zone {counts}: skew {skew} > maxSkew 1")
        return f"{done}; app=bench pods per zone {counts}, skew {skew} <= maxSkew 1"
    if wl.name == "SchedulingNodeAffinity":
        allowed = {f"zone-{z}" for z in range(wl.zones // 2)}
        stray = [p.metadata.name for p in measured if zone_of[p.spec.node_name] not in allowed]
        if stray:
            raise AssertionError(f"[{what}] {len(stray)} measured pods outside {sorted(allowed)}")
        return f"{done}; every measured pod in {sorted(allowed)}"
    if wl.name == "SchedulingInTreePVs":
        disks = defaultdict(set)
        users = Counter()
        for p in pods:
            for v in p.spec.volumes:
                if v.gce_persistent_disk is not None:
                    disks[p.spec.node_name].add(v.gce_persistent_disk.pd_name)
                    users[v.gce_persistent_disk.pd_name] += 1
        most = max((len(d) for d in disks.values()), default=0)
        if most > GCE_PD_LIMIT or set(users.values()) != {1} or len(users) != wl.num_measured_pods:
            raise AssertionError(
                f"[{what}] most GCE PDs on a node {most} (limit {GCE_PD_LIMIT}); "
                f"pods per disk {dict(Counter(users.values()))}")
        return (f"{done}; {len(users)} disks each on one pod, at most {most} on a "
                f"node (GCE PD limit {GCE_PD_LIMIT})")
    if wl.name == "SchedulingPreferredPodAffinity":
        bench = Counter(zone_of[p.spec.node_name] for p in pods
                        if p.metadata.labels.get("app") == "bench")
        with_peer = sum(1 for p in measured if bench[zone_of[p.spec.node_name]] > 1)
        hosts = Counter(p.spec.node_name for p in measured)
        return (f"{done}; preferred (no hard check): {with_peer / len(measured):.4f} of the "
                f"measured pods in a zone holding another app=bench pod, on "
                f"{len(hosts)} distinct nodes")
    return done


def suite_config(wl):
    """The Scheduler configuration a [suite] workload runs under: the
    coscheduling profile for Gang (as bench.py builds it), else the
    reference's defaults."""
    from kubernetes_tpu_torch.scheduler.config import KubeSchedulerConfiguration, ProfileConfig
    from kubernetes_tpu_torch.scheduler.framework.registry import coscheduling_plugin_set

    if wl.name == "Gang":
        return KubeSchedulerConfiguration(
            profiles=[ProfileConfig(plugin_set=coscheduling_plugin_set())]
        )
    return None


def phase_suite(device, card: str, errors: ErrorLog, seed: int) -> dict:
    """[suite]: each workload through run_benchmark on `device` (the
    APIServer, informers, queue and Scheduler, split-phase readback,
    assume and bind), the gate of [scheduler] (all bound, 0 guard trips
    and unwound assumes, no ERROR, the defense counters 0, K1 launched),
    its placements checked from the API server (check_suite_placements)
    and, for Gang, 0 Permit timeouts; then one fresh measured batch of
    the same workload through main_path's wave path, held card against
    CPU (hold_batch). One line per workload; returns the K1 and K2
    launches of the Scheduler runs together."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.harness import run_benchmark
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS
    from kubernetes_tpu_torch.utils.metrics import metrics

    errors.check("before suite")
    total = {"k1": 0, "k2": 0}
    rows = []
    for name in SUITE:
        wl = WORKLOADS[name]
        what = f"suite {name}"
        server = ledger_server()
        t0 = time.perf_counter()
        zero_k(fit_kernels)
        with RunCounts() as counts:
            res = run_benchmark(
                wl, sched_config=suite_config(wl), device=device, server=server,
                timeout_s=600.0 if wl.name == "Gang" else 300.0,  # bench.py's for Gang
            )
        k1, k2 = count_k(fit_kernels)
        total["k1"] += k1
        total["k2"] += k2
        run_s = time.perf_counter() - t0
        blocking = metrics.counter("scheduler_wave_readbacks_blocking_total")
        gang = (f"; Permit waits {counts.waits}, timeouts {counts.timeouts}, "
                f"rejects {counts.rejects}") if wl.name == "Gang" else ""
        placed = [n for _pods, n in counts.batches]
        log(f"[suite] {name}: {res.scheduled}/{res.num_measured_pods} bound in "
            f"{res.duration_s:.3f} s = {res.throughput_pods_per_s:.1f} pods/s; e2e "
            f"p50/p99 {res.e2e_p50_ms:.1f}/{res.e2e_p99_ms:.1f} ms; {res.n_batches} "
            f"batches; K1 launches {k1}, K2 launches {k2}; blocking readbacks "
            f"{blocking:.0f} = {blocking / max(res.n_batches, 1):.3f} per batch; guard "
            f"trips {res.guard_trips}, unwound assumes {res.unwound_assumes}; pod "
            f"creation {res.create_s:.3f} s; pods requeued to backoff "
            f"{counts.backoffs}{gang}; {run_s:.1f} s with node creation; "
            f"(pods, placed) of the first committed batches {counts.batches[:8]}, "
            f"placed per batch median {float(np.median(placed)) if placed else 0.0:.1f}; "
            f"card {card}")
        errors.check(what)
        defense_report(what, card, res=res)
        if res.scheduled != res.num_measured_pods or res.unscheduled:
            raise AssertionError(f"[{what}] {res.unscheduled} measured pods not bound")
        if res.guard_trips or res.unwound_assumes:
            raise AssertionError(f"[{what}] {res.guard_trips} guard trips, "
                                 f"{res.unwound_assumes} unwound assumes")
        if k1 <= 0 and device.type == "cuda":  # the CPU runs K1's plain version
            raise AssertionError(f"[{what}] the Scheduler never launched K1")
        if wl.name == "Gang" and (counts.timeouts or not counts.waits):
            raise AssertionError(f"[{what}] {counts.timeouts} Permit timeouts, "
                                 f"{counts.waits} Permit waits")
        log(f"[suite] {name} checked from the API server: "
            f"{check_suite_placements(server, wl, what)}")
        del server

        mp = main_path(device, seed, name)
        h = hold_batch(mp, device, what)
        # a batch whose every pod goes to the host lane places nothing on
        # either side: its hold covers only that routing
        routing = (" (no pod placed on either side: the hold covers only the "
                   "routing to the host lane)") if h["placed"] == 0 and h["host_lane"] else ""
        log(f"[suite] {name}: one fresh batch of {h['pods']} measured pods, "
            f"{h['n_waves']} waves ({h['placed']} placed on the device, "
            f"{h['host_lane']} sent to the host lane): K1 == plain fit, every "
            f"WaveResult field and the snapshot equal; the CPU run ({h['cpu_s']:.2f} s) "
            f"agrees with the card ({h['ties']} near-tie chosen differences){routing}; "
            f"the wave path placed {mp['placed']}/{wl.num_measured_pods} "
            f"({mp['host_lane']} to the host lane) in {mp['wall_s']:.3f} s")
        del mp, h
        gc.collect()
        rows.append(f"{name} {res.throughput_pods_per_s:.1f} pods/s" + (
            " (held batch: host-lane routing only)" if routing else ""))
    log(f"[suite] {len(rows)} workloads bound and checked: " + ", ".join(rows)
        + f"; card {card}")
    return total


SOAK_NODES = 10  # scripts/repro_mismatch.py's default: 1,100 pods of capacity
SOAK_MINUTES = 2.5  # of churn: at ~9 pods/s net the backlog passes capacity


def phase_soak(device, card: str, errors: ErrorLog, seed: int) -> dict:
    """[soak]: perf/soak.run_soak on `device` at SOAK_NODES nodes for
    SOAK_MINUTES of churn, its checks (the reference's, pending > 0 so the
    refill probe ran, (a) and (b), the defense counters 0, K1 launched, no
    ERROR); returns the K1 and K2 launches of the run."""
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.soak import peak_sample, run_soak, sample_at

    errors.check("before soak")
    zero_k(fit_kernels)
    t0 = time.perf_counter()
    res = run_soak(SOAK_MINUTES, n_nodes=SOAK_NODES, device=device, seed=seed)
    k1, k2 = count_k(fit_kernels)
    run_s = time.perf_counter() - t0
    churn_end = next((s for s in res.samples if s["phase"] == "churn-end"), None)
    log(f"[soak] {res.line()}")
    log(f"[soak] {SOAK_NODES} nodes, {res.churn_s:.1f} s of churn, {run_s:.1f} s in all; "
        f"samples at 2 minutes {json.dumps(sample_at(res.samples, 120.0), sort_keys=True)}, "
        f"at the end of the churn {json.dumps(churn_end, sort_keys=True)}, at the peak "
        f"{json.dumps(peak_sample(res.samples), sort_keys=True)}; memory_steady "
        f"{res.memory_steady}, retiring_clear {res.retiring_clear}; audits "
        f"{json.dumps(res.audits)}; defense {json.dumps(res.defense, sort_keys=True)}; "
        f"K1 launches {k1}, K2 launches {k2}; card {card}")
    errors.check("soak")
    if not res.ok:
        raise AssertionError("[soak] SOAK FAIL")
    if res.pending <= 0:
        raise AssertionError("[soak] the backlog never passed capacity: the refill probe did not run")
    if res.memory_steady is not True or not res.retiring_clear:
        raise AssertionError(f"[soak] memory_steady {res.memory_steady}, "
                             f"retiring_clear {res.retiring_clear}")
    if res.defense["drift_rows"] or res.defense["rebuilds"] or res.defense["device_down"]:
        raise AssertionError("[soak] drift, a rebuild or the device latched down")
    if k1 <= 0:
        raise AssertionError("[soak] the Scheduler never launched K1")
    return {"k1": k1, "k2": k2}


# the control-plane phases' cluster and their rigs
# The control-plane phases' workload, cut from SchedulingPodAffinity/5000
# (5,000 nodes, 1,000 initial and 5,000 measured pods: 250-330 s of
# [kubeadm] and [failover] on an H100 host, PERF.md section 4) so that
# the script, [suite] and [soak] included, stays inside its time limit
KUBEADM_WORKLOAD = "SchedulingPodAffinity/500"
KUBEADM_WORKERS = 3  # nodes joined over the bootstrap token
KUBEADM_DEPLOYMENT = 100  # replicas of the Deployment applied through kubectl
FAILOVER_PODS = 1000  # pods created through the promoted plane
STANDBY_LEASE_S = 2.0  # kubeadm standby's default --lease-seconds
CREATE_THREADS = 8  # concurrent admin clients creating objects
# The reference's node IPAM controller allocates /24 pod CIDRs from
# 10.244.0.0/16, so it has 256 to give: past that it logs this ERROR once
# per node. kubeadm runs it with its defaults, so at 500 nodes the
# ERROR is the reference's behaviour; the phases count it.
CIDR_EXHAUSTED = "cluster CIDR 10.244.0.0/16 exhausted"
# The replication layer's WARNINGs that mean the follower left the sync
# set: kubeadm's listener runs in legacy two-node mode, which acks a write
# without a follower that missed the 0.75 s ack deadline; the follower
# then resyncs from a full snapshot and may not promote until it has. The
# phases count them; [failover] requires the follower back in the sync set
# before the stop.
SYNC_SET_EXITS = ("ejecting follower", "dropping follower", "ejected from sync set")


# The controllers that read the whole store under its lock, again and
# again: attachdetach lists every pod on every pod, node or PVC event;
# nodelifecycle lists every node, lease and pod each second;
# garbagecollector lists every kind every 2 s; podgc counts every pod on
# each pod event. At 5,003 nodes and 6,100 pods they held the store's
# lock and the interpreter most of the time: with all but attachdetach
# on, the 5,000 measured pods took 852 s to bind (5.9 pods/s, create p99
# 5.0 s). The workload mounts no volume and no node goes away; the
# Deployment's ReplicaSet and pods carry owner references, but nothing is
# deleted, so the garbage collector would find nothing to collect. The
# phases leave them out: they do not run kubeadm's default controller set.
SCANNING_CONTROLLERS = ("attachdetach", "nodelifecycle", "garbagecollector", "podgc")


def kubeadm_controllers() -> list:
    """Every controller of the controller manager but SCANNING_CONTROLLERS."""
    from kubernetes_tpu_torch.controller.manager import CONTROLLER_INITIALIZERS

    return [name for name in CONTROLLER_INITIALIZERS if name not in SCANNING_CONTROLLERS]


def wall_clock(t: float) -> str:
    return time.strftime("%H:%M:%S", time.localtime(t)) + f".{int(t % 1 * 1000):03d}"


class FullCollections:
    """Times the interpreter's full (generation 2) collections through
    gc.callbacks, from now on; prints each one over 100 ms with its wall
    time, beside the replication layer's exits: a collection stops every
    thread, the acks' too, and the listener's ack deadline is 0.75 s."""

    def __init__(self, who: str):
        self.who = who
        self.pauses = []
        self._t0 = None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self._t0 = None
            self.pauses.append(ms)
            if ms > 100:
                print(f"[gc] {self.who}: a full collection took {ms:.1f} ms, ending at "
                      f"{wall_clock(time.time())}", flush=True)

    def summary(self) -> str:
        p = self.pauses
        return (f"{self.who}: {len(p)} full collections, longest {max(p, default=0):.1f} ms, "
                f"{sum(p):.1f} ms in all")

    def close(self):
        gc.callbacks.remove(self._callback)


class ReplicationLog(logging.Handler):
    """Counts the replication layer's WARNING records by message (follower
    drops and ejections, resyncs, elections): the control-plane phases
    print them beside their numbers."""

    NAME = "kubernetes_tpu.runtime.replication"

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.counts = {}
        logging.getLogger(self.NAME).addHandler(self)

    def emit(self, record):
        msg = record.getMessage()[:80]
        self.counts[msg] = self.counts.get(msg, 0) + 1
        if any(e in msg for e in SYNC_SET_EXITS):
            log(f"[replication] {wall_clock(record.created)}: {msg}")

    def exits(self) -> int:
        """The follower's exits from the sync set so far (SYNC_SET_EXITS)."""
        return sum(n for msg, n in list(self.counts.items())
                   if any(e in msg for e in SYNC_SET_EXITS))

    def close(self):
        logging.getLogger(self.NAME).removeHandler(self)
        super().close()


def bind_ledger(store) -> dict:
    """Counts the binds `store` applies per pod uid, from now on: the
    control-plane phases' "every pod bound exactly once" (their store is
    built inside init_cluster / the standby's promotion)."""
    from collections import defaultdict

    applied = defaultdict(int)
    inner = store.bind_pods

    def bind_pods(bindings, fence=None):
        errs = inner(bindings, fence=fence)
        for b, err in zip(bindings, errs):
            if err is None:
                applied[b.pod_uid] += 1
        return errs

    store.bind_pods = bind_pods
    return applied


def ack_ledger(listener, store) -> dict:
    """Records what the primary acknowledges from now on. A write reaches
    its client only after the replication listener's ship() returns, so
    "rv" is the highest rv shipped without raising (it starts at the
    store's rv: every earlier write has returned), "deletes" the rv of each
    acknowledged delete, and "refused" every object key whose write ship()
    refused (NotPrimary at the stop): applied on the primary, never
    acknowledged. "ship_s" holds each acknowledged ship()'s seconds."""
    led = {"rv": store.resource_version, "deletes": {}, "refused": set(), "ship_s": []}
    inner = listener.ship

    def ship(records):
        t0 = time.perf_counter()
        try:
            inner(records)
        except BaseException:
            led["refused"].update(f"{kind}/{obj.metadata.key}"
                                  for _, _, kind, obj in records if obj is not None)
            raise
        s = time.perf_counter() - t0
        led["ship_s"].append(s)
        if s > 0.5:
            log(f"[replication] {wall_clock(time.time())}: a ship() took {s * 1e3:.1f} ms")
        for rv, verb, kind, obj in records:
            led["rv"] = max(led["rv"], rv)
            if verb == "delete" and obj is not None:
                led["deletes"][f"{kind}/{obj.metadata.key}"] = rv

    listener.ship = ship
    return led


def object_digest(obj) -> str:
    """A digest of an object's wire form (what replication ships)."""
    import hashlib

    from kubernetes_tpu_torch.api import serialization

    wire = json.dumps(serialization.encode(obj), sort_keys=True)
    return hashlib.sha1(wire.encode()).hexdigest()


def store_objects(store) -> list:
    """(kind/key, object) of every object of every kind in `store`, under
    its lock."""
    with store._lock:
        return [(f"{kind}/{key}", obj)
                for kind, objs in store._objects.items() for key, obj in objs.items()]


def acked_state(store, led) -> dict:
    """The stopped primary's acknowledged state: each object whose last
    write was acknowledged (rv <= led["rv"]) as [rv, digest]; the keys of
    the rest (written past the last acknowledgement, or refused) under
    "unacked"; and the acknowledged deletes."""
    objects, unacked = {}, set(led["refused"])
    for key, obj in store_objects(store):
        rv = obj.metadata.resource_version
        if rv <= led["rv"]:
            objects[key] = [rv, object_digest(obj)]
        else:
            unacked.add(key)
    return {"acked_rv": led["rv"], "rv": store.resource_version, "objects": objects,
            "unacked": sorted(unacked), "deletes": led["deletes"]}


def create_all(url: str, token: str, kind: str, objs) -> list:
    """Creates `objs` through the secured REST facade from CREATE_THREADS
    admin clients at once; returns each create call's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from kubernetes_tpu_torch.apiserver.client import AuthRESTClient

    local = threading.local()
    clients = []

    def create(obj):
        c = getattr(local, "client", None)
        if c is None:
            c = local.client = AuthRESTClient(url, token=token)
            clients.append(c)
        t0 = time.perf_counter()
        c.create(kind, obj)
        return time.perf_counter() - t0

    try:
        with ThreadPoolExecutor(CREATE_THREADS) as ex:
            return list(ex.map(create, objs))
    finally:
        for c in clients:
            c.close()


def wait_bound(store, count: int, what: str, prefix: str) -> float:
    """Polls `store` until `count` pods named `prefix`* are bound (at most
    600 s); returns the monotonic time it saw them."""
    deadline = time.monotonic() + 600
    while True:
        n = store.count(
            "pods", lambda p: bool(p.spec.node_name) and p.metadata.name.startswith(prefix)
        )
        if n >= count:
            return time.monotonic()
        if time.monotonic() > deadline:
            raise AssertionError(f"[{what}] {n}/{count} pods bound")
        time.sleep(0.02)


def check_bound_once(applied: dict, pods, what: str) -> None:
    counts = [applied.get(p.metadata.uid, 0) for p in pods]
    if any(c != 1 for c in counts):
        bad = [p.metadata.name for p, c in zip(pods, counts) if c != 1]
        raise AssertionError(f"[{what}] {len(bad)} pods not bound exactly once, e.g. {bad[:3]}")


STANDBY_SYNCED = "[standby synced] "
STANDBY_RESULT = "[standby result] "


class StandbyProcess:
    """kubeadm's standby in a process of its own, as a standby runs on a
    machine of its own: this script with --standby (standby_main). Its
    settings and, after the primary's stop, the primary's word go over its
    standard input; its output is echoed, but for its tagged lines, which
    wait() hands over."""

    def __init__(self, addr, data_dir: str, token: str):
        import queue

        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--standby"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        self.tagged = queue.Queue()
        threading.Thread(target=self._read, daemon=True, name="standby-echo").start()
        self.send({"addr": list(addr), "data_dir": data_dir, "token": token})

    def _read(self):
        for line in self.proc.stdout:
            if line.startswith((STANDBY_SYNCED, STANDBY_RESULT)):
                self.tagged.put(line)
            else:
                print(line, end="", flush=True)
        self.tagged.put(None)

    def send(self, msg: dict) -> None:
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def wait(self, tag: str, timeout: float) -> dict:
        import queue

        try:
            line = self.tagged.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"the standby process printed no {tag.strip()} "
                                 f"line in {timeout:.0f} s") from None
        if line is None or not line.startswith(tag):
            raise AssertionError(f"the standby process ended before its {tag.strip()} "
                                 f"line (exit code {self.proc.wait()})")
        return json.loads(line[len(tag):])

    def stop(self) -> int:
        """Waits up to 60 s for the process to end, then kills it; returns
        its exit code."""
        try:
            return self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def phase_kubeadm(card: str, errors: ErrorLog) -> dict:
    """[kubeadm] the whole control plane through its user entry points:
    init_cluster(replication=True) with every controller but the four
    that rescan the whole store (kubeadm_controllers) and no device (its
    Scheduler on the card), a standby_cluster in a process of its own
    (StandbyProcess) tailing it, synced before the phase writes,
    KUBEADM_WORKLOAD's nodes and initial pods, then KUBEADM_WORKERS nodes
    joined over the bootstrap token (signed discovery, a node credential
    from the CSR controllers), then its measured pods, all created through
    the secured REST facade (authn, RBAC, admission, audit) into the
    WAL-backed store, fsynced and replicated, and a
    KUBEADM_DEPLOYMENT-replica Deployment applied through cmd.kubectl, so
    the Deployment and ReplicaSet controllers make pods for the card.
    Fails unless K1 was launched, the defense counters are 0 and no ERROR
    but the node IPAM controller's CIDR exhaustion is logged. Returns the
    live rigs for [failover], which stops them and then holds the
    bindings to check_kubeadm."""
    import json as _json
    import os
    import tempfile

    from kubernetes_tpu_torch.api import objects as v1
    from kubernetes_tpu_torch.apiserver.client import AuthRESTClient
    from kubernetes_tpu_torch.cmd import kubectl
    from kubernetes_tpu_torch.cmd.kubeadm import ADMIN_CONF, init_cluster, join_node
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload
    from kubernetes_tpu_torch.utils.metrics import metrics

    errors.check("before kubeadm")
    controllers = kubeadm_controllers()
    wl = WORKLOADS[KUBEADM_WORKLOAD]
    nodes, init, factory = build_workload(wl)
    # each node registers as the kubelet does (kubelet.make_node_object):
    # reporting Ready in its first write, so admission does not taint it
    # not-ready for the node lifecycle controller to lift node by node
    for nd in nodes:
        nd.status.conditions = [v1.NodeCondition(type=v1.NODE_READY, status="True")]
    measured = [factory(i) for i in range(wl.num_measured_pods)]
    tmp = tempfile.mkdtemp(prefix="kubeadm-smoke-")
    repl_log = ReplicationLog()
    collections = FullCollections("primary")
    metrics.reset()
    zero_k(fit_kernels)
    t_start = time.monotonic()
    h = init_cluster(os.path.join(tmp, "primary"), controllers=controllers, replication=True)
    sb = None
    try:
        applied = bind_ledger(h.store)
        acked = ack_ledger(h.replication, h.store)
        init_s = time.monotonic() - t_start
        if h.scheduler.device.type != "cuda":
            raise AssertionError(f"[kubeadm] the Scheduler runs on {h.scheduler.device}")
        t0 = time.monotonic()
        sb = StandbyProcess(h.replication_address, os.path.join(tmp, "standby"), h.admin_token)
        sb.wait(STANDBY_SYNCED, timeout=180)
        sync_s = time.monotonic() - t0
        conf = _json.load(open(os.path.join(h.data_dir, ADMIN_CONF)))
        url, token = conf["server"], conf["token"]
        admin = AuthRESTClient(url, token=token)
        log(f"[kubeadm] control plane up in {init_s:.3f} s, standby process started and "
            f"synced in {sync_s:.3f} s")
        t0 = time.monotonic()
        lat = create_all(url, token, "nodes", nodes)
        log(f"[kubeadm] {len(nodes)} nodes created in {time.monotonic() - t0:.3f} s")
        lat += create_all(url, token, "pods", init)
        wait_bound(h.store, len(init), "kubeadm", prefix="init-")
        setup_s = time.monotonic() - t0
        log(f"[kubeadm] {len(init)} initial pods created and bound, {setup_s:.3f} s "
            "after the first node create")
        # the nodes join once the initial pods are bound: they carry no
        # zone, so initial app=bench pods placed there would leave no zone
        # for the measured pods' zone affinity to follow (with 100 initial
        # pods, a burst can put them all on the three larger joined nodes)
        t0 = time.monotonic()
        for i in range(KUBEADM_WORKERS):
            join_node(h.server_url, h.bootstrap_token, f"worker-{i}", handle=h)
        creds = [
            bool(admin.get("certificatesigningrequests", "", f"node-csr-worker-{i}").status.certificate)
            for i in range(KUBEADM_WORKERS)
        ]
        join_s = time.monotonic() - t0
        if not all(creds):
            raise AssertionError(f"[kubeadm] node credentials issued: {creds}")
        log(f"[kubeadm] {KUBEADM_WORKERS} nodes joined in {join_s:.3f} s")
        k1_setup = fit_kernels.fit_mask.launches
        blocking0 = metrics.counter("scheduler_wave_readbacks_blocking_total")
        t_first = time.monotonic()
        burst_lat = create_all(url, token, "pods", measured)
        t_last = wait_bound(h.store, len(measured), "kubeadm", prefix="pod-")
        burst_s = t_last - t_first
        lat += burst_lat
        blocking = metrics.counter("scheduler_wave_readbacks_blocking_total") - blocking0
        log(f"[kubeadm] {len(measured)} measured pods bound in {burst_s:.3f} s")

        manifest = {
            "kind": "Deployment",
            "metadata": {"name": "smoke-web", "namespace": "default"},
            "spec": {
                "replicas": KUBEADM_DEPLOYMENT,
                "selector": {"app": "smoke-web"},
                "template": {
                    "metadata": {"labels": {"app": "smoke-web"}},
                    "spec": {"containers": [{"name": "web", "image": "nginx",
                                             "requests": {"cpu": "100m", "memory": "128Mi"}}]},
                },
            },
        }
        path = os.path.join(tmp, "deployment.json")
        with open(path, "w") as f:
            _json.dump(manifest, f)
        t0 = time.monotonic()
        # --token=: a random token that starts with "-" is no option
        rc = kubectl.main(["--server", url, f"--token={token}", "apply", "-f", path])
        if rc != 0:
            raise AssertionError(f"[kubeadm] kubectl apply exited {rc}")
        deadline = time.monotonic() + 300

        def web(p):
            return p.metadata.labels.get("app") == "smoke-web"

        while True:
            made = h.store.count("pods", web)
            bound = h.store.count("pods", lambda p: web(p) and bool(p.spec.node_name))
            if made >= KUBEADM_DEPLOYMENT and bound == made:
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[kubeadm] the Deployment has {bound}/{made} pods bound, "
                    f"{KUBEADM_DEPLOYMENT} wanted")
            time.sleep(0.05)
        deploy_s = time.monotonic() - t0
        all_s = time.monotonic() - t_start
        k1, k2 = count_k(fit_kernels)
        rate = len(measured) / burst_s
        cidr = errors.expect("kubeadm", (CIDR_EXHAUSTED,))
        log(f"[kubeadm] init_cluster(replication=True, {len(controllers)} controllers) on "
            f"{h.scheduler.device}: "
            f"init {init_s:.3f} s, standby synced in {sync_s:.3f} s, {KUBEADM_WORKERS} "
            f"nodes joined with node credentials in {join_s:.3f} s; {KUBEADM_WORKLOAD} through "
            f"the secured REST facade ({CREATE_THREADS} admin clients): {len(nodes)} nodes and "
            f"{len(init)} initial pods bound in {setup_s:.3f} s, {len(measured)} measured pods "
            f"from the first create to the last bind in {burst_s:.3f} s = {rate:.1f} pods/s; "
            f"{KUBEADM_DEPLOYMENT} Deployment pods bound {deploy_s:.3f} s after kubectl apply; "
            f"all bound {all_s:.3f} s after init began; create call p50/p99 "
            f"{np.percentile(lat, 50) * 1e3:.2f}/{np.percentile(lat, 99) * 1e3:.2f} ms over {len(lat)} creates; "
            f"K1 launches {k1} ({k1_setup} before the burst), K2 launches {k2}; "
            f"{blocking:.0f} blocking readbacks in the burst; {cidr} node IPAM "
            f"'{CIDR_EXHAUSTED}' ERRORs; replication ship() p50/p99/max "
            + "/".join(f"{np.percentile(acked['ship_s'], q) * 1e3:.2f}" for q in (50, 99, 100))
            + f" ms over {len(acked['ship_s'])} ships, warnings "
            f"{json.dumps(repl_log.counts, sort_keys=True)}; {collections.summary()}; card {card}")
        defense_report("kubeadm", card, sched=h.scheduler)
        if k1 <= 0:
            raise AssertionError("[kubeadm] the Scheduler never launched K1")
        # the bindings are checked by check_kubeadm once the primary is
        # stopped: listing and checking 1,200 pods holds the interpreter
        # for seconds, which would stall the replication listener's acks
        return {"h": h, "sb": sb, "tmp": tmp, "repl_log": repl_log,
                "collections": collections, "k1": k1, "k2": k2,
                "rate": rate, "all_s": all_s, "applied": applied, "acked": acked,
                "n_measured": len(measured),
                "n_pods": len(init) + len(measured) + KUBEADM_DEPLOYMENT,
                "n_nodes": len(nodes) + KUBEADM_WORKERS}
    except BaseException:
        h.stop()
        if sb is not None:
            sb.proc.kill()
            sb.stop()
        repl_log.close()
        collections.close()
        raise


def check_kubeadm(kb: dict) -> None:
    """[kubeadm]'s gate, on the stopped primary's store: every pod bound
    exactly once, requested <= allocatable on every node, each measured
    pod in a zone that held an app=bench pod."""
    store = kb["h"].store
    pods = store.list("pods")[0]
    if len(pods) != kb["n_pods"]:
        raise AssertionError(f"[kubeadm] {len(pods)} pods in the store, want {kb['n_pods']}")
    check_bindings(store, kb["n_measured"], "kubeadm")
    check_bound_once(kb["applied"], pods, "kubeadm")
    log(f"[kubeadm] {len(pods)} pods bound exactly once on {kb['n_nodes']} nodes")


def phase_failover(kb: dict, card: str, errors: ErrorLog) -> dict:
    """[failover] after [kubeadm], on the primary's side: a graceful stop.
    The writers (the joined nodes' agents, the controllers) stop first;
    fails unless the follower is then in the sync set with every write
    acknowledged (after an ejection it resyncs); stops the primary (its
    Scheduler, replication listener and REST port); checks its bindings
    (check_kubeadm); hands its acknowledged state (acked_state) to the
    standby's process, which promotes when its lease lapses and checks the
    rest (standby_main). Returns the standby's numbers."""
    import os
    import shutil
    from collections import Counter

    from kubernetes_tpu_torch.client.apiserver import NotPrimary

    h, sb, repl_log = kb["h"], kb["sb"], kb["repl_log"]
    primary_up = True
    try:
        for pool in h._joined:
            pool.stop()
        h.controller_manager.stop()
        # stop() does not join the controllers' workers: one still in a
        # sync finishes it within the workqueue's 0.5 s poll
        time.sleep(1.0)
        deadline = time.monotonic() + 60
        while True:
            with h.replication._lock:
                conns = list(h.replication._followers)
            rv = h.store.resource_version
            if len(conns) == 1 and conns[0].acked_rv >= rv:
                break
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"[failover] the follower is not in the sync set at rv {rv} 60 s after "
                    f"the writers stopped ({len(conns)} connected, acked "
                    f"{[c.acked_rv for c in conns]})")
            time.sleep(0.05)
        log(f"[failover] writers stopped, the follower acknowledged rv {rv}; it left the "
            f"sync set {repl_log.exits()} times in all (replication warnings "
            f"{json.dumps(repl_log.counts, sort_keys=True)}; {kb['collections'].summary()})")
        t_stop = time.time()
        h.stop()
        primary_up = False
        check_kubeadm(kb)
        t0 = time.monotonic()
        state = acked_state(h.store, kb["acked"])
        path = os.path.join(kb["tmp"], "primary-state.json")
        with open(path, "w") as f:
            json.dump(state, f)
        log(f"[failover] primary stopped at rv {state['rv']}, last acknowledged rv "
            f"{state['acked_rv']}: {len(state['objects'])} objects acknowledged, "
            f"{len(state['unacked'])} written past the last acknowledgement "
            f"{json.dumps(Counter(k.split('/')[0] for k in state['unacked']), sort_keys=True)}, "
            f"{len(state['deletes'])} acknowledged deletes (state taken in "
            f"{time.monotonic() - t0:.3f} s)")
        sb.send({"t_stop": t_stop, "state": path})
        r = sb.wait(STANDBY_RESULT, timeout=600)
        rc = sb.stop()
        if rc != 0:
            raise AssertionError(f"[failover] the standby process exited {rc}")
        cidr = errors.expect("failover", (CIDR_EXHAUSTED,), raised=(NotPrimary,))
        log(f"[failover] both control planes stopped; {cidr} node IPAM ERRORs on the "
            "primary after [kubeadm]")
        return r
    finally:
        if primary_up:
            h.stop()
        if sb.proc.poll() is None:
            sb.proc.kill()
            sb.proc.wait()
        repl_log.close()
        kb["collections"].close()
        shutil.rmtree(kb["tmp"], ignore_errors=True)


def standby_main(card: str) -> int:
    """The standby's process (chip_smoke.py --standby, started by
    StandbyProcess; its settings are the first line of its standard
    input): standby_cluster() with [kubeadm]'s controllers and no device
    (the promoted Scheduler on the card), synced, then [failover]'s
    standby side. It takes the promoted store's rv of every object before
    the promoted control plane starts, reads the primary's acknowledged
    state (acked_state) once the primary has stopped, and fails unless it
    was promoted at or past the last acknowledged rv (a follower out of
    the sync set does not promote), and holds every acknowledged object at its rv and wire form and no
    acknowledged delete undone; then FAILOVER_PODS pods created through
    the promoted REST port are each bound exactly once by the promoted
    Scheduler with K1 launched and requested <= allocatable. Prints its
    numbers after STANDBY_RESULT."""
    from kubernetes_tpu_torch.apiserver.client import AuthRESTClient
    from kubernetes_tpu_torch.cmd.kubeadm import standby_cluster
    from kubernetes_tpu_torch.ops import fit_kernels
    from kubernetes_tpu_torch.perf.workloads import WORKLOADS, build_workload

    cfg = json.loads(sys.stdin.readline())
    fit_kernels.build_all()  # built by the first process: loads the libraries
    torch.zeros(1, device="cuda")  # the CUDA context, before the promotion needs it
    _, _, factory = build_workload(WORKLOADS[KUBEADM_WORKLOAD])
    errors = ErrorLog()
    repl_log = ReplicationLog()
    collections = FullCollections("standby")
    zero_k(fit_kernels)
    sb = standby_cluster(tuple(cfg["addr"]), cfg["data_dir"], lease_s=STANDBY_LEASE_S,
                         controllers=kubeadm_controllers(), admin_token=cfg["token"])
    at = {}
    inner = sb.follower.on_promote

    def on_promote(server):
        # the promoted store before its control plane starts: nothing has
        # written to it since the last replicated record
        at["t"] = time.time()
        at["exits"] = repl_log.exits()
        at["rv"] = server.resource_version
        at["objects"] = {key: obj.metadata.resource_version for key, obj in store_objects(server)}
        inner(server)

    sb.follower.on_promote = on_promote
    try:
        if not sb.follower.wait_synced(60.0):
            raise AssertionError("[kubeadm] the standby never synced")
        print(STANDBY_SYNCED + json.dumps({}), flush=True)
        msg = json.loads(sys.stdin.readline())  # the primary has stopped
        if not sb.wait_promoted(STANDBY_LEASE_S * 10 + 60):
            raise AssertionError("[failover] the standby never promoted")
        promoted_s = at["t"] - msg["t_stop"]
        c = sb.cluster
        if c is None:
            raise AssertionError(f"[failover] the promotion failed: {sb.promote_error}")
        admin = AuthRESTClient(c.server_url, token=c.admin_token)
        deadline = time.monotonic() + 60
        while True:
            try:
                admin.list("namespaces")
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)
        serving_s = time.time() - msg["t_stop"]
        if c.scheduler.device.type != "cuda":
            raise AssertionError(f"[failover] the promoted Scheduler runs on {c.scheduler.device}")

        with open(msg["state"]) as f:
            state = json.load(f)
        promoted = at["objects"]
        lost = [k for k, (rv, _) in state["objects"].items() if promoted.get(k) != rv]
        undeleted = [k for k, rv in state["deletes"].items() if promoted.get(k, rv) < rv]
        unknown = [k for k in promoted if k not in state["objects"]
                   and k not in state["deletes"] and k not in state["unacked"]]
        # the wire form of every acknowledged object the promoted plane
        # has not written since (a write bumps the rv)
        now = dict(store_objects(c.store))
        same = [k for k, (rv, _) in state["objects"].items()
                if k in now and now[k].metadata.resource_version == rv]
        differ = [k for k in same if object_digest(now[k]) != state["objects"][k][1]]
        log(f"[failover] the standby: {at['exits']} exits from the sync set before the "
            f"promotion; promoted at rv {at['rv']} (the primary's last acknowledged rv "
            f"{state['acked_rv']}, its last rv {state['rv']}) holding "
            f"{len(state['objects']) - len(lost)}/{len(state['objects'])} acknowledged "
            f"objects at their rv, {len(same) - len(differ)}/{len(same)} not written "
            f"since with the same wire form, {len(undeleted)} acknowledged deletes undone, "
            f"{len(unknown)} objects the primary never acknowledged or refused; replication "
            f"warnings {json.dumps(repl_log.counts, sort_keys=True)}; "
            f"{collections.summary()}")
        if at["rv"] < state["acked_rv"] or lost or differ or undeleted or unknown:
            raise AssertionError(
                "[failover] the promoted store lost acknowledged writes, e.g. "
                f"{(lost + differ + undeleted + unknown)[:5]}")

        applied = bind_ledger(c.store)
        k1_promote = fit_kernels.fit_mask.launches
        post = []
        for i in range(FAILOVER_PODS):
            p = factory(i)
            p.metadata.name = f"post-{i}"
            post.append(p)
        t0 = time.monotonic()
        lat = create_all(c.server_url, c.admin_token, "pods", post)
        t_bound = wait_bound(c.store, FAILOVER_PODS, "failover", prefix="post-")
        bound_s = t_bound - t0
        k1, k2 = count_k(fit_kernels)
        cidr = errors.expect("failover", (CIDR_EXHAUSTED,))
        log(f"[failover] standby promoted {promoted_s:.3f} s after the primary's stop "
            f"(lease {STANDBY_LEASE_S} s), serving on its REST port {serving_s:.3f} s after "
            f"it; {FAILOVER_PODS} pods created through it (create p50/p99 "
            f"{np.percentile(lat, 50) * 1e3:.2f}/{np.percentile(lat, 99) * 1e3:.2f} ms) "
            f"all bound in {bound_s:.3f} s = {FAILOVER_PODS / bound_s:.1f} pods/s by the "
            f"promoted Scheduler on {c.scheduler.device}; K1 launches {k1} "
            f"({k1_promote} by the promotion's start), K2 launches {k2}; {cidr} node "
            f"IPAM '{CIDR_EXHAUSTED}' ERRORs; card {card}")
        defense_report("failover", card, sched=c.scheduler)
        if k1 <= 0:
            raise AssertionError("[failover] the promoted Scheduler never launched K1")
        pods = c.store.list("pods")[0]
        check_capacity(c.store, "failover")
        check_bound_once(applied, [p for p in pods if p.metadata.name.startswith("post-")], "failover")
        log(f"[failover] checked from the promoted store: {len(pods)} pods bound, "
            f"requested <= allocatable on every node, the {FAILOVER_PODS} new pods bound once")
    finally:
        sb.stop()
        repl_log.close()
        collections.close()
    # stop() does not join the controllers' workers: one still in a sync
    # finishes it within the workqueue's 0.5 s poll
    time.sleep(1.0)
    errors.expect("failover", (CIDR_EXHAUSTED,))
    print(STANDBY_RESULT + json.dumps({
        "k1": k1, "k2": k2, "promoted_s": promoted_s, "serving_s": serving_s,
        "bound_s": bound_s}), flush=True)
    return 0


# [durability]'s records without fsync, cut from the reference's 50,000
# (their recovery took 56.4 s, PERF.md §5; then 10,000) so
# that the script, [soak] and [ha] included, stays inside its time limit
DURABILITY_RECORDS = 5_000


def phase_durability(card: str, errors: ErrorLog) -> dict:
    """[durability] run_durability_benchmark(n_records=DURABILITY_RECORDS)
    (5,000 records in 64-record group commits without fsync, their cold
    recovery, 2,000 records with fsync, the reference's batch and fsync
    count): append rates, fsync p50/p99,
    recovery time. Fails unless the native group-commit sink
    (native/walsink.cpp) was built and used, and recovery found every
    record. Touches no device."""
    from kubernetes_tpu_torch.perf.harness import run_durability_benchmark
    from kubernetes_tpu_torch.utils.metrics import metrics

    # the reference's bench reads the fsync histogram's `.count`, which
    # Histogram does not have (`.n`): it raises once an fsynced append
    # ([kubeadm]'s store) made that histogram. Start from empty metrics,
    # as the bench does in a fresh process.
    metrics.reset()
    r = run_durability_benchmark(n_records=DURABILITY_RECORDS)
    log(f"[durability] WAL, {r.n_records} records in batches of {r.batch}: appends "
        f"{r.append_nofsync_per_s:.1f}/s without fsync, {r.append_fsync_per_s:.1f}/s with "
        f"fsync (fsync p50/p99 {r.fsync_p50_ms:.3f}/{r.fsync_p99_ms:.3f} ms); recovery "
        f"{r.recovery_s:.3f} s = {r.recovery_records_per_s:.1f} records/s to rv "
        f"{r.recovered_rv}; native_sink {r.native_sink}; card {card}")
    errors.check("durability")
    if not r.native_sink:
        raise AssertionError("[durability] the native WAL sink did not build: the "
                             "Python fallback ran")
    if r.recovered_rv != r.n_records:
        raise AssertionError(f"[durability] recovered rv {r.recovered_rv} of {r.n_records}")
    return {"native_sink": r.native_sink}


CONTROL_PLANE_RESULT = "[control-plane result] "


def control_plane_main(card: str) -> int:
    """The control-plane phases, [kubeadm], [failover] and [durability],
    in a process of their own (run_control_plane starts it): a control
    plane is a process of its own, and after the earlier phases' 380 s
    the same interpreter bound the measured burst in 712 s where a fresh
    one took 100 s. No thread left by an earlier phase explains it: before
    [kubeadm] the first process holds one Python thread besides the main
    one ([cmd]'s health endpoint, which cmd.scheduler.run keeps for the
    process's life), no thread uses CPU while the main one sleeps, and a
    pure-Python loop runs no slower than at the start (thread_report).
    Prints each phase's lines and, last, the kernels' launches on its two
    paths after CONTROL_PLANE_RESULT."""
    from kubernetes_tpu_torch.ops import fit_kernels

    fit_kernels.build_all()  # built by the parent: loads the libraries
    errors = ErrorLog()
    kb = phase_kubeadm(card, errors)
    kubeadm = {"k1": kb["k1"], "k2": kb["k2"]}
    failover = phase_failover(kb, card, errors)
    del kb
    phase_durability(card, errors)
    print(CONTROL_PLANE_RESULT + json.dumps({
        "kubeadm": kubeadm, "failover": {"k1": failover["k1"], "k2": failover["k2"]},
    }), flush=True)
    return 0


def run_control_plane(card: str) -> tuple:
    """Runs control_plane_main in a child process (this script with
    --control-plane) in a process group of its own, with the standby's
    process it starts, echoes its output, and returns the K1/K2 launches
    of [kubeadm] and [failover]. Fails unless the child exits 0 within
    900 s; kills the group at the end in any case."""
    import os
    import signal

    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--control-plane"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )

    def kill_group():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    result = None
    timer = threading.Timer(900, kill_group)
    timer.start()
    try:
        for line in proc.stdout:
            if line.startswith(CONTROL_PLANE_RESULT):
                result = json.loads(line[len(CONTROL_PLANE_RESULT):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait()
    finally:
        timer.cancel()
        kill_group()
        proc.wait()
    if rc != 0 or result is None:
        raise AssertionError(f"the control-plane phases failed (exit code {rc})")
    return result["kubeadm"], result["failover"]


def thread_report(what: str) -> None:
    """Lists every thread of this process (/proc/self/task, named by
    threading where it is a Python thread) with the CPU each used over 2 s
    in which the main thread sleeps, times a fixed pure-Python loop
    (slower when other threads hold the interpreter lock) and counts the
    objects the cyclic collector tracks (what a full collection walks):
    what earlier phases leave behind."""
    import os
    from collections import Counter

    def ticks():
        out = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    stat = f.read()
                with open(f"/proc/self/task/{tid}/comm") as f:
                    comm = f.read().strip()
            except OSError:
                continue
            fields = stat[stat.rindex(")") + 2:].split()
            out[int(tid)] = (comm, int(fields[11]) + int(fields[12]))
        return out

    names = {t.native_id: t.name for t in threading.enumerate()}
    hz = os.sysconf("SC_CLK_TCK")
    a = ticks()
    time.sleep(2.0)
    b = ticks()
    busy = {f"{names.get(tid, comm)} ({tid})": round((n - a.get(tid, (comm, 0))[1]) * 1e3 / hz)
            for tid, (comm, n) in b.items() if n > a.get(tid, (comm, 0))[1]}
    t0 = time.perf_counter()
    s = 0
    for i in range(3_000_000):
        s += i
    loop_s = time.perf_counter() - t0
    kinds = Counter(re.sub(r"[-_ ]?\d+$", "", n) for n in names.values())
    t0 = time.perf_counter()
    gc.collect()
    full_s = time.perf_counter() - t0
    tracked = len(gc.get_objects())
    log(f"[threads] {what}: {len(b)} threads, {len(names)} of them Python "
        f"{json.dumps(dict(kinds), sort_keys=True)}; CPU ms over 2 s with the main thread "
        f"asleep {json.dumps(busy, sort_keys=True)}; a 3,000,000-step Python loop "
        f"{loop_s:.3f} s; {tracked} objects tracked by the collector, a full "
        f"collection {full_s * 1e3:.1f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--control-plane", action="store_true",
                    help=argparse.SUPPRESS)  # the child of run_control_plane
    ap.add_argument("--standby", action="store_true",
                    help=argparse.SUPPRESS)  # the child of StandbyProcess
    ap.add_argument("--dist-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)  # a process of [dist] (spawn_dist)
    args = ap.parse_args(argv)
    if args.dist_worker:
        return dist_worker_main(json.loads(args.dist_worker))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.control_plane:
        return control_plane_main(card_line())
    if args.standby:
        return standby_main(card_line())
    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; {torch.cuda.device_count()} visible; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")
    thread_report("at the start")

    from kubernetes_tpu_torch.ops import fit_kernels

    errors = ErrorLog()

    def after(what: str) -> None:
        log(f"[time] {time.monotonic() - t_start:.1f} s after [{what}]")

    parent = build_kernels()
    phase_fit_kernel(device, parent)
    k2 = phase_least_alloc(device, parent)
    after("K2")
    # first of the Scheduler phases, while the interpreter's heap is small:
    # its 2,500 kubelets renew a lease each a second between the full
    # collections that the heap of the later phases lengthens
    nodeloss = phase_nodeloss(device, card, errors, args.seed)
    after("nodeloss")

    mp = main_path(device, args.seed)
    b = mp["batches"]
    enc_s = sum(x.encode_s for x in b)
    ker_s = sum(x.kernel_s for x in b)
    com_s = sum(x.commit_s for x in b)
    log(f"[main] SchedulingPodAffinity/5000: {mp['placed']}/5000 placed in "
        f"{mp['wall_s']:.3f} s = {mp['placed'] / mp['wall_s']:.1f} pods/s; "
        f"{len(b)} batches, waves {[x.n_waves for x in b]}, placed per batch "
        f"{[len(x.placed) for x in b]}; encode {enc_s:.3f} s, "
        f"kernel {ker_s:.3f} s, commit {com_s:.3f} s; node setup {mp['setup_s']:.2f} s; "
        f"K1 launches {mp['launches']}; card {card}")
    if mp["launches"] <= 0:
        raise AssertionError("the main path never launched K1")

    # K1 timed on the main path's own inputs: its template requests and
    # the live snapshot's free matrix
    enc = mp["enc"]
    snap = enc.flush()
    req = mp["cache"]._tpl_batch.req.contiguous()
    free = (snap.allocatable - snap.requested).contiguous()
    got = fit_kernels.fit_mask(req, free)
    max_abs_err = float((got.int() - fit_kernels.fit_mask_plain(req, free).int()).abs().max())
    k1 = k1_timings(req, free, parent, "main-path shape")
    log(f"[K1] main-path shape: max |kernel - plain| {max_abs_err}")

    phase_parity(mp, device)
    serial_batch_check(mp, device)
    after("parity")
    mesh = phase_mesh(mp, device, card, errors)
    after("mesh")
    zero_k(fit_kernels)
    dist = phase_dist(device, card, args.seed, mesh)
    errors.check("dist")
    after("dist")

    res, k1_launches, k2_launches, sched_server = phase_scheduler(device, card, errors)
    phase_audit(sched_server, device, card, errors)
    after("audit")
    zero_k(fit_kernels)
    phase_latency(device, res.throughput_pods_per_s, errors, card)
    k1_latency, k2_latency = count_k(fit_kernels)
    log(f"[latency] K1 launches {k1_latency}, K2 launches {k2_latency}")
    if k1_latency <= 0:
        raise AssertionError("[latency] the Scheduler never launched K1")
    after("latency")

    serial = phase_serial(device, card, errors)
    after("serial")
    preempt = phase_preempt(device, card, errors)
    if preempt["k1"] <= 0:
        raise AssertionError("[preempt] the burst's wave path never launched K1")
    after("preempt")
    standby = phase_standby(device, card, errors)
    if standby["k1"] <= 0:
        raise AssertionError("[standby] the warm-up and the promoted loop never launched K1")
    after("standby")
    ha = phase_ha(device, card, errors)
    after("ha")
    hostcb = phase_hostcb(device, card, errors)
    after("hostcb")
    caches = cluster_caches(sched_server, device)
    after("caches")
    zero_k(fit_kernels)
    phase_whatif(sched_server, device, card, errors, caches)
    whatif = dict(zip(("k1", "k2"), count_k(fit_kernels)))
    after("whatif")
    zero_k(fit_kernels)
    phase_gym(caches, device, card, errors)
    gym = dict(zip(("k1", "k2"), count_k(fit_kernels)))
    after("gym")
    del sched_server, caches
    tuner = phase_tuner(device, card, errors)
    after("tuner")
    cmd = phase_cmd(device, card, errors)
    after("cmd")
    autoscaler = phase_autoscaler(device, card, errors)
    after("autoscaler")
    hetero = phase_hetero(device, card, errors)
    after("hetero")
    defrag = phase_defrag(device, card, errors)
    after("defrag")
    hardpair = phase_hardpair(device, card, errors)
    log(f"[time] {time.monotonic() - t_start:.1f} s before [suite]")
    thread_report("before [suite]")
    suite = phase_suite(device, card, errors, args.seed)
    log(f"[time] {time.monotonic() - t_start:.1f} s after [suite]")
    soak = phase_soak(device, card, errors, args.seed)
    log(f"[time] {time.monotonic() - t_start:.1f} s after [soak], before [kubeadm]")
    thread_report("before [kubeadm]")
    kubeadm, failover = run_control_plane(card)
    log(f"[time] {time.monotonic() - t_start:.1f} s after [durability]")
    phase_guards(device, card, errors)
    after("guards")
    phase_device_loss(device, card, errors)
    log(f"[time] {time.monotonic() - t_start:.1f} s in all")

    def launches(k):
        return {
            "launches_serial": serial[k],
            "launches_preempt": preempt[k],
            "launches_standby": standby[k],
            "launches_ha": ha[k],
            "launches_nodeloss": nodeloss[k],
            "launches_hostcb": hostcb[k],
            "launches_whatif": whatif[k],
            "launches_autoscaler": autoscaler[k],
            "launches_hetero": hetero[k],
            "launches_defrag": defrag[k],
            "launches_hardpair": hardpair[k],
            "launches_tuner": tuner[k],
            "launches_gym": gym[k],
            "launches_cmd": cmd[k],
            "launches_kubeadm": kubeadm[k],
            "launches_failover": failover[k],
            "launches_mesh": mesh[k],
            "launches_dist": dist[k],
            "launches_suite": suite[k],
            "launches_soak": soak[k],
        }

    kernels = {
        "kernels": [
            {
                "name": "fit_mask",
                "route": "cuda",
                "source": "kubernetes_tpu_torch/csrc/fit_mask.cu",
                "replaces": "kubernetes_tpu/ops/pallas_ops.py:120",
                "launches": k1_launches,
                "launches_latency": k1_latency,
                **launches("k1"),
                "max_abs_err": max_abs_err,
                "ms": k1["ms"],
                "plain_ms": k1["plain_ms"],
                "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"],
                "library_ms": None,
                "floor_ms": k1["floor_ms"],
                "call_ms": k1["call_ms"],
                "parent_ms": k1["parent_ms"],
                "parent_call_ms": k1["parent_call_ms"],
            },
            {
                "name": "fit_mask_least_alloc",
                "route": "cuda",
                "source": "kubernetes_tpu_torch/csrc/fit_least_alloc.cu",
                "replaces": "kubernetes_tpu/ops/pallas_ops.py:69",
                "path": "standalone",
                "launches": k2_launches,
                "launches_latency": k2_latency,
                **launches("k2"),
                "max_abs_err": k2["max_abs_err"],
                "ms": k2["ms"],
                "plain_ms": k2["plain_ms"],
                "bound_ms": k2["bound_ms"],
                "bound_by": k2["bound_by"],
                "library_ms": None,
                "floor_ms": k2["floor_ms"],
                "call_ms": k2["call_ms"],
                "parent_ms": k2["parent_ms"],
                "parent_call_ms": k2["parent_call_ms"],
            },
        ]
    }
    log(f"card: {card}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
