"""The port's single-device data plane of one tree on the CUDA card: launch
counts and walls, to hold two commits against each other.

Run it from the root of the tree to measure (it imports that tree's
``chip_smoke.py`` and ``kubernetes_tpu_torch``); it builds the tree's
kernels, runs ``chip_smoke.main_path`` (``SchedulingPodAffinity/5000``,
seed 0) and then, on that encoder:

* one 4096-pod wave batch (``chip_smoke.phase_parity``'s batch: its pods
  100000-104095 and the next noise of the main path's Generator): kernel
  launches from one ``torch.profiler`` run, and the median wall of 5
  calls without the profiler, each on a fresh clone of the snapshot;
* one 128-pod serial batch (pods 200000-200127): launches and median
  wall the same way;
* ``chip_smoke.phase_scheduler``'s burst through the Scheduler: batches
  and K1 launches.

Prints one JSON line with the tree's label and the card's name and power
limit. To compare two commits in one chip call, unpack the other commit
(``git archive``) into a git-ignored directory and run this script from
each tree in turns (parent, change, change, parent)::

    (cd build/archive/parent && python3 /path/to/scripts/torch_single_path_ab.py --label parent)
    python3 scripts/torch_single_path_ab.py --label change
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from kubernetes_tpu_torch.ops.batch import encode_pod_batch
    from kubernetes_tpu_torch.ops.lattice import make_schedule_batch
    from kubernetes_tpu_torch.scheduler.wavepath import prepare_batch

    if not torch.cuda.is_available():
        print("torch_single_path_ab: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.build_kernels()
    mp = cs.main_path(dev, 0)
    enc, cfg = mp["enc"], mp["cfg"]

    def launches(fn) -> int:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(
            e.count for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        )

    def median_ms(fn, n: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[n // 2]

    pods = [mp["factory"](100000 + i) for i in range(cfg.batch_size)]
    prep = prepare_batch(enc, mp["cache"], pods, cfg)
    snap = enc.flush()
    m_c = min(prep.kern.m_cand, snap.valid.shape[0])
    noise = torch.rand((cfg.batch_size, m_c), generator=mp["rng"], device=dev) * 0.999

    def wave():
        clone = type(snap)(*(t.clone() for t in snap))
        prep.kern.with_noise(clone, prep.eb.batch, prep.ptab, mp["weights"], noise)

    out = {"label": args.label, "wave_waves": prep.n_waves,
           "wave_launches": launches(wave), "wave_ms": median_ms(wave)}

    spods = [mp["factory"](200000 + i) for i in range(128)]
    eb = encode_pod_batch(enc, spods, pad_to=128)
    snap = enc.flush()
    snoise = torch.rand((128, snap.valid.shape[0]), generator=mp["rng"], device=dev)
    kern = make_schedule_batch(enc.cfg.v_cap)

    def serial():
        kern(snap, eb.batch, mp["weights"], snoise)

    out.update(serial_launches=launches(serial), serial_ms=median_ms(serial))
    res, k1, _k2, _server = cs.phase_scheduler(dev, cs.card_line(), cs.ErrorLog())
    out.update(burst_batches=res.n_batches, burst_k1=k1,
               burst_pods_per_s=res.throughput_pods_per_s, card=cs.card_line())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
