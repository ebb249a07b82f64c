"""tests/test_gang_variants.py on the port: a gang burst keeps one kernel
variant. 30 gangs of 50 members differ only by their group-name label;
the effect-keyed template fingerprints collapse every batch's members to
ONE template, and the Scheduler asks for at most two wave-kernel variants
in the whole burst (the big bucket, and the small latency bucket when an
early or tail batch lands under 256 pods), as the reference's burst
compiles at most two. The port's run_benchmark on the CPU (device="cpu"),
Gang at 500 nodes and 1,500 pods under the coscheduling profile; every
pod bound, as in the reference test.

The port compiles nothing, so the variants are counted where the
Scheduler asks for a wave kernel (``Scheduler._wave_kernel``), and the
templates where the wave path encodes a batch (``TemplateCache.encode``).
"""

from kubernetes_tpu_torch.ops.templates import TemplateCache
from kubernetes_tpu_torch.perf.harness import run_benchmark
from kubernetes_tpu_torch.perf.workloads import WorkloadConfig
from kubernetes_tpu_torch.scheduler import scheduler as scheduler_mod
from kubernetes_tpu_torch.scheduler.config import (
    KubeSchedulerConfiguration,
    ProfileConfig,
)
from kubernetes_tpu_torch.scheduler.framework.registry import coscheduling_plugin_set


def test_gang_burst_compiles_one_kernel_variant(monkeypatch):
    variants, templates = set(), []
    real_kernel, real_encode = scheduler_mod.Scheduler._wave_kernel, TemplateCache.encode

    def wave_kernel(self, variant):
        variants.add(tuple(variant))
        return real_kernel(self, variant)

    def encode(self, pods, pad_to=None):
        eb = real_encode(self, pods, pad_to=pad_to)
        templates.append(eb.num_templates)
        return eb

    monkeypatch.setattr(scheduler_mod.Scheduler, "_wave_kernel", wave_kernel)
    monkeypatch.setattr(TemplateCache, "encode", encode)
    gcfg = KubeSchedulerConfiguration(
        profiles=[ProfileConfig(plugin_set=coscheduling_plugin_set())]
    )
    r = run_benchmark(
        WorkloadConfig("Gang", 500, 0, 1500), sched_config=gcfg, quiet=True,
        timeout_s=240, device="cpu",
    )
    assert r.unscheduled == 0, f"{r.unscheduled} gang pods unscheduled"
    assert variants, "the burst launched no wave kernel"
    assert len(variants) <= 2, f"kernel variant churn: {sorted(variants)}"
    assert templates and set(templates) == {1}, f"templates a batch: {templates}"
