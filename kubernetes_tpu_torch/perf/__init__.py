"""Benchmark workload shapes (scheduler_perf-equivalent, copied)."""

from .workloads import WORKLOADS, WorkloadConfig, build_workload  # noqa: F401
