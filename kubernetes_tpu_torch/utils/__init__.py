"""Shared infra: the metrics registry (copied from kubernetes_tpu.utils)."""

from .metrics import Metrics, metrics  # noqa: F401
