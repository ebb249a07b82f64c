"""Process-wide eviction budget: ONE token bucket for every evictor.

Extracted from controller/nodelifecycle.py (the PR-3 eviction limiter):
three subsystems now deliberately delete healthy-looking pods — the node
lifecycle controller (dead-node drains), the scheduler's preemption path
(victim deletes), and the descheduler (consolidation waves) — and each
pacing itself against a PRIVATE bucket would let a combined storm evict
at three times the configured cluster rate. A process that runs more
than one evictor constructs one ``EvictionBudget`` and injects it into
all of them (cmd/scheduler.py does exactly this); per-actor counters
keep the shared spend attributable.

The bucket itself is the reference's flowcontrol.NewTokenBucketRateLimiter
shape (qps refill, burst headroom), unchanged from the PR-3 limiter —
``EvictionLimiter`` in nodelifecycle.py remains as a back-compat alias.
"""

from __future__ import annotations

import threading
import time

from ..utils.metrics import metrics

# metrics (rendered by /metrics and the SIGUSR2 debugger dump). The
# per-actor split is the whole point of sharing: a dry budget must be
# attributable to WHO spent it, or a preemption storm starving the
# descheduler (by design) reads like a descheduler bug.
GAUGE_BUDGET_TOKENS = "eviction_budget_tokens"
COUNTER_BUDGET_ACQUIRED = "eviction_budget_acquired_total"
COUNTER_BUDGET_DEFERRED = "eviction_budget_deferred_total"


class EvictionBudget:
    """Token bucket over evictions: at most ``qps`` per second with
    ``burst`` headroom, shared by every actor holding a reference.

    ``try_acquire(actor=...)`` labels the per-actor spend/defer counters;
    callers that predate the shared budget (or tests driving the bucket
    directly) may omit ``actor`` and get the bare-bucket behavior with
    no metric emission.
    """

    def __init__(self, qps: float = 10.0, burst: int = 5):
        if qps <= 0:
            raise ValueError(f"eviction qps must be > 0, got {qps}")
        self.qps = qps
        self.burst = max(1, burst)
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, now: float = None, actor: str = "") -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._tokens = min(
                float(self.burst), self._tokens + (now - self._last) * self.qps
            )
            self._last = now
            ok = self._tokens >= 1.0
            if ok:
                self._tokens -= 1.0
            tokens = self._tokens
        if actor:
            if ok:
                metrics.inc(COUNTER_BUDGET_ACQUIRED, {"actor": actor})
            else:
                metrics.inc(COUNTER_BUDGET_DEFERRED, {"actor": actor})
            metrics.set_gauge(GAUGE_BUDGET_TOKENS, tokens)
        return ok

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


def eviction_budget_health_lines() -> list:
    """Shared-budget counters/gauge rendered for the SIGUSR2 debugger
    dump — empty when no budget-labeled acquire ran in this process."""
    lines = []
    for series in (
        metrics.snapshot_gauges("eviction_budget_"),
        metrics.snapshot_counters("eviction_budget_"),
    ):
        for name, labels, value in series:
            lines.append(metrics.format_series_line(name, labels, value))
    return lines
