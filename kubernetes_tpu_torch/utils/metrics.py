"""Metrics registry: counters, gauges, histograms with label support.

component-base/metrics-lite (reference wraps prometheus; scheduler series at
pkg/scheduler/metrics/metrics.go:51-231). Same series names are used by the
scheduler so dashboards translate: schedule_attempts_total,
e2e_scheduling_duration_seconds, scheduling_algorithm_duration_seconds,
binding_duration_seconds, pending_pods, queue_incoming_pods_total, etc.
"""

from __future__ import annotations

import bisect
import random
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_DEF_BUCKETS = [
    0.0001, 0.0002, 0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
]


class Histogram:
    # exemplar slots: the largest-valued observations that carried a
    # trace id — enough to resolve "show me the p99 pod" without storing
    # an id per sample
    _MAX_EXEMPLARS = 8

    def __init__(
        self,
        buckets: Optional[List[float]] = None,
        max_samples: int = 100000,
        seed: int = 0x5EED,
    ):
        self.buckets = buckets or _DEF_BUCKETS
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0
        # true bounded reservoir (Algorithm R, deterministic seed): every
        # observation — first or ten-millionth — has equal probability of
        # being in the sample, so a long-run p99 tracks the live
        # distribution instead of freezing at the warmup one. Each slot
        # remembers the OBSERVATION INDEX it came from so quantiles_since
        # can still window out warmup samples.
        self._samples: List[float] = []
        self._sample_obs: List[int] = []
        self._max_samples = max_samples
        self._rng = random.Random(seed)
        # (value, exemplar) pairs, tail-biased (see observe)
        self._exemplars: List[Tuple[float, str]] = []

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.buckets, v)
        self.counts[i] += 1
        self.total += v
        self.n += 1
        if len(self._samples) < self._max_samples:
            self._samples.append(v)
            self._sample_obs.append(self.n - 1)
        else:
            j = self._rng.randrange(self.n)
            if j < self._max_samples:
                self._samples[j] = v
                self._sample_obs[j] = self.n - 1
        if exemplar:
            ex = self._exemplars
            if len(ex) < self._MAX_EXEMPLARS:
                ex.append((v, exemplar))
            else:
                mi = min(range(len(ex)), key=lambda k: ex[k][0])
                if v > ex[mi][0]:
                    ex[mi] = (v, exemplar)

    def quantile(self, q: float) -> float:
        return self.quantiles([q])[0]

    def quantiles(self, qs) -> List[float]:
        """Several quantiles from ONE sort of the reservoir."""
        if not self._samples:
            return [0.0] * len(qs)
        s = sorted(self._samples)
        return [s[min(int(q * len(s)), len(s) - 1)] for q in qs]

    def quantiles_since(self, n0: int, qs) -> List[float]:
        """Quantiles over samples whose observation index is >= n0 — lets
        a measurement window exclude warmup/compile-laden samples the
        same way callers baseline `total`/`n` (bench stage breakdown).
        Algorithm R keeps every slot's inclusion probability identical,
        so the surviving suffix samples are an unbiased window sample."""
        s = sorted(
            v for v, oi in zip(self._samples, self._sample_obs) if oi >= n0
        )
        if not s:
            return [0.0] * len(qs)
        return [s[min(int(q * len(s)), len(s) - 1)] for q in qs]

    def exemplars(self) -> List[Tuple[float, str]]:
        """(value, trace_id) pairs, largest value first."""
        return sorted(self._exemplars, reverse=True)

    def exemplar_near(self, q: float) -> Optional[Tuple[float, str]]:
        """The exemplar closest ABOVE the q-quantile (falling back to the
        largest below it): "what is the p99" becomes "show me the p99
        pod's waterfall" through the returned trace id."""
        ex = self.exemplars()
        if not ex:
            return None
        target = self.quantile(q)
        at_or_above = [e for e in ex if e[0] >= target]
        return at_or_above[-1] if at_or_above else ex[0]

    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], Histogram] = {}

    @staticmethod
    def _k(name: str, labels: Optional[dict]) -> Tuple[str, Tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def inc(self, name: str, labels: Optional[dict] = None, by: float = 1.0) -> None:
        with self._lock:
            self._counters[self._k(name, labels)] += by

    def set_gauge(self, name: str, value: float, labels: Optional[dict] = None) -> None:
        with self._lock:
            self._gauges[self._k(name, labels)] = value

    def remove_gauge(self, name: str, labels: Optional[dict] = None) -> None:
        """Retire one labeled gauge series (e.g. a departed follower's lag
        — a stale series would read as a live replica in the debugger)."""
        with self._lock:
            self._gauges.pop(self._k(name, labels), None)

    def observe(
        self,
        name: str,
        value: float,
        labels: Optional[dict] = None,
        exemplar: Optional[str] = None,
    ) -> None:
        """exemplar: a trace id to ride along with this observation —
        tail observations keep theirs, so the histogram's p99 resolves
        to an inspectable per-pod trace (utils/tracing.py)."""
        with self._lock:
            k = self._k(name, labels)
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.observe(value, exemplar=exemplar)

    def counter(self, name: str, labels: Optional[dict] = None) -> float:
        with self._lock:
            return self._counters.get(self._k(name, labels), 0.0)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Optional[float]:
        """Read back a gauge (None when never set) — the consensus/
        replication health gauges are read-path state for the SIGUSR2
        debugger dump and tests, not just exposition output."""
        with self._lock:
            return self._gauges.get(self._k(name, labels))

    def _snapshot_series(
        self, series: dict, prefix: str
    ) -> List[Tuple[str, dict, float]]:
        """(name, labels, value) for every series under prefix, sorted by
        the (name, labels) KEY tuple — sorting the dict-carrying rows
        directly raises once two series share a name (dicts don't
        order). Caller must hold self._lock."""
        return [
            (name, dict(labels), v)
            for (name, labels), v in sorted(
                series.items(), key=lambda kv: kv[0]
            )
            if name.startswith(prefix)
        ]

    def snapshot_gauges(self, prefix: str = "") -> List[Tuple[str, dict, float]]:
        """Every gauge under prefix — the debugger's replication section
        renders exactly this."""
        with self._lock:
            return self._snapshot_series(self._gauges, prefix)

    @staticmethod
    def format_series_line(name: str, labels: dict, value: float,
                           annotation: str = "") -> str:
        """One debug-dump line for a (name, labels, value) series — the
        shared renderer behind every SIGUSR2 health-lines section (the
        consensus, ride-through, data-plane, autoscaler, and read-path
        dumps all print this exact shape)."""
        label_s = (
            "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"
            if labels
            else ""
        )
        suffix = f" [{annotation}]" if annotation else ""
        return f"  {name}{label_s}: {value:g}{suffix}"

    def snapshot_counters(self, prefix: str = "") -> List[Tuple[str, dict, float]]:
        """Every counter under prefix — the debugger's data-plane
        self-defense section renders drift and guard-trip counters this
        way (counters, unlike gauges, have no enumerable label sets a
        caller could probe one by one)."""
        with self._lock:
            return self._snapshot_series(self._counters, prefix)

    def histogram(self, name: str, labels: Optional[dict] = None) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(self._k(name, labels))

    def reset(self) -> None:
        """DELETE /metrics debug endpoint behavior (server.go:237-247)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    def render_prometheus(self) -> str:
        """Prometheus exposition text format (the wire form the reference's
        legacyregistry serves on /metrics): counters and gauges as-is,
        histograms as _count/_sum plus p50/p90/p99 quantile gauges (this
        registry keeps a sample reservoir, not fixed buckets)."""

        def esc(v) -> str:
            return (
                str(v)
                .replace("\\", "\\\\")
                .replace('"', '\\"')
                .replace("\n", "\\n")
            )

        def fmt_labels(labels) -> str:
            if not labels:
                return ""
            inner = ",".join(
                f'{k}="{esc(v)}"' for k, v in sorted(dict(labels).items())
            )
            return "{" + inner + "}"

        lines = []
        # the whole render holds the lock (like dump()): histograms are
        # shared mutable objects, and a concurrent observe() between the
        # quantile/_sum/_count reads would emit a torn summary
        with self._lock:
            seen_types = set()
            for (name, labels), v in sorted(self._counters.items()):
                if name not in seen_types:
                    lines.append(f"# TYPE {name} counter")
                    seen_types.add(name)
                lines.append(f"{name}{fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                if name not in seen_types:
                    lines.append(f"# TYPE {name} gauge")
                    seen_types.add(name)
                lines.append(f"{name}{fmt_labels(labels)} {v}")
            for (name, labels), h in sorted(self._hists.items()):
                if name not in seen_types:
                    lines.append(f"# TYPE {name} summary")
                    seen_types.add(name)
                base = dict(labels) if labels else {}
                vals = h.quantiles((0.5, 0.9, 0.99))  # one sort
                for q, val in zip((0.5, 0.9, 0.99), vals):
                    ql = dict(base)
                    ql["quantile"] = f"{q:g}"
                    lines.append(f"{name}{fmt_labels(ql)} {val}")
                lines.append(f"{name}_sum{fmt_labels(labels)} {h.total}")
                lines.append(f"{name}_count{fmt_labels(labels)} {h.n}")
                for val, tid in h.exemplars():
                    # OpenMetrics-style exemplar, emitted as a comment so
                    # plain text-format 0.0.4 scrapers stay unbroken
                    lines.append(
                        f"# exemplar {name}{fmt_labels(labels)} {val} "
                        f'trace_id="{esc(tid)}"'
                    )
        return "\n".join(lines) + "\n"

    def dump(self) -> dict:
        with self._lock:
            out = {}
            for (name, labels), v in self._counters.items():
                out[f"{name}{dict(labels)}"] = v
            for (name, labels), v in self._gauges.items():
                out[f"{name}{dict(labels)}"] = v
            for (name, labels), h in self._hists.items():
                p50, p90, p99 = h.quantiles((0.50, 0.90, 0.99))
                entry = {
                    "count": h.n,
                    "avg": h.avg,
                    "p50": p50,
                    "p90": p90,
                    "p99": p99,
                }
                ex = h.exemplar_near(0.99)
                if ex is not None:
                    entry["p99_exemplar"] = ex[1]
                out[f"{name}{dict(labels)}"] = entry
            return out


metrics = Metrics()  # process-global registry (legacyregistry equivalent)
