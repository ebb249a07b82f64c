"""API Priority and Fairness (APF), simplified.

Reference: staging/src/k8s.io/apiserver/pkg/util/flowcontrol — requests are
classified by FlowSchemas into PriorityLevels; each level owns a share of
the server's concurrency budget so a flood at one level (a misbehaving
workload) cannot starve another (leader-election renewals, node
heartbeats). This build keeps the classification + per-level isolated
concurrency + bounded queuing, and simplifies the shuffle-sharded fair
queues within a level to a FIFO wait on the level's semaphore (documented
divergence: per-flow fairness INSIDE one level is approximate; isolation
BETWEEN levels is exact).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu.apiserver.flowcontrol")


GAUGE_SEATS_IN_USE = "apiserver_flowcontrol_seats_in_use"  # {priority_level}
GAUGE_SEATS_TOTAL = "apiserver_flowcontrol_seats_total"    # {priority_level}


@dataclass
class PriorityLevel:
    """One isolated concurrency pool (flowcontrol.PriorityLevelConfiguration:
    assured concurrency shares). Seat occupancy is published as gauges so
    a read storm's pressure — and the isolation protecting heartbeats and
    binds from it — is visible in /metrics and the SIGUSR2 dump."""

    name: str
    shares: int = 20
    exempt: bool = False
    _sem: Optional[threading.Semaphore] = field(default=None, repr=False)
    _seats: int = field(default=0, repr=False)
    _in_use: int = field(default=0, repr=False)
    _mu: Optional[threading.Lock] = field(default=None, repr=False)

    def setup(self, total_concurrency: int, total_shares: int) -> None:
        self._mu = threading.Lock()
        if self.exempt:
            self._sem = None
            return
        n = max(1, round(total_concurrency * self.shares / max(1, total_shares)))
        self._seats = n
        self._sem = threading.BoundedSemaphore(n)
        metrics.set_gauge(GAUGE_SEATS_TOTAL, n, {"priority_level": self.name})
        metrics.set_gauge(GAUGE_SEATS_IN_USE, 0, {"priority_level": self.name})

    def _occupy(self, delta: int) -> None:
        if self._mu is None:
            return
        with self._mu:
            self._in_use += delta
            metrics.set_gauge(
                GAUGE_SEATS_IN_USE, self._in_use, {"priority_level": self.name}
            )


@dataclass
class FlowSchema:
    """Maps requests to a priority level (flowcontrol.FlowSchema). The
    matcher sees (user, resource, verb); user may be None (anonymous)."""

    name: str
    priority_level: str
    match: Callable = lambda user, resource, verb: True


def _is_system_user(user) -> bool:
    return user is not None and (
        user.name.startswith("system:kube-")
        or user.name.startswith("system:node")
        or "system:nodes" in user.groups
    )


def default_levels() -> List[PriorityLevel]:
    # bootstrap levels (apiserver/pkg/apis/flowcontrol/bootstrap): shares
    # proportioned like the reference's defaults, plus a dedicated pool
    # for watch INITIALIZATION (list-from-cache replay + window replay):
    # 10k cold informers connecting at once contend for watch-init seats
    # against each other, never against the system pool serving kubelet
    # heartbeats and scheduler binds
    return [
        PriorityLevel("exempt", exempt=True),
        PriorityLevel("system", shares=30),
        PriorityLevel("leader-election", shares=10),
        PriorityLevel("watch-init", shares=10),
        PriorityLevel("workload-high", shares=40),
        PriorityLevel("global-default", shares=20),
    ]


def default_schemas() -> List[FlowSchema]:
    # watch-init sits AFTER the system schemas: a system component's watch
    # re-establishment rides its protected pool, while workload informers'
    # watch inits — the storm-shaped traffic — are penned into watch-init
    return [
        FlowSchema(
            "exempt",
            "exempt",
            lambda u, r, v: u is not None and "system:masters" in u.groups,
        ),
        FlowSchema(
            "system-leader-election",
            "leader-election",
            lambda u, r, v: r == "leases" and _is_system_user(u),
        ),
        FlowSchema("system-nodes", "system", lambda u, r, v: _is_system_user(u)),
        FlowSchema("watch-init", "watch-init", lambda u, r, v: v == "watch"),
        FlowSchema(
            "service-accounts",
            "workload-high",
            lambda u, r, v: u is not None
            and u.name.startswith("system:serviceaccount:"),
        ),
        FlowSchema("global-default", "global-default", lambda u, r, v: True),
    ]


class RequestRejected(Exception):
    def __init__(self, level: str):
        super().__init__(
            f"too many requests at priority level {level!r}; retry later"
        )
        self.level = level


class FlowController:
    """Classify + admit. Usage:
        lv = fc.begin(user, resource, verb)   # may raise RequestRejected
        try: ... finally: fc.end(lv)
    """

    def __init__(
        self,
        total_concurrency: int = 400,
        queue_wait_s: float = 0.05,
        levels: Optional[Sequence[PriorityLevel]] = None,
        schemas: Optional[Sequence[FlowSchema]] = None,
    ):
        self.levels = {l.name: l for l in (levels or default_levels())}
        self.schemas = list(schemas or default_schemas())
        self._warned_schemas: set = set()
        self.queue_wait_s = queue_wait_s
        total_shares = sum(l.shares for l in self.levels.values() if not l.exempt)
        for l in self.levels.values():
            l.setup(total_concurrency, total_shares)

    def classify(self, user, resource: str, verb: str) -> PriorityLevel:
        for s in self.schemas:
            if s.match(user, resource, verb):
                lv = self.levels.get(s.priority_level)
                if lv is not None:
                    return lv
                if s.name not in self._warned_schemas:
                    # once per schema: this fires on EVERY matching request
                    self._warned_schemas.add(s.name)
                    logger.warning(
                        "FlowSchema %s references unknown priority level %s",
                        s.name,
                        s.priority_level,
                    )
        # fail-CLOSED fallback: global-default (or any throttled level),
        # never the dict's first entry — with default_levels() that is
        # 'exempt', which would silently unlimit misconfigured traffic
        lv = self.levels.get("global-default")
        if lv is not None:
            return lv
        non_exempt = [l for l in self.levels.values() if not l.exempt]
        return non_exempt[0] if non_exempt else next(iter(self.levels.values()))

    def begin(self, user, resource: str, verb: str) -> PriorityLevel:
        lv = self.classify(user, resource, verb)
        if lv.exempt or lv._sem is None:
            return lv
        # bounded queuing: a short FIFO wait absorbs bursts (the queued
        # request IS the reference's queued request; the wait bound is its
        # queue-length limit), then reject
        if not lv._sem.acquire(timeout=self.queue_wait_s):
            metrics.inc(
                "apiserver_flowcontrol_rejected_requests_total",
                {"priority_level": lv.name},
            )
            raise RequestRejected(lv.name)
        metrics.inc(
            "apiserver_flowcontrol_dispatched_requests_total",
            {"priority_level": lv.name},
        )
        lv._occupy(+1)
        return lv

    def end(self, level: PriorityLevel) -> None:
        if not level.exempt and level._sem is not None:
            level._sem.release()
            level._occupy(-1)
