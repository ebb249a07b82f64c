"""Shared controller skeleton: watch loop → rate-limited workqueue → workers.

Every reference controller follows the same informer + workqueue + reconcile
shape (pkg/controller/replicaset/replica_set.go is the canonical example);
this base factors the thread plumbing so each controller is just its watch
wiring (`watch_kinds` / `enqueue_for_event`) and its reconcile (`sync`).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence

from ..api import objects as v1
from ..client.workqueue import RateLimitingQueue
from ..runtime.watch import BOOKMARK

logger = logging.getLogger("kubernetes_tpu.controller")


class WorkqueueController:
    """Subclasses set `name`, `primary_kind` (resource name whose objects'
    keys are the queue items) and implement `sync(key)`; override
    `enqueue_for_related(event_obj) -> key|None` per secondary kind."""

    name = "controller"
    primary_kind = ""
    # resource name -> method name to derive the primary key from an event
    secondary_kinds: Sequence[str] = ("pods",)

    def __init__(self, server, workers: int = 2):
        self.server = server
        self.queue = RateLimitingQueue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.workers = workers

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        t = threading.Thread(
            target=self._watch_loop, daemon=True, name=f"{self.name}-watch"
        )
        t.start()
        self._threads.append(t)
        for i in range(self.workers):
            w = threading.Thread(
                target=self._worker, daemon=True, name=f"{self.name}-worker-{i}"
            )
            w.start()
            self._threads.append(w)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()

    def start_ticker(self, name: str, period: float, fn) -> None:
        """Guarded periodic thread: time-driven controllers (expirations,
        resyncs, world sweeps) enqueue work on a clock, and ONE transient
        error must never kill the clock."""

        def loop():
            while not self._stop.wait(period):
                try:
                    fn()
                except Exception:
                    logger.exception("%s tick failed", name)

        t = threading.Thread(target=loop, daemon=True, name=name)
        t.start()
        self._threads.append(t)

    # -- event plumbing ------------------------------------------------------

    def primary_key_of(self, obj) -> str:
        """Queue key for a primary-kind event. Controllers whose sync
        rebuilds WORLD state (not per-object state) override this to a
        constant so the rate-limited queue collapses event bursts into one
        reconcile (the reference's desired-state-of-world populator)."""
        return obj.metadata.key

    def _watch_loop(self) -> None:
        from ..client.apiserver import list_and_watch

        def seed(objs):
            for o in objs:
                key = self.primary_key_of(o)
                if key:
                    self.queue.add(key)

        primary_watch = list_and_watch(self.server, self.primary_kind, seed)
        sec_watches = [
            (res, list_and_watch(self.server, res, lambda _objs: None))
            for res in self.secondary_kinds
        ]
        while not self._stop.is_set():
            # block briefly on the primary, then DRAIN all streams — one
            # event per tick would cap secondary throughput at ~5/s and
            # leave endpoints/PDB status minutes behind a pod burst
            ev = primary_watch.get(timeout=0.1)
            while ev is not None:
                # BOOKMARK = rv-only progress notify from the watch cache;
                # controllers track no resume position, so skip
                if ev.type != BOOKMARK:
                    key = self.primary_key_of(ev.object)
                    if key:
                        # falsy key = controller filtered the event out
                        self.queue.add(key)
                ev = primary_watch.get(timeout=0)
            for res, w in sec_watches:
                sev = w.get(timeout=0)
                while sev is not None:
                    if sev.type != BOOKMARK:
                        key = self.enqueue_for_related(res, sev.object)
                        if key:
                            self.queue.add(key)
                    sev = w.get(timeout=0)
        primary_watch.stop()
        for _, w in sec_watches:
            w.stop()

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        """Default: map a pod event to its controller owner of `owner_kind`."""
        owner = self.controller_owner(obj, self.owner_kind)
        if owner is not None:
            return f"{obj.metadata.namespace}/{owner.name}"
        return None

    owner_kind = ""  # e.g. "ReplicaSet" — used by the default enqueue

    @staticmethod
    def controller_owner(obj, kind: str) -> Optional[v1.OwnerReference]:
        return next(
            (
                r
                for r in obj.metadata.owner_references
                if r.controller and r.kind == kind
            ),
            None,
        )

    # -- reconcile plumbing --------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.5)
            if key is None:
                continue
            try:
                self.sync(key)
                self.queue.forget(key)
            except Exception:
                logger.exception("%s: sync %s failed", self.name, key)
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)

    def sync(self, key: str) -> None:
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------

    def owned_pods(self, namespace: str, owner_kind: str, owner_name: str):
        pods, _ = self.server.list("pods", namespace=namespace)
        return [
            p
            for p in pods
            if p.metadata.deletion_timestamp is None
            and any(
                r.controller and r.kind == owner_kind and r.name == owner_name
                for r in p.metadata.owner_references
            )
        ]


from ..api.selectors import match_labels  # noqa: E402 — re-export for controllers


def pod_is_ready(pod: v1.Pod) -> bool:
    """podutil.IsPodReady: the Ready condition when the node agent posts
    one (readiness probes), else Running phase stands in (pods with no
    probe are Ready as soon as they run)."""
    if pod.status.phase != v1.POD_RUNNING:
        return False
    for c in pod.status.conditions:
        if c.type == v1.COND_POD_READY:
            return c.status == "True"
    return True
