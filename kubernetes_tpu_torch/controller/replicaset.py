"""ReplicaSet controller: keep spec.replicas pods alive.

Reference: pkg/controller/replicaset/replica_set.go — the canonical
informer + workqueue + reconcile loop (syncReplicaSet): diff desired vs
actual matching pods, create/delete with owner references, update status.
"""

from __future__ import annotations

import copy
import logging
import threading
import uuid
from typing import List

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from ..runtime.watch import BOOKMARK
from ..client.workqueue import RateLimitingQueue

logger = logging.getLogger("kubernetes_tpu.controller.replicaset")


class ReplicaSetController:
    # parameterized so ReplicationControllerController shares the identical
    # reconcile core (the reference implements RC as a thin wrapper over the
    # same logic, pkg/controller/replication)
    resource = "replicasets"
    owner_kind = "ReplicaSet"

    def __init__(self, server, resync_period: float = 5.0, workers: int = 2):
        self.server = server
        self.resync = resync_period
        self.queue = RateLimitingQueue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.workers = workers

    def start(self) -> None:
        t = threading.Thread(target=self._watch_loop, daemon=True, name="rs-watch")
        t.start()
        self._threads.append(t)
        for i in range(self.workers):
            w = threading.Thread(
                target=self._worker, daemon=True, name=f"rs-worker-{i}"
            )
            w.start()
            self._threads.append(w)

    def stop(self) -> None:
        self._stop.set()
        self.queue.shut_down()

    # -- event plumbing ------------------------------------------------------

    def _watch_loop(self) -> None:
        from ..client.apiserver import list_and_watch

        def seed(sets):
            for rs in sets:
                self.queue.add(rs.metadata.key)

        rs_watch = list_and_watch(self.server, self.resource, seed)
        pod_watch = list_and_watch(self.server, "pods", lambda _p: None)
        while not self._stop.is_set():
            ev = rs_watch.get(timeout=0.2)
            if ev is not None and ev.type in ("ADDED", "MODIFIED"):
                self.queue.add(ev.object.metadata.key)
            pev = pod_watch.get(timeout=0.05)
            if pev is not None and pev.type != BOOKMARK:
                owner = next(
                    (
                        r
                        for r in pev.object.metadata.owner_references
                        if r.kind == self.owner_kind
                    ),
                    None,
                )
                if owner is not None:
                    self.queue.add(
                        f"{pev.object.metadata.namespace}/{owner.name}"
                    )
        rs_watch.stop()
        pod_watch.stop()

    def _worker(self) -> None:
        while not self._stop.is_set():
            key = self.queue.get(timeout=0.5)
            if key is None:
                continue
            try:
                self._sync(key)
                self.queue.forget(key)
            except Exception:
                logger.exception("sync %s failed", key)
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)

    # -- reconcile -----------------------------------------------------------

    def _sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            rs = self.server.get(self.resource, ns, name)
        except NotFound:
            return  # GC deletes orphans
        pods, _ = self.server.list("pods", namespace=ns)
        mine = [
            p
            for p in pods
            if p.metadata.deletion_timestamp is None
            and any(
                r.kind == self.owner_kind and r.name == name
                for r in p.metadata.owner_references
            )
        ]
        want = rs.spec.replicas
        have = len(mine)
        if have < want:
            for _ in range(want - have):
                self._create_pod(rs)
        elif have > want:
            for victim in mine[: have - want]:
                try:
                    self.server.delete("pods", ns, victim.metadata.name)
                except NotFound:
                    pass

        def update_status(cur):
            ready = sum(
                1 for p in mine if p.status.phase == v1.POD_RUNNING
            )
            if (
                cur.status.replicas == max(have, want)
                and cur.status.ready_replicas == ready
            ):
                return None
            cur.status.replicas = have if have > want else want
            cur.status.ready_replicas = ready
            cur.status.observed_generation = cur.metadata.generation
            return cur

        try:
            self.server.guaranteed_update(self.resource, ns, name, update_status)
        except NotFound:
            pass

    def _create_pod(self, rs: v1.ReplicaSet) -> None:
        tmpl = rs.spec.template
        pod = v1.Pod(
            metadata=v1.ObjectMeta(
                name=f"{rs.metadata.name}-{uuid.uuid4().hex[:5]}",
                namespace=rs.metadata.namespace,
                labels=dict(tmpl.metadata.labels or rs.spec.selector),
                owner_references=[
                    v1.OwnerReference(
                        kind=self.owner_kind,
                        name=rs.metadata.name,
                        uid=rs.metadata.uid,
                        controller=True,
                    )
                ],
            ),
            spec=copy.deepcopy(tmpl.spec),
        )
        try:
            self.server.create("pods", pod)
        except AlreadyExists:
            pass


class ReplicationControllerController(ReplicaSetController):
    """ReplicationController loop: the same reconcile over the older core
    kind (pkg/controller/replication wraps the replicaset core identically)."""

    resource = "replicationcontrollers"
    owner_kind = "ReplicationController"
