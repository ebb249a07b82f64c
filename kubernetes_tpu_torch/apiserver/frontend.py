"""Horizontally scaled serving tier: stateless frontends + follower reads.

Reference shape: the upstream serving tier is a composed chain of
stateless apiservers over a shared storage/watch layer (PAPER.md layer 4,
``CreateServerChain`` / aggregator composition, ``storage/cacher``) —
scale-out happens by adding frontends, not by fattening one server. Here:

  * **Stateless frontend** (:func:`serve_frontend`): a full REST façade
    (apiserver/rest.py) whose "store" is a pooled :class:`RESTClient`
    pointed at the primary. The frontend owns its OWN ``Cacher``: every
    watch stream and rv=0/paginated list it serves costs the primary ONE
    upstream watch per kind, writes delegate upstream verbatim (the
    leadership-fence header included — the /binding route re-attaches
    it), and consistent lists wait on the PRIMARY's per-kind rv through
    the chained ``kindResourceVersion`` probe. Frontends hold no durable
    state: kill one and its clients resume on a sibling through the
    balancer, replaying from that sibling's watch-cache window.
  * **Follower reads** (:class:`FollowerReadStore`,
    :func:`serve_follower_frontend`): a consensus follower already holds
    the durable log — attach a watch cache to it and list/watch traffic
    never touches the primary at all. The store adapter exposes the
    replica's state through the standard store read surface, with one
    hard rule: watch events are released only once the COMMIT INDEX
    covers them (etcd fires watch events post-commit for the same
    reason), so the per-kind cache rv *is* the committed rv and the
    PR-6 ``wait_until_fresh`` seam generalizes verbatim into "wait until
    my commit index ≥ the rv the client demands". Writes, point gets,
    and lease operations delegate to the primary — a lease served from a
    lagging replica could hand two electors the same grant.

The balancer in front of the fleet is
``kubernetes_tpu.testing.netchaos.LoadBalancerProxy`` — the netchaos
proxy machinery run in reverse (one listener, N upstreams).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..client.apiserver import Expired, NotPrimary
from ..runtime.watch import ADDED, DELETED, MODIFIED, Event, Watcher
from ..testing.lockgraph import named_lock
from ..utils.metrics import metrics

# events a follower read store buffers per kind for watch(from_version)
# replay across the list->watch gap (the cacher's own window does the
# long-haul replay; this ring only bridges cache resyncs)
FOLLOWER_HISTORY = 4096

GAUGE_FOLLOWER_COMMIT_LAG = "follower_read_commit_lag"
COUNTER_FOLLOWER_EVENTS = "follower_read_events_total"  # {kind}

_VERB_TO_EVENT = {"create": ADDED, "delete": DELETED}


class _MinRvWatcher(Watcher):
    """Store-side watcher with a resume floor: events at or below the
    caller's from_version are already in its seed list."""

    def __init__(self, min_rv: int):
        super().__init__()
        self.min_rv = min_rv

    def push_event(self, ev: Event) -> None:
        if ev.resource_version > self.min_rv:
            self.push(ev)


class FollowerReadStore:
    """The store read surface over a replication Follower, commit-gated.

    Read path (served locally, no primary touch):
      * ``list(kind)``: the replica's applied objects, labeled with the
        COMMITTED rv (state may run slightly ahead of the label — the
        uncommitted tail arrives later as events; a reader is never told
        a write is consistent before a quorum holds it).
      * ``watch(kind, from_version)``: applied records are parked until
        the learned commit index covers them, then fan out in rv order.

    Everything else — writes, point gets (electors read leases through
    get), subresources — delegates to the primary client: only the
    fan-out-heavy surface moves to the follower.
    """

    def __init__(self, follower, primary, commit_gated: bool = True):
        self._follower = follower
        self._primary = primary
        # legacy replication (no consensus) never advances a commit
        # index; an ungated adapter treats applied as committed
        self._commit_gated = commit_gated
        self._lock = named_lock("follower.read")
        self._commit = follower.commit_index if commit_gated else 0
        # applied-but-uncommitted events, strict rv order
        self._pending: deque = deque()
        # per-kind committed-event history for watch replay + the rv of
        # the newest event evicted from each ring (410 boundary)
        self._history: Dict[str, deque] = {}
        self._evicted_rv: Dict[str, int] = {}
        self._watchers: Dict[str, List[_MinRvWatcher]] = {}
        self._committed_rv = self._commit
        follower.register_observer(self)

    # -- follower observer side ----------------------------------------------

    def on_records(self, recs: List[Tuple[int, str, str, Any]]) -> None:
        with self._lock:
            for rv, verb, kind, obj in recs:
                if obj is None:
                    continue
                ev = Event(_VERB_TO_EVENT.get(verb, MODIFIED), obj, rv)
                self._pending.append((kind, ev))
            self._flush_locked()

    def on_commit(self, commit: int) -> None:
        with self._lock:
            if commit > self._commit:
                self._commit = commit
            self._flush_locked()

    def on_snapshot(self) -> None:
        """Full state transfer: the incremental event view is invalid.
        Terminate every watcher (their consumer — the kind cache —
        resyncs from list) and reset the rings, mirroring the cacher's
        own terminateAllWatchers discipline."""
        with self._lock:
            self._pending.clear()
            for kind, ring in self._history.items():
                if ring:
                    self._evicted_rv[kind] = max(
                        self._evicted_rv.get(kind, 0),
                        ring[-1].resource_version,
                    )
                ring.clear()
            watchers = [w for ws in self._watchers.values() for w in ws]
            self._watchers.clear()
            self._committed_rv = max(self._committed_rv, self._follower.rv)
        for w in watchers:
            w.stop()

    def _flush_locked(self) -> None:
        """Release pending events the commit index now covers (or all of
        them when ungated). Caller holds the lock."""
        import time as _time

        gate = self._commit if self._commit_gated else float("inf")
        while self._pending and self._pending[0][1].resource_version <= gate:
            kind, ev = self._pending.popleft()
            ev.ts = _time.monotonic()
            self._committed_rv = max(self._committed_rv, ev.resource_version)
            ring = self._history.setdefault(
                kind, deque(maxlen=FOLLOWER_HISTORY)
            )
            if len(ring) == FOLLOWER_HISTORY and ring:
                self._evicted_rv[kind] = ring[0].resource_version
            ring.append(ev)
            metrics.inc(COUNTER_FOLLOWER_EVENTS, {"kind": kind})
            ws = self._watchers.get(kind)
            if ws:
                dead = []
                for w in ws:
                    if w.stopped:
                        dead.append(w)
                    else:
                        w.push_event(ev)
                for w in dead:
                    ws.remove(w)
        if self._commit_gated:
            metrics.set_gauge(
                GAUGE_FOLLOWER_COMMIT_LAG,
                max(self._follower.rv - self._commit, 0),
            )

    # -- store read surface ---------------------------------------------------

    def list(
        self, kind: str, namespace: Optional[str] = None
    ) -> Tuple[List[Any], int]:
        objs, rv = self._follower.list_kind(kind)
        if namespace is not None:
            objs = [o for o in objs if o.metadata.namespace == namespace]
        with self._lock:
            # label with the committed rv: the applied tail beyond it is
            # IN the objects (harmlessly fresh) but is never advertised
            # as consistent until a quorum holds it; watchers seeded from
            # this list receive the tail as events once it commits
            rv = min(rv, self._commit) if self._commit_gated else rv
        return objs, rv

    def watch(self, kind: str, from_version: int = 0) -> Watcher:
        with self._lock:
            evicted = self._evicted_rv.get(kind, 0)
            if from_version and from_version < evicted:
                raise Expired(
                    f"{kind} resourceVersion {from_version} is too old for "
                    f"the follower read ring (events up to rv {evicted} "
                    "were evicted)"
                )
            w = _MinRvWatcher(from_version)
            for ev in self._history.get(kind, ()):
                w.push_event(ev)
            self._watchers.setdefault(kind, []).append(w)
            return w

    def get(self, kind: str, namespace: str, name: str) -> Any:
        # point reads stay PRIMARY reads: the elector's lease get must
        # never observe a lagging replica (two grants from one lease),
        # and single-object reads are not the fan-out cost this tier
        # exists to absorb
        return self._primary.get(kind, namespace, name)

    def kind_resource_version(self, kind: str) -> int:
        """The PRIMARY's per-kind rv: what a consistent list through this
        follower must wait for — the freshness demand is defined by the
        leader's log, the wait is served by our commit index."""
        return self._primary.kind_resource_version(kind)

    def committed_rv(self) -> int:
        with self._lock:
            return self._committed_rv

    def wait_commit(self, rv: int, timeout: float = 5.0) -> bool:
        return self._follower.wait_commit(rv, timeout=timeout)

    def __getattr__(self, name: str):
        # write path / subresources / typed helpers -> the primary
        return getattr(self._primary, name)


# kind caches a frontend warms at startup: a COLD cache's replay floor
# starts at its seed rv, so the first client resuming onto a
# just-started (or never-before-asked) frontend would 410 into a relist
# even though no event was ever missed. Warm caches make "kill a
# frontend, resume on a sibling" replay from the window instead.
FRONTEND_WARM_KINDS = ("pods", "nodes")


def serve_frontend(
    primary_url: str,
    port: int = 0,
    timeout: float = 30.0,
    pool_connections: int = 8,
    warm_kinds: Tuple[str, ...] = FRONTEND_WARM_KINDS,
    relay_workers: int = 0,
    relay_port: int = 0,
    relay_kinds: Tuple[str, ...] = ("pods",),
    relay_hollow_clients: int = 0,
    **serve_kwargs,
):
    """One stateless REST frontend over a remote primary. Returns
    (server, port, client) — the full rest.py façade with its own watch
    cache, every upstream byte on pooled persistent connections.

    relay_workers > 0 attaches the watch-relay tier
    (kubernetes_tpu/relay/): this frontend's cacher publishes each
    relay_kinds frame once into shared memory and N SO_REUSEPORT worker
    processes own the watch-client fan-out on ``relay_port``. The
    handle hangs off ``srv.relay``; tls_cert/tls_key in serve_kwargs
    flow to both the REST port and the relay workers, so the whole
    serving hop is TLS or none of it is."""
    from .client import RESTClient
    from .rest import serve

    client = RESTClient(
        primary_url, timeout=timeout, pool_connections=pool_connections
    )
    srv, bound, _store = serve(store=client, port=port, **serve_kwargs)
    if srv.cacher is not None:
        for kind in warm_kinds:
            srv.cacher.cache_for(kind)
    srv.relay = None
    if relay_workers:
        if srv.cacher is None:
            raise ValueError("the watch relay requires the watch cache")
        from ..relay import start_relay

        tls_cert = serve_kwargs.get("tls_cert")
        tls_key = serve_kwargs.get("tls_key")
        scheme = "https" if tls_cert and tls_key else "http"
        srv.relay = start_relay(
            srv.cacher,
            f"{scheme}://127.0.0.1:{bound}",
            kinds=relay_kinds,
            n_workers=relay_workers,
            port=relay_port,
            tls_cert=tls_cert,
            tls_key=tls_key,
            hollow_clients=relay_hollow_clients,
        )
    return srv, bound, client


def serve_follower_frontend(
    follower,
    primary_url: str,
    port: int = 0,
    timeout: float = 30.0,
    commit_gated: bool = True,
    warm_kinds: Tuple[str, ...] = FRONTEND_WARM_KINDS,
    **serve_kwargs,
):
    """A follower-read REST frontend: list/watch from the replica's
    commit-gated state, writes and point gets delegated to the primary.
    Returns (server, port, read_store)."""
    from .client import RESTClient
    from .rest import serve

    primary = RESTClient(primary_url, timeout=timeout)
    store = FollowerReadStore(follower, primary, commit_gated=commit_gated)
    srv, bound, _ = serve(store=store, port=port, **serve_kwargs)
    if srv.cacher is not None:
        for kind in warm_kinds:
            srv.cacher.cache_for(kind)
    return srv, bound, store


def frontend_health_lines() -> List[str]:
    """Follower-read lag/fan-out counters for the SIGUSR2 dump."""
    lines: List[str] = []
    for snap in (
        metrics.snapshot_gauges("follower_read_"),
        metrics.snapshot_counters("follower_read_"),
    ):
        for name, labels, value in snap:
            lines.append(metrics.format_series_line(name, labels, value))
    return lines


# the balancer needs no state here, but NotPrimary is what a frontend
# surfaces when its primary link is gone mid-write; re-exported so fleet
# tooling imports one module
__all__ = [
    "FollowerReadStore",
    "serve_frontend",
    "serve_follower_frontend",
    "frontend_health_lines",
    "NotPrimary",
]
