"""Watch cache: one store watch per kind, fanned out to N client watchers.

Reference: staging/src/k8s.io/apiserver/pkg/storage/cacher/cacher.go — the
layer that lets one apiserver serve production fleets of informers without
every watch (and every reconnect) touching the storage backend. Per kind:

  * the CURRENT object state (a map the cache keeps in lockstep with the
    store by consuming exactly ONE store watch), so lists with
    resourceVersion=0 / limit / continue are served from memory;
  * a resourceVersion-ordered ring buffer of recent events (the
    ``watchcache`` event window, watch_cache.go's cyclic buffer): a client
    reconnecting at an rv still inside the window replays the missed
    events from the buffer — no store touch, no re-list; a client older
    than the window gets a proper 410 Expired;
  * periodic BOOKMARK events (bookmark.go) that advance idle clients'
    resume positions so the window stays usable for them;
  * per-client bounded queues with slow-watcher termination
    (cacher.go's terminateAllWatchers discipline, per watcher): one stuck
    reader must never stall the dispatch loop for everyone else.

The cache is read-path only. Writes go straight to the store; the cache
learns of them through its own watch like any other watcher, which is why
a degraded (read-only) or briefly unreachable store never interrupts
cache-served reads and watches — the window simply stops growing.

``Cacher`` is interface-compatible with the store for the read surface
(list/watch/get) and delegates everything else, so a SharedInformer — or a
whole hollow-node fleet — can take a Cacher wherever it took an APIServer.
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..client.apiserver import Expired
from ..runtime.watch import ADDED, BOOKMARK, DELETED, Event, Watcher
from ..testing.lockgraph import named_lock, track_attrs
from ..utils.metrics import metrics

logger = logging.getLogger("kubernetes_tpu.apiserver.cacher")

# event-window length per kind: how many events a disconnected client may
# miss and still resume without a re-list
DEFAULT_WINDOW = 8192
DEFAULT_BOOKMARK_PERIOD_S = 2.0
# continuation snapshots: at most this many in-flight paginated lists per
# kind, each good for CONTINUE_TTL_S (an expired token 410s, like the
# reference's expired continue tokens)
CONTINUE_MAX = 128
CONTINUE_TTL_S = 300.0

GAUGE_SIZE = "watch_cache_size"                       # {kind}
GAUGE_FANOUT = "watch_cache_fanout_clients"           # {kind}
GAUGE_WINDOW_FLOOR = "watch_cache_window_floor_rv"    # {kind}
COUNTER_REPLAYS = "watch_cache_replays_total"         # {kind}
COUNTER_EXPIRED = "watch_cache_expired_total"         # {kind}
COUNTER_EVENTS = "watch_cache_events_total"           # {kind}
COUNTER_BOOKMARKS = "watch_cache_bookmarks_total"     # {kind}
COUNTER_SLOW_EVICTED = "watch_cache_slow_watchers_evicted_total"  # {kind}
COUNTER_RESYNCS = "watch_cache_resyncs_total"         # {kind}
COUNTER_LIST_PAGES = "watch_cache_list_pages_total"   # {kind}
COUNTER_DISPATCH_ERRORS = "watch_cache_dispatch_errors_total"  # {kind}


def bookmark_object(kind: str, rv: int) -> Any:
    """The rv-only object a BOOKMARK event carries. Duck-typed with the
    fields naive watch consumers touch before they branch on event type
    (metadata.key/labels/owner_references, spec.node_name), so a consumer
    that merely ignores unknown types can't crash on the carrier."""
    return SimpleNamespace(
        metadata=SimpleNamespace(
            resource_version=rv,
            namespace=None,
            name="",
            key="",
            uid="",
            labels={},
            owner_references=(),
        ),
        spec=SimpleNamespace(node_name=""),
    )


class CacheWatcher(Watcher):
    """One client's view of a KindCache fan-out.

    Unlike the raw store Watcher (unbounded-ish, blocking push), the
    cache watcher is BOUNDED and the dispatch loop never blocks on it: a
    queue that fills — a reader not keeping up with the event rate —
    terminates the watcher instead (the client reconnects at its last rv
    and replays from the window; cacher.go does the same). min_rv filters
    replay duplicates for clients resuming at a future rv."""

    def __init__(self, min_rv: int = 0, maxsize: int = 0):
        super().__init__(maxsize=maxsize or (DEFAULT_WINDOW + 1024))
        self.min_rv = min_rv
        self.replay_count = 0  # events queued at watch() time (REST uses
        # this to know when the init phase — and its APF seat — is over)
        self.terminated_slow = False

    def push_nonblock(self, ev: Event) -> bool:
        """Fan-out push: False (and self-termination) when the queue is
        full. Never blocks the dispatch thread."""
        if self._stopped.is_set():
            return False
        if (
            ev.type != BOOKMARK
            and ev.resource_version
            and ev.resource_version <= self.min_rv
        ):
            # already seen by this client (future-rv resume). Bookmarks
            # bypass the filter: they carry no state and an idle client
            # AT its resume rv is exactly who needs the heartbeat
            return True
        try:
            self._q.put_nowait(ev)
            return True
        except queue.Full:
            self.terminated_slow = True
            self.stop()
            return False

    # stop() and __iter__ need no overrides anymore: the non-blocking
    # sentinel put and sentinel-free termination this class pioneered in
    # PR 6 now live in the base Watcher (runtime/watch.py), enforced
    # tree-wide by graftlint's blocking-call pass.


class _Continuation:
    """Held remainder of a paginated list: the snapshot keeps serving at
    its original rv even as the live cache (and the event window — a
    "compaction" of old events) moves on."""

    __slots__ = ("rv", "items", "created")

    def __init__(self, rv: int, items: List[Any]):
        self.rv = rv
        self.items = items
        self.created = time.monotonic()


class KindCache:
    """Current state + event window for one kind, fed by ONE store watch."""

    def __init__(
        self,
        store,
        kind: str,
        window: int = DEFAULT_WINDOW,
        watcher_queue_size: int = 0,
    ):
        self.store = store
        self.kind = kind
        self.window = window
        self._watcher_queue_size = watcher_queue_size
        # per-kind locks share ONE watchdog node ("cacher.kind"): the
        # order contract is per-class, and any path ordering a kind lock
        # against the store/cache/device locks records the same edge
        self._lock = threading.Condition(named_lock("cacher.kind"))
        self._objects: Dict[str, Any] = {}
        self._ring: deque = deque()
        # window floor: the MINIMUM from_rv a reconnecting client may
        # resume at. Starts at the initial list rv (events before the
        # cache existed are unprovable); each evicted event raises it to
        # evicted_rv + 1 — i.e. a client must still be positioned at or
        # after the oldest BUFFERED event. Deliberately ONE event
        # stricter than the raw store's `from_version < evicted` check:
        # a client at exactly the last-evicted rv is at the window edge
        # and about to fall out anyway — 410 it now (the PR-6 acceptance
        # contract: reconnect at the oldest buffered rv replays,
        # reconnect one before it expires)
        self._floor = 0
        self.rv = 0
        self._watchers: List[CacheWatcher] = []
        self._continuations: "OrderedDict[str, _Continuation]" = OrderedDict()
        self._cont_seq = 0
        self._stop = threading.Event()
        self._store_watcher = None
        self._ready = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"watchcache-{kind}", daemon=True
        )
        self._thread.start()
        self._ready.wait(10.0)

    # -- store-facing side ---------------------------------------------------

    def _list_and_seed(self) -> int:
        # the seed list blocks the dispatch thread by design: the cache
        # serves nothing until it exists, and _ready gates clients
        objs, rv = self.store.list(self.kind)  # graftlint: allow-blocking(seed list gates readiness; cache serves nothing before it)
        with self._lock:
            self._objects = {o.metadata.key: o for o in objs}
            self.rv = max(self.rv, rv)
            if not self._floor:
                self._floor = rv
            metrics.set_gauge(GAUGE_SIZE, len(self._objects), {"kind": self.kind})
            self._lock.notify_all()
        return rv

    def _run(self) -> None:
        """The ONE store watch per kind. A dying stream (store restart,
        history eviction under extreme lag) resyncs: re-list, reset the
        window, and terminate connected clients — they reconnect at
        their last rv, land outside the post-gap floor, and re-list
        (the reference's terminateAllWatchers on cache error).

        The loop survives ANY exception (a failed list mid-resync, a
        malformed event in _apply): log + count + backoff + resync. A
        silently dead dispatch thread would be the worst failure mode —
        the cache would keep answering from frozen state while the
        bookmark ticker kept telling every informer the stream is
        healthy."""
        backoff = 0.05
        seeded = False
        need_resync = False
        rv = 0
        while not self._stop.is_set():
            try:
                if not seeded:
                    rv = self._list_and_seed()
                    seeded = True
                    self._ready.set()
                elif need_resync:
                    metrics.inc(COUNTER_RESYNCS, {"kind": self.kind})
                    rv = self._resync()
                need_resync = True  # every path back here re-syncs
                try:
                    self._store_watcher = self.store.watch(  # graftlint: allow-blocking(re-arming the ONE upstream watch IS this thread's job)
                        self.kind, from_version=rv
                    )
                except Expired:
                    continue
                for ev in self._store_watcher:
                    if self._stop.is_set():
                        return
                    self._apply(ev)
                    rv = max(rv, ev.resource_version)
                    backoff = 0.05
            except Exception:
                if self._stop.is_set():
                    return
                logger.exception(
                    "watch cache for %s: dispatch error; resyncing",
                    self.kind,
                )
                metrics.inc(COUNTER_DISPATCH_ERRORS, {"kind": self.kind})
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 5.0)

    def _apply(self, ev: Event) -> None:
        if ev.type == BOOKMARK:
            # the upstream may itself be a cacher fan-out (a stateless
            # frontend watching the primary over REST): its bookmarks are
            # rv-only progress notifies, NOT state — storing the carrier
            # object would serve a ghost in every list. Advance the rv
            # (freshness waits see the progress) and drop the event; this
            # cache's own bookmark ticker keeps its clients advancing.
            with self._lock:
                self.rv = max(self.rv, ev.resource_version)
                self._lock.notify_all()
            return
        key = ev.object.metadata.key
        ev.ts = time.monotonic()
        with self._lock:
            if ev.type == DELETED:
                self._objects.pop(key, None)
            else:
                self._objects[key] = ev.object
            self._ring.append(ev)
            if len(self._ring) > self.window:
                evicted = self._ring.popleft()
                self._floor = max(self._floor, evicted.resource_version + 1)
                metrics.set_gauge(
                    GAUGE_WINDOW_FLOOR, self._floor, {"kind": self.kind}
                )
            self.rv = max(self.rv, ev.resource_version)
            metrics.inc(COUNTER_EVENTS, {"kind": self.kind})
            metrics.set_gauge(GAUGE_SIZE, len(self._objects), {"kind": self.kind})
            self._fanout(ev)
            self._lock.notify_all()

    def _resync(self) -> int:
        """Re-list and reset the window after the cache's own store
        stream died. The event gap cannot be reconstructed faithfully
        (synthetic diffs would share one rv — a client flapping mid-batch
        could resume past the undelivered remainder and desync forever),
        so this does what the reference does: floor jumps to the list rv
        and every connected watcher is TERMINATED. Clients reconnect at
        their pre-gap rv, get a 410, and re-list — a visible, bounded
        cost instead of a silent inconsistency."""
        objs, rv = self.store.list(self.kind)  # graftlint: allow-blocking(resync re-list: the cache is stale until it completes anyway)
        with self._lock:
            self._objects = {o.metadata.key: o for o in objs}
            self.rv = max(self.rv, rv)
            self._ring.clear()
            self._floor = max(self._floor, rv)
            metrics.set_gauge(GAUGE_WINDOW_FLOOR, self._floor, {"kind": self.kind})
            metrics.set_gauge(GAUGE_SIZE, len(self._objects), {"kind": self.kind})
            for w in self._watchers:
                w.stop()
            self._watchers.clear()
            metrics.set_gauge(GAUGE_FANOUT, 0, {"kind": self.kind})
            self._lock.notify_all()
        return rv

    def _fanout(self, ev: Event) -> None:
        """Push to every live client queue; drop the dead and terminate
        the stuck. Caller holds the lock."""
        dead: List[CacheWatcher] = []
        for w in self._watchers:
            if w.stopped or not w.push_nonblock(ev):
                dead.append(w)
        if dead:
            for w in dead:
                if w.terminated_slow:
                    metrics.inc(COUNTER_SLOW_EVICTED, {"kind": self.kind})
                try:
                    self._watchers.remove(w)
                except ValueError:
                    pass
            metrics.set_gauge(
                GAUGE_FANOUT, len(self._watchers), {"kind": self.kind}
            )

    # -- client-facing side --------------------------------------------------

    def watch(
        self, from_version: int = 0, queue_size: int = 0
    ) -> CacheWatcher:
        """A fan-out watcher, with RV-windowed replay.

        from_version=0: the reference's rv="0" watch — the CURRENT cached
        state is delivered first as synthetic ADDED events (key order),
        then live events follow; a connect racing the writes still sees
        every object exactly once.
        from_version >= window floor: buffered events with rv >
        from_version replay from the ring (no store touch, no re-list).
        from_version < floor: Expired (410) — the client must re-list."""
        with self._lock:
            if from_version and from_version < self._floor:
                metrics.inc(COUNTER_EXPIRED, {"kind": self.kind})
                raise Expired(
                    f"{self.kind} resourceVersion {from_version} is outside "
                    f"the watch-cache window (floor rv {self._floor})"
                )
            if from_version:
                replay = [
                    ev
                    for ev in self._ring
                    if ev.resource_version > from_version
                ]
                if replay:
                    metrics.inc(COUNTER_REPLAYS, {"kind": self.kind})
            else:
                now = time.monotonic()
                replay = [
                    Event(ADDED, obj, obj.metadata.resource_version, ts=now)
                    for _key, obj in sorted(self._objects.items())
                ]
                if self.rv:
                    # close the initial state with a bookmark at the CACHE
                    # rv: surviving objects' rvs can lag it (deletions),
                    # and a client that flapped before the first periodic
                    # bookmark would otherwise resume below the state it
                    # already saw and replay ghost events from the ring
                    replay.append(
                        Event(
                            BOOKMARK,
                            bookmark_object(self.kind, self.rv),
                            self.rv,
                            ts=now,
                        )
                    )
            # the queue must FIT the initial replay: the slow-watcher
            # bound protects the live fan-out, but self-terminating
            # inside one's own replay would silently truncate initial
            # state (e.g. an rv=0 watch of a 10k-object kind). The
            # configured size bounds the LIVE backlog on top of it.
            w = CacheWatcher(
                min_rv=from_version,
                maxsize=len(replay)
                + (
                    queue_size
                    or self._watcher_queue_size
                    or (DEFAULT_WINDOW + 1024)
                ),
            )
            for ev in replay:
                w.push_nonblock(ev)
            w.replay_count = len(replay)
            self._watchers.append(w)
            metrics.set_gauge(
                GAUGE_FANOUT, len(self._watchers), {"kind": self.kind}
            )
            return w

    def bookmark(self) -> None:
        """Push one BOOKMARK carrying the cache's current rv to every
        client (bookmark.go's periodic progress notify): idle clients'
        resume positions advance past window evictions."""
        with self._lock:
            if not self._watchers:
                return
            ev = Event(
                BOOKMARK,
                bookmark_object(self.kind, self.rv),
                self.rv,
                ts=time.monotonic(),
            )
            metrics.inc(
                COUNTER_BOOKMARKS, {"kind": self.kind}, by=len(self._watchers)
            )
            self._fanout(ev)

    def wait_until_fresh(self, rv: int, timeout: float = 5.0) -> bool:
        """Block until the cache has seen rv (waitUntilFreshAndList): a
        consistent read served from memory instead of the store."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self.rv < rv:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return self.rv >= rv
                self._lock.wait(remaining)
        return True

    def list_snapshot(
        self,
        namespace: Optional[str] = None,
        pred: Optional[Callable[[Any], bool]] = None,
    ) -> Tuple[List[Any], int]:
        """Matching objects (cache references — treat as read-only),
        key-sorted, plus the single rv the whole list is consistent at."""
        with self._lock:
            objs = [
                o
                for _k, o in sorted(self._objects.items())
                if (namespace is None or o.metadata.namespace == namespace)
                and (pred is None or pred(o))
            ]
            return objs, self.rv

    def list_page(
        self,
        namespace: Optional[str] = None,
        pred: Optional[Callable[[Any], bool]] = None,
        limit: int = 0,
        continue_token: Optional[str] = None,
    ) -> Tuple[List[Any], int, Optional[str]]:
        """(items, rv, next_continue). Pagination is consistent at a
        single rv: the first page snapshots the matching set; later pages
        serve the HELD snapshot, so object churn — and event-window
        compaction — between pages never tears the list. An unknown or
        expired token raises Expired (the client restarts the list),
        matching the reference's expired-continue contract."""
        with self._lock:
            self._expire_continuations()
            if continue_token:
                cont = self._continuations.pop(continue_token, None)
                if cont is None:
                    metrics.inc(COUNTER_EXPIRED, {"kind": self.kind})
                    raise Expired(
                        f"{self.kind} continue token is expired or unknown"
                    )
                items, rv, rest = (
                    cont.items[:limit] if limit else cont.items,
                    cont.rv,
                    cont.items[limit:] if limit else [],
                )
            else:
                objs, rv = self.list_snapshot(namespace, pred)
                items = objs[:limit] if limit else objs
                rest = objs[limit:] if limit else []
            metrics.inc(COUNTER_LIST_PAGES, {"kind": self.kind})
            if not rest:
                return items, rv, None
            self._cont_seq += 1
            token = base64.urlsafe_b64encode(
                json.dumps({"rv": rv, "c": self._cont_seq}).encode()
            ).decode()
            self._continuations[token] = _Continuation(rv, rest)
            while len(self._continuations) > CONTINUE_MAX:
                self._continuations.popitem(last=False)
            return items, rv, token

    def _expire_continuations(self) -> None:
        now = time.monotonic()
        stale = [
            t
            for t, c in self._continuations.items()
            if now - c.created > CONTINUE_TTL_S
        ]
        for t in stale:
            self._continuations.pop(t, None)

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._objects.get(key)

    @property
    def floor(self) -> int:
        with self._lock:
            return self._floor

    @property
    def current_rv(self) -> int:
        """The cache's high-water rv, read under the kind lock (the bare
        `.rv` attribute is for lock-holding internals; the guarded-by
        contract keeps outside readers off it)."""
        with self._lock:
            return self.rv

    def stats_snapshot(self) -> dict:
        """One-lock snapshot of the per-kind observability counters —
        Cacher.stats() used to read `_objects`/`_ring` bare, exactly the
        unguarded minority access the lockset sanitizer now rejects.
        The fan-out prune/count folds into the SAME lock hold so the
        row's size/rv/fanout values all coexist at one instant."""
        with self._lock:
            self._watchers = [w for w in self._watchers if not w.stopped]
            metrics.set_gauge(
                GAUGE_FANOUT, len(self._watchers), {"kind": self.kind}
            )
            return {
                "size": len(self._objects),
                "rv": self.rv,
                "window_floor": self._floor,
                "window_used": len(self._ring),
                "fanout_clients": len(self._watchers),
            }

    def fanout_clients(self) -> int:
        return self.stats_snapshot()["fanout_clients"]

    def stop(self) -> None:
        self._stop.set()
        sw = self._store_watcher
        if sw is not None:
            sw.stop()
        with self._lock:
            for w in self._watchers:
                w.stop()
            self._watchers.clear()
            self._lock.notify_all()


class Cacher:
    """Per-kind KindCaches behind one store, plus the bookmark ticker.

    Read-surface compatible with APIServer (list/watch — the two calls a
    SharedInformer makes) and attribute-delegating for everything else,
    so read-heavy clients can be pointed at the cache wholesale."""

    def __init__(
        self,
        store,
        window: int = DEFAULT_WINDOW,
        bookmark_period_s: float = DEFAULT_BOOKMARK_PERIOD_S,
        watcher_queue_size: int = 0,
        freshness_timeout_s: float = 5.0,
    ):
        self._store = store
        self.window = window
        self.bookmark_period_s = bookmark_period_s
        # how long a consistent list waits for the cache to catch the
        # demanded rv before 504ing (follower frontends: the commit-
        # index wait) — configurable so lagging replicas fail fast
        # where the deployment wants them to
        self.freshness_timeout_s = freshness_timeout_s
        self._watcher_queue_size = watcher_queue_size
        self._caches: Dict[str, KindCache] = {}
        # named for the lock-order watchdog + lockset sanitizer
        self._lock = named_lock("cacher.top")
        self._stop = threading.Event()
        self._bookmark_thread = threading.Thread(
            target=self._bookmark_loop, name="watchcache-bookmarks", daemon=True
        )
        self._bookmark_thread.start()

    @property
    def store(self):
        return self._store

    def __getattr__(self, name: str):
        # write path / typed helpers pass straight through to the store
        return getattr(self._store, name)

    def cache_for(self, kind: str) -> KindCache:
        with self._lock:
            kc = self._caches.get(kind)
            if kc is None:
                kc = KindCache(
                    self._store,
                    kind,
                    window=self.window,
                    watcher_queue_size=self._watcher_queue_size,
                )
                self._caches[kind] = kc
            return kc

    def has_cache(self, kind: str) -> bool:
        with self._lock:
            return kind in self._caches

    # -- read surface --------------------------------------------------------

    def watch(self, kind: str, from_version: int = 0) -> CacheWatcher:
        return self.cache_for(kind).watch(from_version)

    def list(
        self, kind: str, namespace: Optional[str] = None
    ) -> Tuple[List[Any], int]:
        """Store-compatible list FROM CACHE (deep copies: callers mutate
        informer-cached objects). rv is the cache's own high-water mark —
        pair it with watch() on the same Cacher and no event is missed."""
        objs, rv = self.cache_for(kind).list_snapshot(namespace)
        return [copy.deepcopy(o) for o in objs], rv

    def list_page(
        self,
        kind: str,
        namespace: Optional[str] = None,
        pred: Optional[Callable[[Any], bool]] = None,
        limit: int = 0,
        continue_token: Optional[str] = None,
        fresh_rv: Optional[int] = None,
    ) -> Tuple[List[Any], int, Optional[str]]:
        kc = self.cache_for(kind)
        if fresh_rv and not kc.wait_until_fresh(
            fresh_rv, timeout=self.freshness_timeout_s
        ):
            # never serve stale data labeled consistent: the reference's
            # waitUntilFreshAndList times out ("Too large resource
            # version") instead — callers surface it as a retryable 504
            raise TimeoutError(
                f"{kind} watch cache not fresh: have rv "
                f"{kc.current_rv}, need {fresh_rv}"
            )
        return kc.list_page(
            namespace=namespace,
            pred=pred,
            limit=limit,
            continue_token=continue_token,
        )

    def current_rv(self, kind: str) -> int:
        return self.cache_for(kind).current_rv

    # -- bookmarks -----------------------------------------------------------

    def _bookmark_loop(self) -> None:
        while not self._stop.wait(self.bookmark_period_s):
            with self._lock:
                caches = list(self._caches.values())
            for kc in caches:
                try:
                    kc.bookmark()
                except Exception:  # never kill the ticker
                    pass

    # -- lifecycle / observability ------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            caches = list(self._caches.values())
            self._caches.clear()
        for kc in caches:
            kc.stop()

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            caches = dict(self._caches)
        return {kind: kc.stats_snapshot() for kind, kc in caches.items()}


# lockset sanitizer (testing/lockgraph.py Eraser mode): per-kind cache
# state is written by the ONE dispatch thread and read by every client
# list/watch/stats path — all under `cacher.kind`; the Cacher's kind map
# under `cacher.top`. Chaos readpath storms assert the locksets never
# go empty.
track_attrs(
    KindCache,
    "_objects",
    "_ring",
    "_floor",
    "rv",
    "_watchers",
    "_continuations",
    "_cont_seq",
)
track_attrs(Cacher, "_caches")


def readpath_health_lines() -> List[str]:
    """watch-cache + flow-control read-path state for the SIGUSR2 dump:
    cache sizes, fan-out widths, replay/expiry counters, and APF seat
    occupancy — a read storm is diagnosable from one signal. Empty when
    no cache has served anything yet."""
    lines: List[str] = []
    for snap in (
        metrics.snapshot_gauges("watch_cache_"),
        metrics.snapshot_counters("watch_cache_"),
        metrics.snapshot_gauges("apiserver_flowcontrol_seats"),
        metrics.snapshot_gauges("apiserver_watch_streams"),
        # the whole informer_ family (bookmarks, relists, resumes): a
        # per-counter list here is exactly the drift the metrics lint
        # exists to catch — resumes was missing until it did
        metrics.snapshot_counters("informer_"),
    ):
        for name, labels, value in snap:
            lines.append(metrics.format_series_line(name, labels, value))
    return lines
