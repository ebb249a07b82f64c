"""Lock-order watchdog: graftlint's runtime companion.

The static passes prove donation sites hold a generation lease and
dispatch loops never block — they cannot prove the LOCKS THEMSELVES are
acquired in a consistent global order. The PR-4 deadlock class (a
donating wave launch under the since-retired ``device_lock`` racing the
audit's gather under the cache lock) is an ordering property: it only
fires under the right interleaving, which a chaos run may never hit even
while the inversion sits in the code.

This module wraps the named production locks (the encoder's generation
bookkeeping lock ``encoder.gen_lock``, the scheduler cache lock, the
store lock, the watch cache's per-kind locks — each created through
:func:`named_lock`) so that, when the
watchdog is ENABLED, every successful acquisition records
``held → acquired`` edges into one process-wide lock-order graph. A new
edge that closes a cycle is a lock-order inversion — two code paths that
take the same pair of locks in opposite orders — and is recorded as a
violation immediately, even though the run did not deadlock. The chaos
suites (``make chaos-device``, ``make chaos-readpath``) enable the
watchdog for the whole module and assert the final graph is acyclic.

Disabled (production default) the wrapper costs one attribute load and
one boolean test per acquire/release. Locks of the same NAME share graph
nodes — per-kind cache locks all record as ``cacher.kind`` — which keeps
the graph readable and still catches cross-class inversions; a
same-name, cross-instance ABBA pair would be reported as a self-edge-
free cycle of length 2 only if some path orders the two names, which is
exactly the conservative behavior a watchdog wants.

Not thread-exhaustive: edges only exist for orders actually executed.
That is the point — it converts "the chaos suite happened not to
deadlock" into "no executed path can deadlock on these locks".

**Eraser mode** (the lockset sanitizer, ISSUE 12) is the watchdog's
second runtime check: where the order graph proves the locks are taken
in one order, Eraser mode proves shared attributes are taken under a
lock AT ALL. Production classes register their shared mutable
attributes with :func:`track_attrs`; each becomes a data descriptor
that, while the sanitizer is enabled, records the classic Eraser state
machine per ``(class, attr)``:

  * exclusive to the first accessing thread → nothing tracked (init
    writes are free);
  * a second thread arrives → the candidate lockset C(v) starts as the
    named locks held at that access and is intersected at every
    subsequent access from any thread;
  * C(v) empty once the attribute is shared → a RACE is recorded:
    attribute, both stack tips (the previous access and the one that
    emptied the set), and both locksets. Tracked attributes are exactly
    the ones graftlint's guarded-by pass proved lock-guarded, so a
    lock-free READ is as much a contract violation as a write — no
    write requirement, unlike classic Eraser. ``lockgraph_races_total``
    counts each distinct racy attribute once per epoch.

The same autouse fixtures that assert the order graph is acyclic assert
zero races (``assert_clean``), so `make chaos-device`, `chaos-readpath`
and `chaos-ha` now machine-check the guarded-by contract graftlint
pass 6 infers statically. Disabled (the production default) a tracked
attribute costs one descriptor indirection and one boolean test per
access; untracked attributes cost nothing.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_enabled = False
_eraser = False
_epoch = 0  # bumped by enable(): stale per-thread state self-invalidates
_graph_lock = threading.Lock()  # leaf lock: never held while acquiring others
_edges: Dict[str, Set[str]] = {}
_edge_sites: Dict[Tuple[str, str], int] = {}
_violations: List[List[str]] = []
_acquires: Dict[str, int] = {}
# Eraser state lives ON each tracked instance (__dict__[_STATE_SLOT],
# attr -> _AttrState): the exclusive-to-one-thread phase (constructor
# writes) is an INSTANCE property, and a global map keyed by id() would
# let a freed object's shared state bleed into a new instance reusing
# the same address — the long multi-suite chaos runs hit exactly that.
_STATE_SLOT = "_lockgraph_attr_state"
_attr_accesses = 0
_races: List[dict] = []
_tls = threading.local()


def _held() -> List[str]:
    """This thread's held-name stack for the CURRENT watchdog epoch.

    release() records nothing while disabled, so a thread that acquired
    under epoch N and releases after disable() would keep the name on
    its stack forever — and fabricate `stale -> X` edges (possibly a
    false cycle) in the next enabled suite in the same process. Epoch
    tagging drops such leftovers: losing a genuinely-still-held entry
    only costs a missed edge (false negative), never a false cycle."""
    if getattr(_tls, "epoch", None) != _epoch:
        _tls.epoch = _epoch
        _tls.held = []
    return _tls.held


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst in the edge graph (caller holds _graph_lock)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _edges.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_acquire(name: str) -> None:
    with _graph_lock:
        _acquires[name] = _acquires.get(name, 0) + 1
    held = _held()
    if name in held:
        held.append(name)  # re-entrant: balance the stack, no new edges
        return
    uniq = []
    for h in held:
        if h != name and h not in uniq:
            uniq.append(h)
    if uniq:
        with _graph_lock:
            for h in uniq:
                if name in _edges.get(h, ()):
                    _edge_sites[(h, name)] += 1
                    continue
                # NEW edge h -> name: closing a cycle means some other
                # path already orders name before h — an inversion
                back = _find_path(name, h)
                _edges.setdefault(h, set()).add(name)
                _edge_sites[(h, name)] = 1
                if back is not None:
                    _violations.append(back + [name])
    held.append(name)


def _record_release(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


# -- Eraser mode: the lockset sanitizer ---------------------------------------


class _AttrState:
    __slots__ = (
        "epoch",
        "first_thread",
        "shared",
        "lockset",
        "reported",
        "last_site",
        "last_lockset",
        "last_thread",
        "last_write",
    )

    def __init__(self, epoch: int, tid: object):
        self.epoch = epoch
        self.first_thread = tid
        self.shared = False
        self.lockset: Optional[Set[str]] = None
        self.reported = False
        self.last_site = "?"
        self.last_lockset: Set[str] = set()
        self.last_thread = tid
        self.last_write = False


def _thread_token() -> object:
    """Identity of the calling thread with thread-LIFETIME scope: the OS
    recycles `threading.get_ident()` values after a thread exits, so a
    raw ident could make a later thread look like the object's exclusive
    first thread and silently disarm the lockset machine. A per-thread
    sentinel object dies with the thread (thread-local storage), so it
    can never collide with a live one."""
    tok = getattr(_tls, "token", None)
    if tok is None:
        tok = _tls.token = object()
    return tok


def _attr_access(cls_name: str, attr: str, is_write: bool, obj) -> None:
    """One tracked-attribute access while the sanitizer is enabled.
    Callers are the descriptor's __get__/__set__ (stack depth 2 below
    the production access)."""
    global _attr_accesses
    tid = _thread_token()
    held = set(_held())
    frame = sys._getframe(2)
    site = f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"
    states = obj.__dict__.setdefault(_STATE_SLOT, {})
    raced = None
    with _graph_lock:
        _attr_accesses += 1
        st = states.get(attr)
        if st is None or st.epoch != _epoch:
            st = states[attr] = _AttrState(_epoch, tid)
        if not st.shared and tid != st.first_thread:
            st.shared = True
        if st.shared:
            st.lockset = (
                set(held) if st.lockset is None else (st.lockset & held)
            )
            if not st.lockset and not st.reported:
                st.reported = True
                raced = f"{cls_name}.{attr}"
                _races.append(
                    {
                        "attr": raced,
                        "site": site,
                        "lockset": sorted(held),
                        "write": is_write,
                        "prev_site": st.last_site,
                        "prev_lockset": sorted(st.last_lockset),
                        "prev_write": st.last_write,
                    }
                )
        st.last_site = site
        st.last_lockset = held
        st.last_thread = tid
        st.last_write = is_write
    if raced is not None:
        # outside _graph_lock: it is a leaf lock, and metrics.inc takes
        # the metrics registry lock — counting inside would stack a
        # foreign lock under the leaf
        _count_race(raced)


def _count_race(attr: str) -> None:
    try:  # metrics are observability, never a sanitizer failure mode
        from ..utils.metrics import metrics

        metrics.inc("lockgraph_races_total", {"attr": attr})
    except Exception:  # pragma: no cover - import cycles in exotic embeds
        pass


class guarded:
    """Data descriptor wrapping one shared attribute for the sanitizer.

    The value lives in the instance ``__dict__`` under a mangled slot;
    disabled, an access costs the descriptor call plus one boolean test.
    Install with :func:`track_attrs` (after the class body) or declare
    ``attr = guarded("attr")`` in the class."""

    __slots__ = ("name", "slot", "cls_name")

    def __init__(self, name: str, cls_name: Optional[str] = None):
        self.name = name
        self.slot = "_lockgraph_" + name
        self.cls_name = cls_name or "?"

    def __set_name__(self, owner, name):  # declarative form
        if self.cls_name == "?":
            self.cls_name = owner.__name__

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            val = obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None
        if _eraser:
            _attr_access(self.cls_name, self.name, False, obj)
        return val

    def __set__(self, obj, value):
        obj.__dict__[self.slot] = value
        if _eraser:
            _attr_access(self.cls_name, self.name, True, obj)

    def __delete__(self, obj):
        obj.__dict__.pop(self.slot, None)
        if _eraser:
            _attr_access(self.cls_name, self.name, True, obj)


def track_attrs(cls, *names: str) -> None:
    """Register shared mutable attributes of a production class with the
    lockset sanitizer. Call once, right after the class definition — the
    descriptors are permanent and idle-cheap; only enable(eraser=True)
    makes them record."""
    for name in names:
        setattr(cls, name, guarded(name, cls.__name__))


class NamedLock:
    """A lock wrapper that reports acquisitions to the watchdog.

    Wraps an RLock by default. Compatible with ``threading.Condition``
    (delegates ``_release_save``/``_acquire_restore``/``_is_owned``
    straight through: a thread parked in ``wait()`` records nothing, and
    its thread-local held stack stays consistent because a blocked
    thread acquires nothing)."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok and _enabled:
            _record_acquire(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        if _enabled:
            _record_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition compatibility: full release around wait() and silent
    # re-acquire on wake, both invisible to the order graph (see class
    # docstring)
    def _release_save(self):
        return self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"NamedLock({self.name!r}, {self._inner!r})"


def named_lock(name: str, inner=None) -> NamedLock:
    """The factory production modules call where they used to call
    ``threading.RLock()`` directly. Always returns the wrapper — the
    enable flag is checked per acquisition, so chaos suites can flip the
    watchdog on for locks created long before."""
    return NamedLock(name, inner)


# -- watchdog control (chaos suites) -----------------------------------------


def enable(eraser: bool = False) -> None:
    """Arm the watchdog (and, with eraser=True, the lockset sanitizer).
    Always starts a fresh epoch: edges, races, and every thread's held
    stack and per-attribute Eraser state from prior suites in the same
    process are invalidated."""
    global _enabled, _eraser, _epoch
    reset()
    _epoch += 1  # invalidate every thread's held stack from prior runs
    _enabled = True
    _eraser = eraser


def disable() -> None:
    global _enabled, _eraser
    _enabled = False
    _eraser = False


def reset() -> None:
    global _attr_accesses
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()
        _violations.clear()
        _acquires.clear()
        _attr_accesses = 0
        _races.clear()


def edges() -> Dict[str, Set[str]]:
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def edge_count() -> int:
    with _graph_lock:
        return sum(len(v) for v in _edges.values())


def acquire_count() -> int:
    """Total named-lock acquisitions observed while enabled — the
    instrumentation-is-alive signal (a suite can legitimately record
    zero EDGES when its locks never nest; it cannot record zero
    acquisitions)."""
    with _graph_lock:
        return sum(_acquires.values())


def acquires_by_name() -> Dict[str, int]:
    with _graph_lock:
        return dict(_acquires)


def violations() -> List[List[str]]:
    with _graph_lock:
        return [list(v) for v in _violations]


def find_cycle() -> Optional[List[str]]:
    """Any cycle in the full graph (independent of insert-time capture)."""
    with _graph_lock:
        color: Dict[str, int] = {}

        def dfs(node: str, path: List[str]) -> Optional[List[str]]:
            color[node] = 1
            for nxt in _edges.get(node, ()):
                if color.get(nxt, 0) == 1:
                    return path[path.index(nxt) :] + [nxt] if nxt in path else [nxt, node, nxt]
                if color.get(nxt, 0) == 0:
                    found = dfs(nxt, path + [nxt])
                    if found:
                        return found
            color[node] = 2
            return None

        for node in list(_edges):
            if color.get(node, 0) == 0:
                found = dfs(node, [node])
                if found:
                    return found
    return None


def assert_acyclic() -> None:
    """Fail loudly on any recorded inversion OR any cycle in the final
    graph. The edge list in the message is the repro: each edge names a
    lock order some real code path executed."""
    vio = violations()
    cyc = find_cycle()
    if vio or cyc:
        lines = ["lock-order watchdog: ORDER INVERSION DETECTED"]
        for v in vio:
            lines.append("  inversion: " + " -> ".join(v))
        if cyc and not vio:
            lines.append("  cycle: " + " -> ".join(cyc))
        with _graph_lock:
            for (a, b), n in sorted(_edge_sites.items()):
                lines.append(f"  edge {a} -> {b} (seen {n}x)")
        raise AssertionError("\n".join(lines))


def races() -> List[dict]:
    """Empty-lockset race reports recorded by the sanitizer this epoch."""
    with _graph_lock:
        return [dict(r) for r in _races]


def tracked_access_count() -> int:
    """Tracked-attribute accesses observed this epoch — the
    sanitizer-is-alive signal (a suite can legitimately record zero
    RACES; with Eraser mode armed over the production classes it cannot
    record zero accesses)."""
    with _graph_lock:
        return _attr_accesses


def assert_no_races() -> None:
    """Fail loudly on any empty-lockset race: each report carries both
    stack tips and both locksets — the repro is in the message."""
    got = races()
    if got:
        lines = ["lockset sanitizer: EMPTY-LOCKSET RACE DETECTED"]
        for r in got:
            lines.append(
                f"  {r['attr']}: {r['prev_site']} "
                f"(locks {r['prev_lockset'] or ['-']}, "
                f"{'write' if r['prev_write'] else 'read'}) vs "
                f"{r['site']} (locks {r['lockset'] or ['-']}, "
                f"{'write' if r['write'] else 'read'})"
            )
        raise AssertionError("\n".join(lines))


def assert_clean() -> None:
    """The chaos-suite exit gate: zero lock-order cycles AND zero
    empty-lockset races."""
    assert_acyclic()
    assert_no_races()
