"""The bind stream and the clock of the bind calls.

``PodStream`` is one ``APIServer.watch("pods")`` opened before any pod
exists: a thread of its own takes each event, stamps it with
``time.monotonic()``, and keeps it as numbers in flat arrays (its code,
resourceVersion, pod and node as ``cluster.Names`` ids, and the time),
so the record of a run's quarter million events is a few MiB that the
collector never walks. ``events()`` gives them back as
``(code, rv, name, node, t)`` once the run is over. It sees every bind,
so the traffic's watermarks and the check of every binding read it;
nothing here counts or lists the store. ``BindClock`` times the bind
calls, whose returns are the window's batch edges.
"""

from __future__ import annotations

import collections
import threading
import time
from array import array
from typing import Iterator, List, Tuple

from .window import ADD, BIND, DEL, OTHER, Run


class PodStream:
    def __init__(self, server, names):
        self._w = server.watch("pods")
        self.names = names
        self._code = array("b")
        self._rv = array("q")
        self._pod = array("q")
        self._node = array("l")
        self._t = array("d")
        # node id each measured pod was bound to, by pod id (-1: not yet);
        # init and other pods, a few thousand, in a dict
        self._node_of_measured = array("l")
        self._node_of_rest: dict = {}
        # measured pods in bind order, by id, for the traffic's deletes
        self.bound_fifo: collections.deque = collections.deque()
        self.n_bound_measured = 0
        self.n_bound = 0
        self.rebinds = 0
        self.wake = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="schedbench-watch", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        w = self._w
        while True:
            ev = w.get(timeout=0.2)
            if ev is None:
                if w.stopped:
                    return
                continue
            # take what has queued meanwhile in one turn
            bound = False
            while ev is not None:
                bound |= self._take(ev, time.monotonic())
                ev = w.get(timeout=0)
            if bound:
                self.wake.set()
            # at most 20 turns a second: each turn takes the interpreter
            # from the program's threads, and the load's refill can wait
            # 50 ms against a backlog of four 4-second batches
            time.sleep(0.05)

    def _bound_node(self, pid: int) -> int:
        if pid >= 0 and pid < len(self._node_of_measured):
            return self._node_of_measured[pid]
        return self._node_of_rest.get(pid, -1)

    def _set_bound_node(self, pid: int, nid: int) -> None:
        if 0 <= pid < self.names.OTHER_POD:
            nm = self._node_of_measured
            if pid >= len(nm):
                nm.extend([-1] * (pid + 1 - len(nm)))
            nm[pid] = nid
        else:
            self._node_of_rest[pid] = nid

    def _take(self, ev, t: float) -> bool:
        obj = ev.object
        pid = self.names.pod_id(obj.metadata.name)
        node = obj.spec.node_name
        nid = self.names.node_id(node)
        if ev.type == "ADDED":
            code = ADD
        elif ev.type == "DELETED":
            code = DEL
        else:
            was = self._bound_node(pid)
            if node and was == -1:
                code = BIND
            else:
                code = OTHER
                if node and was != nid:
                    self.rebinds += 1
        self._code.append(code)
        self._rv.append(ev.resource_version)
        self._pod.append(pid)
        self._node.append(nid)
        self._t.append(t)
        if code != BIND:
            return False
        self._set_bound_node(pid, nid)
        self.n_bound += 1
        if 0 <= pid < self.names.OTHER_POD:
            self.bound_fifo.append(pid)
            self.n_bound_measured += 1
        return True

    def events(self) -> Iterator[Tuple]:
        """Every event taken, as ``(code, rv, pod name, node name or None,
        t)``, in stream order (call once the stream has stopped)."""
        pod_name, node_name = self.names.pod_name, self.names.node_name
        for code, rv, pid, nid, t in zip(self._code, self._rv, self._pod, self._node, self._t):
            yield code, rv, pod_name(pid), node_name(nid), t

    def stop(self) -> None:
        """Stop watching once every event already pushed has been taken."""
        self._w.stop()
        self._thread.join(timeout=60.0)

    def wait_bound(self, n: int, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        while self.n_bound < n:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.01)
        return True


class BindClock:
    """Times every bind call made on `server`: wraps the instance's
    ``bind_pods`` and ``bind_pod`` so that each call that bound a pod
    appends a ``Run`` (its return time, the pods it bound, the store's
    resourceVersion before and after) to ``runs``. The benchmark's own
    span around the call into the API layer; the pods watch still sees
    every binding."""

    def __init__(self, server):
        self.runs: List[Run] = []
        many, one = server.bind_pods, server.bind_pod

        def bind_pods(bindings, fence=None):
            rv0 = server.resource_version
            errors = many(bindings, fence=fence)
            n = sum(1 for e in errors if e is None)
            if n:
                self.runs.append(Run(time.monotonic(), n, rv0, server.resource_version))
            return errors

        def bind_pod(binding):
            rv0 = server.resource_version
            one(binding)
            self.runs.append(Run(time.monotonic(), 1, rv0, server.resource_version))

        server.bind_pods = bind_pods
        server.bind_pod = bind_pod

    @property
    def bound(self) -> int:
        return sum(r.size for r in self.runs)
