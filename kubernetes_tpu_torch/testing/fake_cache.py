"""No-op scheduler cache for unit tests.

Reference: pkg/scheduler/internal/cache/fake/fake_cache.go — a Cache
implementation whose mutations do nothing and whose assume hooks invoke a
test-provided callback, so queue/cycle logic can be tested without cache
bookkeeping."""

from __future__ import annotations

from typing import Callable, Optional

from ..scheduler.cache.nodeinfo import Snapshot


class FakeCache:
    def __init__(
        self,
        assume_func: Optional[Callable] = None,
        snapshot: Optional[Snapshot] = None,
    ):
        self.assume_func = assume_func
        self._snapshot = snapshot or Snapshot([])
        self.assumed = []  # (pod_key, node_name) log

    # -- mutations: recorded, never applied ---------------------------------

    def assume_pod(self, pod, node_name: str, **_kw) -> None:
        self.assumed.append((pod.metadata.key, node_name))
        if self.assume_func:
            self.assume_func(pod, node_name)

    def assume_pods_bulk(self, items) -> list:
        """Mirror SchedulerCache's wave-bind entry point."""
        for pod, node_name, _band, _proto in items:
            self.assume_pod(pod, node_name)
        return [None] * len(items)

    def finish_binding(self, pod) -> None:
        pass

    def forget_pod(self, pod) -> None:
        self.assumed = [
            (k, n) for (k, n) in self.assumed if k != pod.metadata.key
        ]

    def add_pod(self, pod) -> None:
        pass

    def update_pod(self, pod) -> None:
        pass

    def remove_pod(self, pod) -> None:
        pass

    def add_node(self, node) -> None:
        pass

    def update_node(self, node) -> None:
        pass

    def remove_node(self, node_name: str) -> None:
        pass

    # -- views ---------------------------------------------------------------

    def update_snapshot(self) -> Snapshot:
        return self._snapshot

    def is_assumed(self, pod_key: str) -> bool:
        return any(k == pod_key for k, _ in self.assumed)

    @property
    def node_count(self) -> int:
        return len(self._snapshot)

    def pod_count(self) -> int:
        return len(self._snapshot.list_pods())
