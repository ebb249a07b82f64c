"""Node IPAM controller: allocate a pod CIDR per node from the cluster CIDR.

Reference: pkg/controller/nodeipam (range_allocator.go) — every node gets
one /node_mask_size block out of --cluster-cidr; blocks release on node
deletion and are never double-allocated (the allocator re-syncs its bitmap
from live nodes on startup, the crash-only pattern).
"""

from __future__ import annotations

import ipaddress
import logging
import threading
from typing import Optional, Set

from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.nodeipam")


class NodeIpamController(WorkqueueController):
    name = "nodeipam"
    primary_kind = "nodes"
    secondary_kinds = ()

    def __init__(
        self,
        server,
        workers: int = 1,
        cluster_cidr: str = "10.244.0.0/16",
        node_mask_size: int = 24,
    ):
        super().__init__(server, workers=workers)
        self.cluster = ipaddress.ip_network(cluster_cidr)
        self._all = list(self.cluster.subnets(new_prefix=node_mask_size))
        self._alloc_lock = threading.Lock()
        self._used: Optional[Set[str]] = None  # lazy: rebuilt from live nodes

    def _rebuild_used(self) -> Set[str]:
        nodes, _ = self.server.list("nodes")
        return {n.spec.pod_cidr for n in nodes if n.spec.pod_cidr}

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")
        try:
            node = self.server.get("nodes", ns, name)
        except NotFound:
            # released blocks return to the pool on the next allocation's
            # rebuild (allocator state is derived, never authoritative)
            with self._alloc_lock:
                self._used = None
            return
        if node.spec.pod_cidr:
            return
        with self._alloc_lock:
            if self._used is None:
                self._used = self._rebuild_used()
            cidr = next(
                (str(s) for s in self._all if str(s) not in self._used), None
            )
            if cidr is None:
                logger.error("cluster CIDR %s exhausted", self.cluster)
                return
            self._used.add(cidr)

        def mutate(n):
            if n.spec.pod_cidr:
                return None  # raced another allocation; keep theirs
            n.spec.pod_cidr = cidr
            return n

        try:
            final = self.server.guaranteed_update("nodes", ns, name, mutate)
            if final.spec.pod_cidr != cidr:
                # lost the race: release the block we reserved or it would
                # leak out of the pool permanently
                with self._alloc_lock:
                    if self._used is not None:
                        self._used.discard(cidr)
        except NotFound:
            with self._alloc_lock:
                if self._used is not None:
                    self._used.discard(cidr)
