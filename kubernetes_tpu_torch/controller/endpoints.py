"""Endpoints controller: Service selector → backing pod addresses.

Reference: pkg/controller/endpoint/endpoints_controller.go (syncService) —
for every Service, the Endpoints object of the same name lists the IPs of
Running, IP-assigned pods matching the selector; pods not yet ready land in
notReadyAddresses. The proxy dataplane consumes these.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController, match_labels, pod_is_ready

logger = logging.getLogger("kubernetes_tpu.controller.endpoints")


class EndpointsController(WorkqueueController):
    name = "endpoints"
    primary_kind = "services"
    secondary_kinds = ("pods",)

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        # a pod event touches every service whose selector matches either
        # the old or new labels; re-list services in the pod's namespace
        svcs, _ = self.server.list("services", namespace=obj.metadata.namespace)
        for s in svcs:
            if s.spec.selector and match_labels(
                s.spec.selector, obj.metadata.labels
            ):
                self.queue.add(s.metadata.key)
        return None

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            svc = self.server.get("services", ns, name)
        except NotFound:
            # service gone: remove its endpoints
            try:
                self.server.delete("endpoints", ns, name)
            except NotFound:
                pass
            return
        if not svc.spec.selector:
            return  # headless/manual endpoints are user-managed

        pods, _ = self.server.list("pods", namespace=ns)
        ready, not_ready = [], []
        for p in pods:
            if p.metadata.deletion_timestamp is not None:
                continue
            if not match_labels(svc.spec.selector, p.metadata.labels):
                continue
            if not p.spec.node_name:
                continue  # unscheduled pods have no address yet
            addr = v1.EndpointAddress(
                ip=p.status.pod_ip,
                node_name=p.spec.node_name,
                target_pod=p.metadata.key,
            )
            if pod_is_ready(p) and p.status.pod_ip:
                ready.append(addr)
            else:
                not_ready.append(addr)
        subset = v1.EndpointSubset(
            addresses=sorted(ready, key=lambda a: a.target_pod),
            not_ready_addresses=sorted(not_ready, key=lambda a: a.target_pod),
            ports=list(svc.spec.ports),
        )
        subsets = [subset] if (ready or not_ready) else []

        def mutate(cur):
            if cur.subsets == subsets:
                return None
            cur.subsets = subsets
            return cur

        try:
            self.server.guaranteed_update("endpoints", ns, name, mutate)
        except NotFound:
            ep = v1.Endpoints(
                metadata=v1.ObjectMeta(name=name, namespace=ns),
                subsets=subsets,
            )
            try:
                self.server.create("endpoints", ep)
            except AlreadyExists:
                pass
