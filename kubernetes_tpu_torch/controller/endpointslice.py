"""EndpointSlice controller: sliced service endpoint publication.

Reference: pkg/controller/endpointslice (reconciler.go) — like the
Endpoints controller, but endpoints are split into EndpointSlice objects
of at most `max_endpoints_per_slice` (default 100) so huge services don't
produce megabyte Endpoints objects that every kube-proxy must re-receive
whole on any single pod change. Slices carry the
``kubernetes.io/service-name`` label; reconcile creates/updates/deletes
slices to cover exactly the backing pod set.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController, match_labels, pod_is_ready

logger = logging.getLogger("kubernetes_tpu.controller.endpointslice")

SERVICE_NAME_LABEL = "kubernetes.io/service-name"


class EndpointSliceController(WorkqueueController):
    name = "endpointslice"
    primary_kind = "services"
    secondary_kinds = ("pods",)

    def __init__(self, server, workers: int = 2, max_endpoints_per_slice: int = 100):
        super().__init__(server, workers=workers)
        self.max_per_slice = max_endpoints_per_slice

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        svcs, _ = self.server.list("services", namespace=obj.metadata.namespace)
        for s in svcs:
            if s.spec.selector and match_labels(
                s.spec.selector, obj.metadata.labels
            ):
                self.queue.add(s.metadata.key)
        return None

    def _owned_slices(self, ns: str, svc_name: str) -> List[v1.EndpointSlice]:
        slices, _ = self.server.list("endpointslices", namespace=ns)
        return [
            s
            for s in slices
            if s.metadata.labels.get(SERVICE_NAME_LABEL) == svc_name
        ]

    def sync(self, key: str) -> None:
        ns, _, name = key.partition("/")
        try:
            svc = self.server.get("services", ns, name)
        except NotFound:
            for s in self._owned_slices(ns, name):
                try:
                    self.server.delete("endpointslices", ns, s.metadata.name)
                except NotFound:
                    pass
            return
        if not svc.spec.selector:
            return

        pods, _ = self.server.list("pods", namespace=ns)
        endpoints = [
            v1.Endpoint(
                addresses=[p.status.pod_ip] if p.status.pod_ip else [],
                ready=pod_is_ready(p),
                target_pod=p.metadata.key,
                node_name=p.spec.node_name,
            )
            for p in sorted(pods, key=lambda p: p.metadata.name)
            if p.metadata.deletion_timestamp is None
            and match_labels(svc.spec.selector, p.metadata.labels)
            and p.spec.node_name
        ]
        # slice the endpoint set (reconciler.go: fill slices up to max)
        want: List[List[v1.Endpoint]] = [
            endpoints[i : i + self.max_per_slice]
            for i in range(0, len(endpoints), self.max_per_slice)
        ] or []
        have = sorted(self._owned_slices(ns, name), key=lambda s: s.metadata.name)

        for i, chunk in enumerate(want):
            slice_name = f"{name}-{i}"
            desired_ports = list(svc.spec.ports)

            def mutate(cur, _chunk=chunk, _ports=desired_ports):
                if cur.endpoints == _chunk and cur.ports == _ports:
                    return None
                cur.endpoints = _chunk
                cur.ports = _ports
                return cur

            try:
                self.server.guaranteed_update(
                    "endpointslices", ns, slice_name, mutate
                )
            except NotFound:
                es = v1.EndpointSlice(
                    metadata=v1.ObjectMeta(
                        name=slice_name,
                        namespace=ns,
                        labels={SERVICE_NAME_LABEL: name},
                        owner_references=[
                            v1.OwnerReference(
                                kind="Service",
                                name=name,
                                uid=svc.metadata.uid,
                                controller=True,
                            )
                        ],
                    ),
                    endpoints=chunk,
                    ports=desired_ports,
                )
                try:
                    self.server.create("endpointslices", es)
                except AlreadyExists:
                    pass
        # drop surplus slices
        keep = {f"{name}-{i}" for i in range(len(want))}
        for s in have:
            if s.metadata.name not in keep:
                try:
                    self.server.delete("endpointslices", ns, s.metadata.name)
                except NotFound:
                    pass
