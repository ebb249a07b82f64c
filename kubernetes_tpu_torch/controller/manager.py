"""Controller manager: run the reconcile loops under one leader election.

Reference: cmd/kube-controller-manager/app/controllermanager.go:372-414
(NewControllerInitializers) — each controller is started by name; disabled
controllers are skipped. A lost leader lease stops everything.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from ..client.leaderelection import LeaderElectionConfig, LeaderElector
from .attachdetach import AttachDetachController
from .bootstrap import BootstrapSignerController
from .certificates import (
    CSRApprovingController,
    CSRCleanerController,
    CSRSigningController,
)
from .rbac import ClusterRoleAggregationController
from .volume_expand import VolumeExpandController
from .cronjob import CronJobController
from .daemonset import DaemonSetController
from .endpointslice import EndpointSliceController
from .deployment import DeploymentController
from .disruption import DisruptionController
from .endpoints import EndpointsController
from .garbagecollector import GarbageCollector
from .hpa import HPAController
from .job import JobController
from .namespace import NamespaceController
from .nodeipam import NodeIpamController
from .podgc import (
    PodGCController,
    PVCProtectionController,
    PVProtectionController,
    RootCACertPublisher,
)
from .nodelifecycle import NodeLifecycleController
from .pv_binder import PVBinderController
from .replicaset import ReplicaSetController, ReplicationControllerController
from .resourcequota import ResourceQuotaController
from .serviceaccount import ServiceAccountController, TokenCleaner
from .statefulset import StatefulSetController
from .ttl import TTLAfterFinishedController, TTLController

logger = logging.getLogger("kubernetes_tpu.controller.manager")

# reference list: cmd/kube-controller-manager/app/controllermanager.go:372-414
CONTROLLER_INITIALIZERS = {
    "replicaset": ReplicaSetController,
    "deployment": DeploymentController,
    "job": JobController,
    "daemonset": DaemonSetController,
    "statefulset": StatefulSetController,
    "endpoints": EndpointsController,
    "disruption": DisruptionController,
    "nodelifecycle": NodeLifecycleController,
    "garbagecollector": GarbageCollector,
    "namespace": NamespaceController,
    "horizontalpodautoscaling": HPAController,
    "cronjob": CronJobController,
    "resourcequota": ResourceQuotaController,
    "serviceaccount": ServiceAccountController,
    "ttl": TTLController,
    "ttlafterfinished": TTLAfterFinishedController,
    "endpointslice": EndpointSliceController,
    "nodeipam": NodeIpamController,
    "attachdetach": AttachDetachController,
    "persistentvolume-binder": PVBinderController,
    "podgc": PodGCController,
    "pvc-protection": PVCProtectionController,
    "pv-protection": PVProtectionController,
    "root-ca-cert-publisher": RootCACertPublisher,
    "replicationcontroller": ReplicationControllerController,
    "csrsigning": CSRSigningController,
    "csrapproving": CSRApprovingController,
    "csrcleaner": CSRCleanerController,
    "tokencleaner": TokenCleaner,
    "bootstrapsigner": BootstrapSignerController,
    "persistentvolume-expander": VolumeExpandController,
    "clusterrole-aggregation": ClusterRoleAggregationController,
}


class ControllerManager:
    def __init__(
        self,
        server,
        controllers: Optional[List[str]] = None,
        leader_election: Optional[LeaderElectionConfig] = None,
        watch_cache: bool = False,
        **controller_kwargs,
    ):
        self.server = server
        backend = server
        if watch_cache:
            # every controller's list+watch rides ONE shared Cacher: N
            # reconcile loops cost one store watch per kind instead of one
            # each (writes delegate through to the store untouched). The
            # elector below stays on the raw server — lease writes are a
            # fencing authority, never cache-served.
            from ..apiserver.cacher import Cacher

            backend = Cacher(server)
        self.backend = backend
        names = controllers or list(CONTROLLER_INITIALIZERS)
        self.controllers: Dict[str, object] = {}
        for name in names:
            init = CONTROLLER_INITIALIZERS.get(name)
            if init is None:
                raise ValueError(f"unknown controller {name!r}")
            kwargs = controller_kwargs.get(name, {})
            self.controllers[name] = init(backend, **kwargs)
        self._leader_cfg = leader_election
        self._elector = None
        self._started = threading.Event()

    def start(self) -> None:
        if self._leader_cfg is None:
            self._start_all()
            return

        def on_stopped():
            logger.error("controller-manager lost leadership; stopping")
            self.stop()

        self._elector = LeaderElector(
            self.server,
            self._leader_cfg,
            on_started_leading=self._start_all,
            on_stopped_leading=on_stopped,
        )
        threading.Thread(target=self._elector.run, daemon=True).start()

    def _start_all(self) -> None:
        for name, ctrl in self.controllers.items():
            ctrl.start()
            logger.info("started controller %s", name)
        self._started.set()

    def stop(self) -> None:
        for ctrl in self.controllers.values():
            ctrl.stop()
        if self._elector is not None:
            self._elector.stop()
        if self.backend is not self.server:
            # the Cacher this manager created: tear down its per-kind
            # store watches + bookmark thread with the controllers
            self.backend.stop()
