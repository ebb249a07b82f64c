"""Bootstrap signer: JWS-signs the public cluster-info ConfigMap.

Reference: pkg/controller/bootstrap/bootstrapsigner.go — joining nodes
fetch `cluster-info` from kube-public WITHOUT credentials, so its
authenticity comes from detached JWS signatures keyed by bootstrap tokens:
for every signing-enabled token secret the controller stores
``jws-kubeconfig-<token-id>`` = sig(kubeconfig, token) in the ConfigMap,
and prunes signatures for deleted tokens. This build's signature is an
HMAC-SHA256 over the kubeconfig content keyed by ``<id>:<secret>``
(kubeadm-lite verifies the same construction on join) instead of a
JWS-serialized HS256 — same trust flow, simpler crypto.
"""

from __future__ import annotations

import hashlib
import hmac
import logging

from ..client.apiserver import Conflict, NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.bootstrap")

CLUSTER_INFO_NAMESPACE = "kube-public"
CLUSTER_INFO_NAME = "cluster-info"
KUBECONFIG_KEY = "kubeconfig"
JWS_PREFIX = "jws-kubeconfig-"
BOOTSTRAP_TOKEN_TYPE = "bootstrap.kubernetes.io/token"
TOKEN_ID_KEY = "token-id"
TOKEN_SECRET_KEY = "token-secret"
USAGE_SIGNING_KEY = "usage-bootstrap-signing"


def compute_detached_signature(content: str, token_id: str, token_secret: str) -> str:
    """The signature kubeadm-lite's join path verifies."""
    return hmac.new(
        f"{token_id}:{token_secret}".encode(), content.encode(), hashlib.sha256
    ).hexdigest()


def _as_str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


class BootstrapSignerController(WorkqueueController):
    """World-state reconciler: any cluster-info or bootstrap-token event
    recomputes the full signature set (the reference enqueues a single
    constant key for the same reason)."""

    name = "bootstrapsigner"
    primary_kind = "configmaps"
    secondary_kinds = ("secrets",)

    WORLD = "__sign__"

    def __init__(self, server, workers: int = 1):
        super().__init__(server, workers=workers)

    def primary_key_of(self, obj) -> str:
        # only the one ConfigMap matters; collapse everything else
        if (
            obj.metadata.namespace == CLUSTER_INFO_NAMESPACE
            and obj.metadata.name == CLUSTER_INFO_NAME
        ):
            return self.WORLD
        return ""

    def enqueue_for_related(self, resource, obj):
        if getattr(obj, "type", "") == BOOTSTRAP_TOKEN_TYPE:
            return self.WORLD
        return None

    def _tokens(self):
        """{token-id: token-secret} for signing-enabled bootstrap tokens."""
        out = {}
        for s in self.server.list("secrets", namespace="kube-system")[0]:
            if s.type != BOOTSTRAP_TOKEN_TYPE:
                continue
            data = {**{k: _as_str(v) for k, v in s.data.items()}, **s.string_data}
            if data.get(USAGE_SIGNING_KEY, "").lower() != "true":
                continue
            tid, tsec = data.get(TOKEN_ID_KEY), data.get(TOKEN_SECRET_KEY)
            if tid and tsec:
                out[tid] = tsec
        return out

    def sync(self, key: str) -> None:
        if key != self.WORLD:
            return
        try:
            cm = self.server.get(
                "configmaps", CLUSTER_INFO_NAMESPACE, CLUSTER_INFO_NAME
            )
        except NotFound:
            return
        content = cm.data.get(KUBECONFIG_KEY)
        if content is None:
            return
        tokens = self._tokens()  # one secret list + HMAC set per reconcile
        old_sigs = {
            k[len(JWS_PREFIX):]: v
            for k, v in cm.data.items()
            if k.startswith(JWS_PREFIX)
        }
        new_sigs = {
            tid: compute_detached_signature(content, tid, tsec)
            for tid, tsec in tokens.items()
        }
        if new_sigs == old_sigs:
            return

        def mutate(cur):
            c = cur.data.get(KUBECONFIG_KEY)
            if c is None:
                return None
            data = {
                k: v for k, v in cur.data.items() if not k.startswith(JWS_PREFIX)
            }
            for tid, tsec in tokens.items():
                # re-sign over the re-read content (a conflict retry may
                # see a newer kubeconfig)
                data[JWS_PREFIX + tid] = compute_detached_signature(c, tid, tsec)
            if data == cur.data:
                return None
            cur.data = data
            return cur

        try:
            self.server.guaranteed_update(
                "configmaps", CLUSTER_INFO_NAMESPACE, CLUSTER_INFO_NAME, mutate
            )
        except (NotFound, Conflict):
            pass  # resync catches up
