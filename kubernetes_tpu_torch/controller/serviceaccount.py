"""ServiceAccount + token controllers.

Reference: pkg/controller/serviceaccount/serviceaccounts_controller.go —
ensure every (non-terminating) namespace has the "default" ServiceAccount —
and tokens_controller.go — ensure every ServiceAccount has a token Secret
(type kubernetes.io/service-account-token) referenced from its
``secrets`` list; deleting the SA deletes its tokens.
"""

from __future__ import annotations

import logging
import secrets as _secrets
from typing import Optional

from ..api import objects as v1
from ..client.apiserver import AlreadyExists, NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.serviceaccount")

TOKEN_SECRET_TYPE = "kubernetes.io/service-account-token"
SA_ANNOTATION = "kubernetes.io/service-account.name"


class ServiceAccountController(WorkqueueController):
    """Namespaces are the primary: each sync ensures default SA + token."""

    name = "serviceaccount"
    primary_kind = "namespaces"
    secondary_kinds = ("serviceaccounts",)

    def enqueue_for_related(self, resource: str, obj) -> Optional[str]:
        # SA deleted/changed -> re-sync its namespace. Namespace objects sit
        # in the store under the default namespace (their metadata.namespace
        # is not themselves), so reconstruct that store key.
        ns = obj.metadata.namespace
        if not ns:
            return None
        for cand in self.server.list("namespaces")[0]:
            if cand.metadata.name == ns:
                return cand.metadata.key
        return None

    def sync(self, key: str) -> None:
        store_ns, _, name = key.rpartition("/")
        try:
            ns_obj = self.server.get("namespaces", store_ns, name)
        except NotFound:
            return
        if ns_obj.metadata.deletion_timestamp is not None:
            return
        # ensure the default ServiceAccount
        try:
            sa = self.server.get("serviceaccounts", name, "default")
        except NotFound:
            sa = v1.ServiceAccount(
                metadata=v1.ObjectMeta(name="default", namespace=name)
            )
            try:
                sa = self.server.create("serviceaccounts", sa)
            except AlreadyExists:
                sa = self.server.get("serviceaccounts", name, "default")
        self._ensure_token(sa)
        self._gc_orphaned_tokens(name)

    def _gc_orphaned_tokens(self, namespace: str) -> None:
        """Token secrets whose ServiceAccount is gone must be DELETED —
        otherwise the bearer credential keeps authenticating a revoked
        identity (tokens_controller deletes on SA deletion)."""
        sas = {
            sa.metadata.name
            for sa in self.server.list("serviceaccounts", namespace=namespace)[0]
        }
        for s in self.server.list("secrets", namespace=namespace)[0]:
            if s.type != TOKEN_SECRET_TYPE:
                continue
            owner = s.metadata.annotations.get(SA_ANNOTATION, "")
            if owner and owner not in sas:
                try:
                    self.server.delete("secrets", namespace, s.metadata.name)
                except NotFound:
                    pass

    def _ensure_token(self, sa: v1.ServiceAccount) -> None:
        """tokens_controller.go ensureReferencedToken: a token Secret exists
        and is referenced from sa.secrets."""
        ns = sa.metadata.namespace
        token_name = f"{sa.metadata.name}-token"
        try:
            self.server.get("secrets", ns, token_name)
        except NotFound:
            secret = v1.Secret(
                metadata=v1.ObjectMeta(
                    name=token_name,
                    namespace=ns,
                    annotations={SA_ANNOTATION: sa.metadata.name},
                ),
                type=TOKEN_SECRET_TYPE,
                data={"token": _secrets.token_urlsafe(24).encode()},
            )
            try:
                self.server.create("secrets", secret)
            except AlreadyExists:
                pass
        if token_name not in sa.secrets:
            def mutate(cur):
                if token_name in cur.secrets:
                    return None
                cur.secrets.append(token_name)
                return cur

            try:
                self.server.guaranteed_update(
                    "serviceaccounts", ns, sa.metadata.name, mutate
                )
            except NotFound:
                pass


class TokenCleaner(WorkqueueController):
    """Delete expired bootstrap token secrets
    (pkg/controller/bootstrap/tokencleaner.go): secrets of type
    ``bootstrap.kubernetes.io/token`` carry an ``expiration`` annotation
    (unix seconds); past it, the join credential is revoked."""

    name = "tokencleaner"
    primary_kind = "secrets"
    secondary_kinds = ()

    EXPIRATION_ANNOTATION = "expiration"
    BOOTSTRAP_TYPE = "bootstrap.kubernetes.io/token"

    def __init__(self, server, workers: int = 1, tick: float = 5.0):
        super().__init__(server, workers=workers)
        self.tick = tick

    def start(self) -> None:
        super().start()
        # expirations fire by time, not by watch events. Bootstrap tokens
        # live in kube-system only, and only expiring ones need ticks — the
        # cleaner must not deep-copy every secret in the cluster each tick.
        self.start_ticker("tokencleaner-tick", self.tick, self._enqueue_expiring)

    def _enqueue_expiring(self) -> None:
        for s in self.server.list("secrets", namespace="kube-system")[0]:
            if (
                s.type == self.BOOTSTRAP_TYPE
                and self.EXPIRATION_ANNOTATION in s.metadata.annotations
            ):
                self.queue.add(s.metadata.key)

    def sync(self, key: str) -> None:
        import time as _time

        ns, _, name = key.rpartition("/")
        try:
            secret = self.server.get("secrets", ns, name)
        except NotFound:
            return
        if secret.type != self.BOOTSTRAP_TYPE:
            return
        raw = secret.metadata.annotations.get(self.EXPIRATION_ANNOTATION)
        if raw is None:
            return  # non-expiring token
        try:
            expires = float(raw)
        except ValueError:
            logger.warning("token %s: bad expiration %r; deleting", key, raw)
            expires = 0.0
        if _time.time() >= expires:
            try:
                self.server.delete("secrets", ns, name)
                logger.info("expired bootstrap token %s deleted", key)
            except NotFound:
                pass
