"""Certificates controller: CSR auto-approval + signing.

Reference: pkg/controller/certificates/{approver,signer} — the approver
auto-approves kubelet client CSRs from recognized bootstrap identities
(sarapprove), the signer issues the certificate for approved CSRs. This
build has no x509 machinery; the issued credential is an HMAC over the
request bound to the cluster trust root, which the TokenAuthenticator
accepts the same way it accepts ServiceAccount tokens — same
trust-establishment flow, different crypto.
"""

from __future__ import annotations

import hashlib
import hmac
import logging

from ..api import objects as v1
from ..client.apiserver import NotFound
from .base import WorkqueueController

logger = logging.getLogger("kubernetes_tpu.controller.certificates")

APPROVED = "Approved"
DENIED = "Denied"
KUBELET_SIGNER = "kubernetes.io/kube-apiserver-client-kubelet"
AUTO_APPROVE_GROUPS = {"system:bootstrappers", "system:nodes"}


def _condition(csr: v1.CertificateSigningRequest, cond_type: str) -> bool:
    return any(
        c.type == cond_type and c.status == "True" for c in csr.status.conditions
    )


class CSRApprovingController(WorkqueueController):
    """Auto-approval loop (pkg/controller/certificates/approver/
    sarapprove.go): kubelet client CSRs from recognized bootstrap
    identities get the Approved condition; everything else waits for a
    human (kubectl certificate approve)."""

    name = "csrapproving"
    primary_kind = "certificatesigningrequests"
    secondary_kinds = ()

    def __init__(self, server, workers: int = 1):
        super().__init__(server, workers=workers)

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")
        try:
            csr = self.server.get("certificatesigningrequests", ns, name)
        except NotFound:
            return
        if _condition(csr, APPROVED) or _condition(csr, DENIED):
            return
        if csr.spec.signer_name == KUBELET_SIGNER and (
            AUTO_APPROVE_GROUPS & set(csr.spec.groups)
        ):
            _set_condition(self.server, ns, name, APPROVED, "AutoApproved")


class CSRSigningController(WorkqueueController):
    """Signing loop (pkg/controller/certificates/signer): issues the
    credential for Approved CSRs. Approval itself is the approver's job."""

    name = "csrsigning"
    primary_kind = "certificatesigningrequests"
    secondary_kinds = ()

    def __init__(self, server, workers: int = 1, signing_key: bytes = b"tpu-cluster-trust-root"):
        super().__init__(server, workers=workers)
        self.signing_key = signing_key

    def sync(self, key: str) -> None:
        ns, _, name = key.rpartition("/")
        try:
            csr = self.server.get("certificatesigningrequests", ns, name)
        except NotFound:
            return
        if _condition(csr, DENIED) or csr.status.certificate:
            return
        if not _condition(csr, APPROVED):
            return  # signing happens on the sync after approval

        issued = hmac.new(
            self.signing_key,
            f"{csr.spec.username}:{csr.spec.request}".encode(),
            hashlib.sha256,
        ).hexdigest()

        def sign(cur):
            if cur.status.certificate:
                return None
            cur.status.certificate = issued
            return cur

        try:
            self.server.guaranteed_update(
                "certificatesigningrequests", ns, name, sign
            )
        except NotFound:
            pass

def _set_condition(server, ns: str, name: str, cond_type: str, reason: str) -> None:  # graftlint: degraded-ok(only called from WorkqueueController sync paths: the worker loop catches and requeues rate-limited)
    def mutate(cur):
        if _condition(cur, cond_type):
            return None
        cur.status.conditions.append(
            v1.PodCondition(type=cond_type, status="True", reason=reason)
        )
        return cur

    try:
        server.guaranteed_update("certificatesigningrequests", ns, name, mutate)
    except NotFound:
        pass


class CSRCleanerController(WorkqueueController):
    """Garbage-collect stale CSRs (pkg/controller/certificates/cleaner/
    cleaner.go): signed or denied requests past their retention window and
    pending requests nobody acted on are deleted on a poll tick."""

    name = "csrcleaner"
    primary_kind = "certificatesigningrequests"
    secondary_kinds = ()

    def __init__(
        self,
        server,
        workers: int = 1,
        tick: float = 60.0,
        signed_ttl: float = 3600.0,     # approved + issued (1h)
        denied_ttl: float = 3600.0,     # denied (1h)
        pending_ttl: float = 24 * 3600.0,  # never acted on (24h)
    ):
        super().__init__(server, workers=workers)
        self.tick = tick
        self.signed_ttl = signed_ttl
        self.denied_ttl = denied_ttl
        self.pending_ttl = pending_ttl

    def start(self) -> None:
        super().start()
        # expiry is time-driven, not event-driven
        self.start_ticker("csrcleaner-tick", self.tick, self._enqueue_all)

    def _enqueue_all(self) -> None:
        for csr in self.server.list("certificatesigningrequests")[0]:
            self.queue.add(csr.metadata.key)

    def sync(self, key: str) -> None:
        import time as _time

        ns, _, name = key.rpartition("/")
        try:
            csr = self.server.get("certificatesigningrequests", ns, name)
        except NotFound:
            return
        age = _time.time() - csr.metadata.creation_timestamp
        if _condition(csr, DENIED):
            expired = age > self.denied_ttl
        elif _condition(csr, APPROVED) and csr.status.certificate:
            expired = age > self.signed_ttl
        elif not csr.status.conditions:
            expired = age > self.pending_ttl
        else:
            return  # approved-but-unsigned: the signer still owes it work
        if expired:
            try:
                self.server.delete("certificatesigningrequests", ns, name)
                logger.info("csrcleaner: deleted stale CSR %s", key)
            except NotFound:
                pass
