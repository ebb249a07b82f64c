"""Dynamic admission webhooks.

Reference: staging/src/k8s.io/apiserver/pkg/admission/plugin/webhook — the
apiserver POSTs an AdmissionReview to every matching webhook from the
Mutating/ValidatingWebhookConfiguration objects; mutating responses may
carry a JSONPatch over the object's wire form; a webhook that cannot be
reached fails open or closed per its failurePolicy. This build speaks the
same AdmissionReview shape over plain HTTP (service references are not
modeled; client_config carries a URL).

Wire shapes:
  request:  {"kind": "AdmissionReview", "request": {"uid", "resource",
             "operation" (CREATE/UPDATE/DELETE), "object": {...}}}
  response: {"response": {"allowed": bool, "status": {"message": str},
             "patchType": "JSONPatch", "patch": base64(json list)}}
"""

from __future__ import annotations

import base64
import json
import logging
import urllib.error
import urllib.request
import uuid
from typing import Any, List, Optional

from ..api import serialization
from .auth import AdmissionDenied, AdmissionPlugin

logger = logging.getLogger("kubernetes_tpu.apiserver.webhook")


def apply_json_patch(doc: Any, patch: List[dict]) -> Any:
    """Minimal RFC 6902: add / replace / remove over dicts and lists
    (the reference accepts exactly JSONPatch from mutating webhooks)."""
    for op in patch:
        path = [p.replace("~1", "/").replace("~0", "~") for p in op["path"].lstrip("/").split("/")]
        parent = doc
        for seg in path[:-1]:
            parent = parent[int(seg) if isinstance(parent, list) else seg]
        leaf = path[-1]
        kind = op["op"]
        if isinstance(parent, list):
            idx = len(parent) if leaf == "-" else int(leaf)
            if kind == "add":
                parent.insert(idx, op["value"])
            elif kind == "replace":
                parent[idx] = op["value"]
            elif kind == "remove":
                del parent[idx]
            else:
                raise ValueError(f"unsupported JSONPatch op {kind!r}")
        else:
            if kind == "add" or kind == "replace":
                parent[leaf] = op["value"]
            elif kind == "remove":
                parent.pop(leaf, None)
            else:
                raise ValueError(f"unsupported JSONPatch op {kind!r}")
    return doc


def _matches(hook, resource: str, verb: str) -> bool:
    op = {"create": "CREATE", "update": "UPDATE", "delete": "DELETE"}.get(
        verb, verb.upper()
    )
    for rule in hook.rules or []:
        ops_ok = "*" in rule.operations or op in rule.operations
        res_ok = "*" in rule.resources or resource in rule.resources
        if ops_ok and res_ok:
            return True
    return not hook.rules  # no rules = match everything (defaulted "*")


class WebhookUnavailable(Exception):
    """Transport failure OR unusable response — both are 'the webhook did
    not answer' for failurePolicy purposes."""


def _call(hook, resource: str, verb: str, obj) -> dict:
    review = {
        "kind": "AdmissionReview",
        "request": {
            "uid": str(uuid.uuid4()),
            "resource": resource,
            "operation": verb.upper(),
            "object": serialization.encode(obj) if obj is not None else None,
        },
    }
    req = urllib.request.Request(
        hook.client_config.url,
        data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=hook.timeout_seconds) as r:
            body = r.read()
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise WebhookUnavailable(str(e)) from None
    try:
        resp = json.loads(body or b"{}").get("response", {})
        if not isinstance(resp, dict):
            raise ValueError(f"response is {type(resp).__name__}, not object")
        return resp
    except (ValueError, AttributeError) as e:
        # HTML error page, truncated body, wrong shape: same treatment as
        # unreachable — failurePolicy decides
        raise WebhookUnavailable(f"malformed AdmissionReview response: {e}") from None


class _WebhookAdmission(AdmissionPlugin):
    """Shared dispatch; subclasses pick the configuration resource and
    whether patches apply."""

    config_resource = ""
    mutating = False

    def __init__(self, server):
        self.server = server

    # BOTH configuration kinds are exempt from BOTH plugins: if each kind
    # were only exempt from its own plugin, two broken failurePolicy=Fail
    # configs could veto each other's deletion and lock the cluster out of
    # every write forever (upstream exempts the admissionregistration
    # group for the same reason)
    EXEMPT_RESOURCES = frozenset(
        {"mutatingwebhookconfigurations", "validatingwebhookconfigurations"}
    )

    def _dispatch(self, verb: str, resource: str, obj) -> None:
        if resource in self.EXEMPT_RESOURCES:
            return
        try:
            configs, _ = self.server.list(self.config_resource)
        except Exception:
            return
        for cfg in configs:
            for hook in cfg.webhooks:
                if not _matches(hook, resource, verb):
                    continue
                try:
                    resp = _call(hook, resource, verb, obj)
                except WebhookUnavailable as e:
                    if hook.failure_policy == "Ignore":
                        logger.warning(
                            "webhook %s unavailable (ignored): %s", hook.name, e
                        )
                        continue
                    raise AdmissionDenied(
                        f"webhook {hook.name!r} unavailable and failurePolicy"
                        f"=Fail: {e}"
                    ) from None
                if not resp.get("allowed", False):
                    msg = (resp.get("status") or {}).get("message", "denied")
                    raise AdmissionDenied(
                        f"admission webhook {hook.name!r} denied the request: {msg}"
                    )
                patch_b64 = resp.get("patch")
                if self.mutating and patch_b64 and obj is not None:
                    try:
                        patch = json.loads(base64.b64decode(patch_b64))
                        doc = apply_json_patch(
                            serialization.encode(obj), patch
                        )
                        new_obj = serialization.decode(resource, doc)
                    except Exception as e:
                        raise AdmissionDenied(
                            f"webhook {hook.name!r} returned an unusable "
                            f"patch: {e}"
                        ) from None
                    # immutable-metadata guard (the reference re-validates
                    # object meta after mutation): a patch renaming the
                    # object would silently change its store identity (the
                    # key is derived AFTER admission), and a patched
                    # resourceVersion would subvert the conflict check
                    old_m, new_m = obj.metadata, new_obj.metadata
                    for f in ("name", "namespace", "uid", "resource_version"):
                        if getattr(new_m, f) != getattr(old_m, f):
                            raise AdmissionDenied(
                                f"webhook {hook.name!r} patch mutates "
                                f"immutable metadata.{f}"
                            )
                    # status is not admittable content either: keep ours
                    if hasattr(obj, "status"):
                        new_obj.status = obj.status
                    # graft the mutated state onto the live object the
                    # admission chain carries forward
                    obj.__dict__.update(new_obj.__dict__)


class MutatingWebhookAdmission(_WebhookAdmission):
    name = "MutatingAdmissionWebhook"
    config_resource = "mutatingwebhookconfigurations"
    mutating = True

    def mutate(self, verb: str, resource: str, obj) -> None:
        self._dispatch(verb, resource, obj)


class ValidatingWebhookAdmission(_WebhookAdmission):
    name = "ValidatingAdmissionWebhook"
    config_resource = "validatingwebhookconfigurations"
    mutating = False

    def validate(self, verb: str, resource: str, obj) -> None:
        self._dispatch(verb, resource, obj)
