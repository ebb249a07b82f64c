"""HTTP REST façade over the in-process versioned store.

Paths follow the core-group conventions the reference serves
(staging/src/k8s.io/apiserver; handler chain config.go:660 — here reduced
to panic recovery + optional admit hooks):

  GET    /healthz | /readyz | /livez
  GET    /api/v1/{resource}                     (cluster list)
  (authn/authz: optional bearer-token authenticator + RBAC-lite authorizer
  run before every resource verb — apiserver/auth.py; admission runs inside
  the store's admit hooks so HTTP and in-process clients share the gate)
  GET    /api/v1/{resource}?watch=1&resourceVersion=N   (watch stream)
  GET    /api/v1/namespaces/{ns}/{resource}
  GET    /api/v1/namespaces/{ns}/{resource}/{name}
  POST   /api/v1/namespaces/{ns}/{resource} | /api/v1/{resource}
  PUT    /api/v1/namespaces/{ns}/{resource}/{name}
  DELETE /api/v1/namespaces/{ns}/{resource}/{name}
  POST   /api/v1/namespaces/{ns}/pods/{name}/binding     (bind subresource)

Watch responses stream newline-delimited JSON events
({"type": "ADDED"|"MODIFIED"|"DELETED", "object": {...}}), the same wire
shape client-go's Reflector consumes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api import serialization as codec
from ..api.objects import Binding
from ..client.apiserver import (
    AlreadyExists,
    APIServer,
    Conflict,
    Expired,
    LeaderFenced,
    NotFound,
    NotPrimary,
)
from ..runtime.consensus import (
    DegradedWrites,
    DiskFailed,
    DiskPressure,
    QuorumLost,
)
from ..api.validation import ValidationError
from .auth import AdmissionDenied

_WATCH_POLL_S = 0.5


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "kube-apiserver-tpu"
    # TCP_NODELAY on every accepted socket: response header/body go out
    # as separate small writes, and with Nagle on the second stalls
    # behind the client's delayed ACK (~40 ms per request — measured as
    # the dominant pooled-bind cost before the serving-tier work)
    disable_nagle_algorithm = True

    def log_message(self, *args):
        pass

    def send_response(self, code, message=None):
        self._last_code = code  # recorded for the audit event
        super().send_response(code, message)

    # -- helpers -------------------------------------------------------------

    @property
    def store(self) -> APIServer:
        return self.server.store

    def _json(self, code: int, payload, extra_headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for h, v in (extra_headers or {}).items():
            self.send_header(h, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _wants_proto(self) -> bool:
        from ..api.protocodec import CONTENT_TYPE

        return CONTENT_TYPE in (self.headers.get("Accept") or "")

    def _respond_obj(self, code: int, obj) -> None:
        """Single-object response with content negotiation: the binary
        envelope when the client asked for application/vnd.kubernetes.
        protobuf (reference protobuf.go serializer), JSON otherwise.
        Custom resources are JSON-only (as in the reference: protobuf is
        unsupported for CRDs)."""
        from ..api import objects as v1api
        from ..api import protocodec

        if self._wants_proto() and not isinstance(obj, v1api.Unstructured):
            body = protocodec.encode_obj(obj)
            self.send_response(code)
            self.send_header("Content-Type", protocodec.CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._json(code, codec.encode(obj))

    def _status_error(
        self,
        code: int,
        reason: str,
        message: str,
        retry_after_s: Optional[float] = None,
    ) -> None:
        # retry_after_s -> Retry-After header: a degraded read-only store
        # (503) tells well-behaved clients when to come back (client.py's
        # RESTClient honors it)
        self._json(
            code,
            {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "reason": reason,
                "message": message,
                "code": code,
            },
            extra_headers=(
                {"Retry-After": str(max(1, round(retry_after_s)))}
                if retry_after_s is not None
                else None
            ),
        )

    def _degraded_error(self, e: DegradedWrites) -> None:
        """Degraded-store write rejection: 503 + Retry-After. The reason
        distinguishes the two retry contracts: "Degraded" (the gate
        refused BEFORE applying anything — safe to replay verbatim) vs
        "WriteQuorumLost" (THIS write applied locally but missed quorum;
        its outcome is unknown — a blind replay of a create would 409
        AlreadyExists against its own first attempt once followers catch
        up, so the client must surface it instead of auto-retrying).
        Disk states get their own reasons so clients can tell a replica
        that will NEVER write again ("DiskFailed": fail-stopped sink,
        recovery is leader failover) from transient volume pressure
        ("DiskPressure": lifts when space frees). Reads and watches keep
        serving — only mutations land here."""
        if isinstance(e, DiskFailed):
            reason = "DiskFailed"
        elif isinstance(e, DiskPressure):
            reason = "DiskPressure"
        elif isinstance(e, QuorumLost):
            reason = "WriteQuorumLost"
        else:
            reason = "Degraded"
        self._status_error(
            503,
            reason,
            str(e),
            retry_after_s=getattr(e, "retry_after_s", 1.0),
        )

    def _parse(self) -> Tuple[Optional[str], Optional[str], Optional[str], dict]:
        """(resource, namespace, name, query) or (None, ...) on bad path.

        Serves the core group (/api/v1/...) and named groups
        (/apis/{group}/{version}/... — the apiextensions/aggregator path;
        group routing is decided by _serve_group before this is used)."""
        u = urlparse(self.path)
        parts = [p for p in u.path.split("/") if p]
        query = {k: v[-1] for k, v in parse_qs(u.query).items()}
        if len(parts) >= 2 and parts[0] == "api" and parts[1] == "v1":
            rest = parts[2:]
        elif len(parts) >= 3 and parts[0] == "apis":
            rest = parts[3:]  # /apis/{group}/{version}/...
        else:
            return None, None, None, query
        if not rest:
            return None, None, None, query
        if rest[0] == "namespaces" and len(rest) >= 3:
            ns = rest[1]
            resource = rest[2]
            name = rest[3] if len(rest) > 3 else None
            sub = rest[4] if len(rest) > 4 else None
            return resource, ns, name if not sub else f"{name}/{sub}", query
        resource = rest[0]
        name = rest[1] if len(rest) > 1 else None
        return resource, None, name, query

    def _group_of_path(self) -> Optional[str]:
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if len(parts) >= 2 and parts[0] == "apis":
            return parts[1]
        return None

    def _version_of_path(self) -> Optional[str]:
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if len(parts) >= 3 and parts[0] == "apis":
            return parts[2]
        return None

    def _cr_write_gate(self, resource: str, body: dict) -> None:
        """Custom-resource write validation (apiextensions): when the
        resource is CRD-served, enforce per-version serving + the
        version's openAPIV3Schema, and rewrite the body to the storage
        apiVersion (conversion strategy None). No-op for built-ins."""
        if resource in codec.RESOURCE_KINDS:
            return
        from .crdschema import check_cr_write, find_crd

        crd = find_crd(self.store, resource, self._group_of_path())
        if crd is None:
            return
        body["apiVersion"] = check_cr_write(
            crd, self._version_of_path(), body
        )

    def _resource_served(self, resource: str) -> bool:
        """Group-aware serving gate: core-path (/api/v1) requests serve
        built-ins only; /apis/{group}/... serves a resource only when an
        established CRD claims that exact (group, plural). (CR storage is
        keyed by plural; two CRDs reusing one plural across groups is
        rejected at routing granularity, mirroring the reference's
        ambiguous-plural restrictions.)"""
        group = self._group_of_path()
        # close the late-registration import-order hole (events/leases
        # kinds live in client/*): a process whose import chain swallowed
        # the eager registration must not 404 those resources forever
        codec.ensure_late_registration()
        if group is None and resource in codec.RESOURCE_KINDS:
            # built-in fast path, BEFORE the CRD lookup: on a stateless
            # frontend the store is a RESTClient and that lookup is a
            # remote list — paying it per request would put the primary
            # back on every read's critical path
            return True
        try:
            crds, _ = self.store.list("customresourcedefinitions")
        except Exception:
            crds = []
        if group is None:
            # the core path also serves established CRD plurals: the typed
            # REST client and kubectl build /api/v1 paths for every
            # resource (single internal version — no per-group clients)
            return any(c.spec.names.plural == resource for c in crds)
        version = self._version_of_path()
        for c in crds:
            if c.spec.group != group or c.spec.names.plural != resource:
                continue
            # per-version serving (apiextensions served flag): an
            # unserved version 404s even though the CRD claims the group
            if version is not None:
                from .crdschema import version_entry

                entry = version_entry(c, version)
                return entry is not None and entry["served"]
            return True
        return False

    def _maybe_proxy(self) -> bool:
        """kube-aggregator: if an APIService claims this path's group with a
        backend URL, forward the request verbatim and relay the response
        (staging/src/k8s.io/kube-aggregator proxy handler). Returns True if
        the request was proxied."""
        group = self._group_of_path()
        if group is None:
            return False
        try:
            svcs, _ = self.store.list("apiservices")
        except Exception:
            return False
        svc = next(
            (
                s
                for s in sorted(svcs, key=lambda s: s.spec.priority)
                if s.spec.group == group and s.spec.service_url
            ),
            None,
        )
        if svc is None:
            return False
        backend = svc.spec.service_url
        # the aggregator AUTHENTICATES before proxying (authorization is the
        # backend's job, like the reference forwarding user headers); an
        # anonymous-rejecting front server must not leak a bypass
        user, ok = self._authenticate()
        if not ok:
            return True  # 401 already written
        import urllib.error
        import urllib.request

        url = backend.rstrip("/") + self.path
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else None
        req = urllib.request.Request(url, data=body, method=self.command)
        for h in ("Content-Type", "Authorization"):
            if self.headers.get(h):
                req.add_header(h, self.headers[h])
        # requestheader identity propagation (X-Remote-*): the backend
        # trusts these from the front proxy, so client-supplied values
        # must NEVER pass through (spoof protection) — urllib won't copy
        # them since only the allowlist above is forwarded — and the
        # authenticated identity is stamped fresh
        if user is not None:
            req.add_header("X-Remote-User", user.name)
            groups = getattr(user, "groups", ()) or ()
            if groups:
                # one comma-combined field (RFC 7230 §3.2.2) — urllib
                # cannot emit repeated headers
                req.add_header("X-Remote-Group", ",".join(groups))
        ctx = None
        if url.startswith("https:"):
            try:
                ctx = _backend_ssl_context(svc.spec)
            except Exception as e:
                # e.g. invalid base64 / garbage PEM in the caBundle: the
                # APIService is misconfigured, not the request
                self._status_error(
                    502, "BadGateway", f"apiservice caBundle invalid: {e}"
                )
                return True
        try:
            with urllib.request.urlopen(req, timeout=30, context=ctx) as resp:
                payload = resp.read()
                self.send_response(resp.status)
                for h, val in resp.headers.items():
                    if h.lower() in ("content-type",):
                        self.send_header(h, val)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
        except urllib.error.HTTPError as e:
            payload = e.read()
            self.send_response(e.code)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        except OSError as e:
            self._status_error(502, "BadGateway", f"aggregated backend: {e}")
        return True

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        from ..api.protocodec import CONTENT_TYPE, MAGIC, decode_obj

        if CONTENT_TYPE in (
            self.headers.get("Content-Type") or ""
        ) and raw.startswith(MAGIC):
            # binary write body: decode the envelope, then re-encode to the
            # JSON-ready dict every downstream handler already consumes —
            # one negotiation point covers every write path
            try:
                return codec.encode(decode_obj(raw))
            except Exception as e:
                # truncated varints/frames surface as IndexError/
                # struct.error/ValueError — map to 400 like malformed JSON
                raise ValidationError(f"malformed binary body: {e}") from e
        return json.loads(raw or b"{}")

    _request_user = None  # per-request memo set by _limited's APF path

    def _authenticate(self):
        """(user, ok): resolve the request identity. ok=False means a 401
        was already written. user is None only on the insecure port (no
        authenticator configured). The resolved identity is published to
        in-process admission via the admission.request_user contextvar
        (admission.Attributes.GetUserInfo() equivalent — NodeRestriction
        reads it)."""
        from .admission import request_user as _admission_user

        if self._request_user is not None:
            _admission_user.set(self._request_user[0])
            return self._request_user
        authn = self.server.authenticator
        if authn is None:
            _admission_user.set(None)
            return None, True
        from .auth import ANONYMOUS, UserInfo

        user = authn.authenticate_header(self.headers.get("Authorization", ""))
        if user is None:
            if not authn.allow_anonymous:
                self._status_error(401, "Unauthorized", "authentication required")
                return None, False
            user = UserInfo(ANONYMOUS, ("system:unauthenticated",))
        _admission_user.set(user)
        return user, True

    def _authorize(
        self, verb: str, resource: str, ns: Optional[str], name: str = ""
    ) -> bool:
        """authn → authz (DefaultBuildHandlerChain order). True = proceed;
        False = a 401/403 response was already written. No authenticator
        configured = insecure port semantics (everything allowed)."""
        authz = self.server.authorizer
        user, ok = self._authenticate()
        if not ok:
            return False
        if user is None:
            return True
        # ns None = cluster-scoped / cluster-wide request: requires a rule
        # covering all namespaces (the ClusterRole analogue)
        if authz is not None and not authz.authorize(
            user, verb, resource, ns if ns is not None else "*", name
        ):
            self._status_error(
                403,
                "Forbidden",
                f'user "{user.name}" cannot {verb} resource "{resource}"',
            )
            return False
        return True

    # -- verbs ---------------------------------------------------------------

    def _serve_metrics_api(self) -> bool:
        """metrics.k8s.io equivalent (staging/src/k8s.io/metrics +
        metrics-server): node/pod usage. Usage comes from the pods'
        ``metrics.kubernetes.io/cpu-usage`` annotations when present (the
        same source the HPA reads), else falls back to requests — a
        deterministic synthetic signal, the hollow-cluster analogue of
        cAdvisor. Served locally unless an APIService claims the group."""
        parts = [p for p in urlparse(self.path).path.split("/") if p]
        if len(parts) < 4 or parts[:2] != ["apis", "metrics.k8s.io"]:
            return False
        # usage data is cluster-visibility: authn/authz like any resource
        # (grant via Rule(resources={"metrics"}))
        if not self._authorize("get", "metrics", None):
            return True  # a 401/403 was written
        rest = parts[3:]
        from ..api.objects import compute_pod_resource_request
        from ..api.resources import CPU, MEMORY, cpu_to_millis

        def pod_usage(p):
            ann = p.metadata.annotations
            raw = ann.get("metrics.kubernetes.io/cpu-usage")
            raw_mem = ann.get("metrics.kubernetes.io/memory-usage")
            req = compute_pod_resource_request(p)
            try:
                cpu = cpu_to_millis(raw) if raw else int(req.get(CPU, 0))
            except ValueError:
                cpu = int(req.get(CPU, 0))
            try:
                mem = int(raw_mem) if raw_mem else int(req.get(MEMORY, 0))
            except ValueError:
                mem = int(req.get(MEMORY, 0))
            return {"cpu": f"{cpu}m", "memory": str(mem)}

        pods, _ = self.store.list("pods")
        running = [p for p in pods if p.spec.node_name]
        if rest and rest[0] == "nodes":
            per_node = {}
            for p in running:
                u = pod_usage(p)
                agg = per_node.setdefault(p.spec.node_name, [0, 0])
                agg[0] += int(u["cpu"][:-1])
                agg[1] += int(u["memory"])
            nodes, _ = self.store.list("nodes")
            items = [
                {
                    "metadata": {"name": n.metadata.name},
                    "usage": {
                        "cpu": f"{per_node.get(n.metadata.name, [0, 0])[0]}m",
                        "memory": str(per_node.get(n.metadata.name, [0, 0])[1]),
                    },
                }
                for n in nodes
                if not rest[1:] or n.metadata.name == rest[1]
            ]
            self._json(200, {"kind": "NodeMetricsList", "items": items})
            return True
        ns = None
        if rest and rest[0] == "namespaces" and len(rest) >= 3:
            ns, rest = rest[1], rest[2:]
        if rest and rest[0] == "pods":
            items = [
                {
                    "metadata": {
                        "name": p.metadata.name,
                        "namespace": p.metadata.namespace,
                    },
                    "usage": pod_usage(p),
                }
                for p in running
                if ns is None or p.metadata.namespace == ns
            ]
            self._json(200, {"kind": "PodMetricsList", "items": items})
            return True
        return False


    # -- max-in-flight (DefaultBuildHandlerChain's WithMaxInFlightLimit) ----

    def _is_long_running(self) -> bool:
        """Watch streams are exempt from in-flight limits (the reference's
        longRunningRequestCheck). ONLY GET watches qualify — a write with
        ?watch=1 appended is an ordinary request and must consume a slot,
        or the limiter is trivially bypassable."""
        if self.command != "GET":
            return False
        q = parse_qs(urlparse(self.path).query)
        return q.get("watch", ["0"])[-1] in ("1", "true")

    def _audited(self, handler):
        """WithAudit (config.go:668): one ResponseComplete event per
        request, recorded after the handler writes its code. Wraps the
        WHOLE chain so limiter 429s and authn 401s are audited too — the
        rejections are when the trail matters most."""
        aud = getattr(self.server, "audit", None)
        if aud is None:
            return handler()
        self._last_code = 0  # keep-alive reuses the handler: never carry a
        # previous request's code into this event
        try:
            return handler()
        finally:
            try:
                # _limited's APF path memoizes the authenticated user for
                # exactly this finally (it must outlive _limited's own
                # finally, which releases the flow-control slot; the memo
                # is cleared below — keep-alive connections reuse the
                # handler across requests)
                # identity WITHOUT response-writing: the memoized APF user
                # if present, else a silent header resolve (a failed authn
                # already wrote its 401; never write from a finally)
                if self._request_user is not None:
                    user = self._request_user[0]
                elif self.server.authenticator is not None:
                    user = self.server.authenticator.authenticate_header(
                        self.headers.get("Authorization", "")
                    )
                else:
                    user = None
                resource, ns, name, _q = self._parse()
                if resource is not None:
                    if self._is_long_running():
                        verb = "watch"  # logged when the stream ends
                    else:
                        verb = {
                            "GET": "get" if name else "list",
                            "POST": "create",
                            "PUT": "update",
                            "DELETE": "delete",
                        }.get(self.command, self.command.lower())
                    aud.log(
                        user.name if user else None,
                        user.groups if user else (),
                        verb,
                        resource,
                        ns or "",
                        name or "",
                        getattr(self, "_last_code", 0),
                    )
            except Exception:
                pass  # auditing must never break request handling
            finally:
                self._request_user = None

    _watch_seat = None  # (flow, level) held during watch INITIALIZATION

    def _release_watch_seat(self) -> None:
        """Release the APF seat a watch held for its init phase (list/
        window replay). Idempotent — called by _serve_watch as soon as
        the replay drains, and again by _limited's finally as a backstop
        for error paths that never reached the drain point."""
        seat = self._watch_seat
        if seat is not None:
            self._watch_seat = None
            fc, lv = seat
            fc.end(lv)

    def _flow_admit(self, fc, verb: str):
        """authn → classify → admit for APF. Returns the admitted level,
        or None when a response (401/429) was already written. Memoizes
        the classification's identity for this one request: the handler's
        _authorize and _audited's event reuse it instead of re-resolving
        the token. Cleared by _audited's outer finally (keep-alive
        connections reuse the handler across requests); when no audit is
        configured the caller's finally clears it."""
        from .flowcontrol import RequestRejected

        user, ok = self._authenticate()
        if not ok:
            return None
        resource, _, _, _ = self._parse()
        try:
            lv = fc.begin(user, resource or "", verb)
        except RequestRejected as e:
            self._status_error(429, "TooManyRequests", str(e))
            return None
        self._request_user = (user, True)
        return lv

    def _limited(self, handler):
        """WithPriorityAndFairness when a FlowController is configured,
        else WithMaxInFlightLimit, else unlimited (insecure dev port).
        Request order through the chain matches DefaultBuildHandlerChain:
        authn happens before flow classification, authz after.

        Watch streams are exempt from the per-request limiters for their
        LIFETIME, but their INITIALIZATION — the cache replay that makes a
        cold informer expensive — occupies a seat (watch-init seat
        accounting, the reference's APF watch-init cost): 10k informers
        reconnecting at once queue behind the watch-init pool instead of
        monopolizing the server. The seat is handed to _serve_watch via
        _watch_seat so it can release the moment the replay drains."""
        fc = getattr(self.server, "flow", None)
        if self._is_long_running():
            if fc is None:
                return handler()
            lv = self._flow_admit(fc, "watch")
            if lv is None:
                return
            self._watch_seat = (fc, lv)
            try:
                return handler()
            finally:
                if getattr(self.server, "audit", None) is None:
                    self._request_user = None
                self._release_watch_seat()
        if fc is not None:
            lv = self._flow_admit(fc, self.command.lower())
            if lv is None:
                return
            try:
                return handler()
            finally:
                if getattr(self.server, "audit", None) is None:
                    self._request_user = None
                fc.end(lv)
        sem = self.server.inflight
        if sem is None:
            return handler()
        if not sem.acquire(blocking=False):
            return self._status_error(
                429, "TooManyRequests", "max in-flight requests exceeded"
            )
        try:
            return handler()
        finally:
            sem.release()

    def do_GET(self):
        return self._audited(lambda: self._limited(self._handle_GET))

    def do_POST(self):
        return self._audited(lambda: self._limited(self._handle_POST))

    def do_PUT(self):
        return self._audited(lambda: self._limited(self._handle_PUT))

    def do_DELETE(self):
        return self._audited(lambda: self._limited(self._handle_DELETE))

    def _handle_GET(self):
        u = urlparse(self.path)
        if u.path in ("/healthz", "/readyz", "/livez"):
            body = b"ok"
            self.send_response(200)
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/metrics":
            # Prometheus exposition for THIS process (the debug surface
            # every process family now shares — utils/debugserver.py is
            # the standalone listener for scheduler/controller-manager).
            # Authorized like the metrics.k8s.io route: on a secured API
            # port the registry is not an anonymous surface.
            if not self._authorize("get", "metrics", None):
                return
            from ..utils.debugserver import metrics_payload

            body, ctype = metrics_payload()
            self.send_response(200)
            self._last_code = 200
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if u.path == "/debug/backup":
            # online consistent backup image (runtime/backup.py writes it
            # out; `ktpu-backup save --url` is the operator entry). Same
            # authz gate as /metrics: the image is the whole cluster
            # state, emphatically not an anonymous surface.
            if not self._authorize("get", "metrics", None):
                return
            return self._json(200, self.store.backup_state())
        if u.path == "/debug/traces":
            # the trace ring's REST view: ?id=<trace_id> for one trace
            # (store-side stamps attached), else slowest-N (?n=, ?kind=).
            # Same authz gate as /metrics: traces carry pod identities.
            if not self._authorize("get", "metrics", None):
                return
            from ..utils.debugserver import traces_payload

            q = {k: v[-1] for k, v in parse_qs(u.query).items()}
            code, payload = traces_payload(q)
            return self._json(code, payload)
        if self._maybe_proxy():
            return
        if self._serve_metrics_api():
            return
        resource, ns, name, query = self._parse()
        if resource is None:
            return self._status_error(404, "NotFound", "unknown path")
        if not self._resource_served(resource):
            return self._status_error(404, "NotFound", f"no such resource {resource}")
        verb = (
            "get"
            if name
            else ("watch" if query.get("watch") in ("1", "true") else "list")
        )
        if not self._authorize(verb, resource, ns, name or ""):
            return
        try:
            if resource == "pods" and name and name.endswith("/log"):
                # pods/{name}/log subresource -> node's log provider (the
                # kubelet hop of kubectl logs); plain text like the
                # reference's log REST handler
                tail = query.get("tailLines")
                try:
                    tail_n = int(tail) if tail is not None else None
                except ValueError:
                    return self._status_error(
                        400, "BadRequest", f"invalid tailLines {tail!r}"
                    )
                text = self.store.pod_logs(
                    ns or "", name[: -len("/log")], tail_n
                )
                body = text.encode()
                self.send_response(200)
                self._last_code = 200
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if name:
                obj = self.store.get(resource, ns or "", name)
                return self._respond_obj(200, obj)
            if query.get("kindResourceVersion") in ("1", "true"):
                # cheap freshness probe (no object payload): the rv of
                # this kind's newest event — what a frontend's consistent
                # list waits for before serving from its cache. Forwarded
                # upstream when this server is itself a frontend
                # (RESTClient.kind_resource_version chains).
                return self._json(
                    200,
                    {
                        "kind": "KindResourceVersion",
                        "resource": resource,
                        "kindResourceVersion": self.store.kind_resource_version(
                            resource
                        ),
                    },
                )
            if query.get("watch") in ("1", "true"):
                return self._serve_watch(resource, ns, query)
            try:
                pred = _list_options_predicate(query)
            except ValueError as e:
                return self._status_error(400, "BadRequest", str(e))
            cacher = getattr(self.server, "cacher", None)
            limit_s = query.get("limit")
            try:
                limit = int(limit_s) if limit_s is not None else 0
            except ValueError:
                limit = -1
            if limit < 0:
                # negative limits would hit Python slice semantics in the
                # paginator (an endless 0-item continuation loop); the
                # reference rejects them too
                return self._status_error(
                    400, "BadRequest", f"invalid limit {limit_s!r}"
                )
            cont = query.get("continue")
            # list-from-cache (reference GetList via cacher): paginated
            # lists and resourceVersion=0 lists serve from the watch cache
            # at one consistent rv; a plain list stays a store quorum read
            if cacher is not None and (limit or cont or
                                       query.get("resourceVersion") == "0"):
                try:
                    items, rv, next_token = cacher.list_page(
                        resource,
                        namespace=ns,
                        pred=pred,
                        limit=limit,
                        continue_token=cont,
                        # a limit list without rv=0 is still a consistent
                        # read: wait for the cache to consume THIS KIND's
                        # newest event (the global rv would never converge
                        # for a quiet kind — other kinds keep advancing it)
                        fresh_rv=(
                            None
                            if query.get("resourceVersion") == "0" or cont
                            else self.store.kind_resource_version(resource)
                        ),
                    )
                except Expired as e:
                    return self._status_error(410, "Expired", str(e))
                except TimeoutError as e:
                    # cache could not catch the kind's newest event up in
                    # time — retryable, never a silent stale 200
                    return self._status_error(
                        504, "Timeout", str(e), retry_after_s=1.0
                    )
                meta = {"resourceVersion": str(rv)}
                if next_token:
                    meta["continue"] = next_token
                return self._json(
                    200,
                    {
                        "kind": "List",
                        "apiVersion": "v1",
                        "metadata": meta,
                        "items": [codec.encode(o) for o in items],
                    },
                )
            objs, rv = self.store.list(resource, namespace=ns)
            if pred is not None:
                objs = [o for o in objs if pred(o)]
            return self._json(
                200,
                {
                    "kind": "List",
                    "apiVersion": "v1",
                    "metadata": {"resourceVersion": str(rv)},
                    "items": [codec.encode(o) for o in objs],
                },
            )
        except NotFound as e:
            return self._status_error(404, "NotFound", str(e))
        except KeyError as e:
            return self._status_error(404, "NotFound", str(e))

    def _serve_watch(self, resource: str, ns: Optional[str], query: dict):
        from ..runtime.watch import BOOKMARK

        from_rv = int(query.get("resourceVersion", 0) or 0)
        cacher = getattr(self.server, "cacher", None)
        try:
            if cacher is not None:
                # the watch cache absorbs the fan-out: this stream is one
                # of N queue consumers on ONE store watch per kind, and a
                # from_rv inside the event window replays from memory
                watcher = cacher.watch(resource, from_version=from_rv)
            else:
                watcher = self.store.watch(resource, from_version=from_rv)
        except Expired as e:
            # 410 Gone ("resourceVersion too old"): the client must
            # re-list, exactly like the reference's etcd3 watcher
            return self._status_error(410, "Expired", str(e))
        try:
            pred = _list_options_predicate(query)
        except ValueError as e:
            watcher.stop()
            return self._status_error(400, "BadRequest", str(e))
        from ..utils.metrics import metrics

        metrics.inc("apiserver_watch_streams_started_total",
                    {"resource": resource})
        self.server.watch_streams_adjust(resource, +1)
        import time as _time

        bookmark_period = getattr(self.server, "bookmark_period_s", 2.0)
        # seat accounting: the APF watch-init seat covers the REPLAY phase
        # only; once the initial burst drains this stream is a cheap queue
        # consumer and the seat goes back to the pool
        replay_left = getattr(watcher, "replay_count", 0)
        if replay_left == 0:
            self._release_watch_seat()
        last_write = _time.monotonic()
        # rv of the last event actually WRITTEN to this stream: the idle
        # heartbeat must never advertise an rv ahead of what the client
        # has received — a cache rv read out-of-band can cover an event
        # still sitting undelivered in this watcher's queue, and a client
        # resuming past it would silently lose the event forever. RV
        # advancement for idle clients comes from the cacher's own
        # bookmarks, which flow queue-ordered with the events.
        last_rv_sent = from_rv

        # codec negotiation: a client offering the compact binary watch
        # codec in Accept gets length-prefixed frames (the object payload
        # encoded ONCE per event and shared across every stream of this
        # kind's fan-out — apiserver/watchcodec.py); everyone else gets
        # the newline-JSON wire, which stays the default and the
        # mixed-version fallback (an old client never offers, an old
        # server never answers binary)
        from . import watchcodec

        binary = watchcodec.WATCH_CONTENT_TYPE in (
            self.headers.get("Accept") or ""
        )

        def write_chunk(payload: bytes) -> None:
            nonlocal last_write
            self.wfile.write(b"%x\r\n%s\r\n" % (len(payload), payload))
            self.wfile.flush()
            last_write = _time.monotonic()

        def write_event(ev) -> None:
            if binary:
                write_chunk(watchcodec.event_frame(ev))
            else:
                write_chunk(
                    json.dumps(
                        {"type": ev.type, "object": codec.encode(ev.object)}
                    ).encode()
                    + b"\n"
                )

        def write_bookmark(rv: int) -> None:
            if binary:
                write_chunk(watchcodec.bookmark_frame(rv))
            else:
                write_chunk(
                    json.dumps(
                        {
                            "type": BOOKMARK,
                            "object": {"metadata": {"resourceVersion": rv}},
                        }
                    ).encode()
                    + b"\n"
                )

        # a watch client never speaks again after its request, so a
        # READABLE connection means EOF (orderly close) or garbage —
        # either way the stream is over. Peeking costs one syscall per
        # idle poll and turns "gauge leaks until the next heartbeat
        # tick" into detection within _WATCH_POLL_S. TLS sockets can't
        # MSG_PEEK through the record layer; they rely on the heartbeat.
        import select as _select
        import socket as _socket

        def client_gone() -> bool:
            sock = self.connection
            try:
                import ssl as _ssl

                if isinstance(sock, _ssl.SSLSocket):
                    return False
                readable, _, errored = _select.select([sock], [], [sock], 0)
                if errored:
                    return True
                if not readable:
                    return False
                return sock.recv(1, _socket.MSG_PEEK) == b""
            except (OSError, ValueError):
                return True

        # gauge unwind: exactly once, AT the failure site when a write
        # fails (the regression in ISSUE 20: waiting for finally meant
        # an abrupt disconnect mid-frame held the gauge until the next
        # heartbeat tick on other code paths), in finally otherwise
        gauge_open = True

        def gauge_close() -> None:
            nonlocal gauge_open
            if gauge_open:
                gauge_open = False
                self.server.watch_streams_adjust(resource, -1)

        try:
            self.send_response(200)
            self.send_header(
                "Content-Type",
                watchcodec.WATCH_CONTENT_TYPE if binary else "application/json",
            )
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while not self.server.stopping.is_set():
                ev = watcher.get(timeout=_WATCH_POLL_S)
                if ev is None:
                    if watcher.stopped:
                        break
                    self._release_watch_seat()  # queue drained: init over
                    if client_gone():
                        break
                    # idle heartbeat: a stream with no events still emits
                    # a bookmark every bookmark_period_s, so a half-open
                    # TCP client (silently dropped connection) fails the
                    # write and this thread is reaped instead of leaking
                    if (
                        bookmark_period
                        and _time.monotonic() - last_write >= bookmark_period
                    ):
                        write_bookmark(last_rv_sent)
                    continue
                if replay_left > 0:
                    replay_left -= 1
                    if replay_left == 0:
                        self._release_watch_seat()
                if ev.type == BOOKMARK:
                    # cache-originated progress notify: forwarded before
                    # the ns/selector filters (it carries no object).
                    # Queue-ordered behind the events it covers, so its
                    # rv is safe to advertise
                    write_bookmark(ev.resource_version)
                    last_rv_sent = max(last_rv_sent, ev.resource_version)
                    continue
                obj = ev.object
                if ns is not None and obj.metadata.namespace != ns:
                    continue
                if pred is not None and not pred(obj):
                    continue
                write_event(ev)
                last_rv_sent = max(last_rv_sent, ev.resource_version)
        except (BrokenPipeError, ConnectionResetError, OSError):
            # decrement on the write-failure path itself: the stream is
            # observably dead the moment a frame write fails
            gauge_close()
        finally:
            try:
                # terminate the chunked body: without the trailer a
                # keep-alive client blocks on the half-finished stream
                # forever instead of seeing EOF and resuming (server
                # shutdown / cacher stop must look like a stream END)
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except OSError:
                pass
            watcher.stop()
            gauge_close()

    def _handle_POST(self):
        if self._maybe_proxy():
            return
        resource, ns, name, _q = self._parse()
        if resource is None:
            return self._status_error(404, "NotFound", "unknown path")
        # any authenticated user may ask "can I?" about themselves — the
        # review endpoint is exempt from the resource gate and authz
        # (apiserver authorizes selfsubjectaccessreviews for system:authenticated)
        if resource != "selfsubjectaccessreviews":
            if not self._resource_served(resource):
                return self._status_error(
                    404, "NotFound", f"no such resource {resource}"
                )
            # subresources authorize under their own resource name
            # (authorization.k8s.io attributes): pods/binding is the verb
            # the SCHEDULER holds — the node authorizer denies it to
            # kubelets even though they may create (mirror) pods
            authz_resource = resource
            if resource == "pods" and name and name.endswith("/binding"):
                authz_resource = "bindings"
            if not self._authorize("create", authz_resource, ns):
                return
        try:
            body = self._read_body()
            if resource == "pods" and name and name.endswith("/exec"):
                # pods/{name}/exec subresource (ExecSync through the pod's
                # kubelet); body: {"command": [...]} — plain-text reply
                cmd = body.get("command") or []
                if (
                    not isinstance(cmd, list)
                    or not cmd
                    or not all(isinstance(c, str) for c in cmd)
                ):
                    return self._status_error(
                        400, "BadRequest", "exec body needs a list of strings"
                    )
                try:
                    out = self.store.pod_exec(
                        ns or "default", name[: -len("/exec")], cmd
                    )
                except NotImplementedError:
                    return self._status_error(
                        501, "NotImplemented", "runtime does not support exec"
                    )
                data = out.encode()
                self.send_response(200)
                self._last_code = 200
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            if resource == "pods" and name and name.endswith("/binding"):
                b = codec.from_dict(Binding, body)
                pod_name = name.rsplit("/", 1)[0]
                b.pod_name = b.pod_name or pod_name
                b.pod_namespace = b.pod_namespace or (ns or "default")
                # leadership fencing over REST: an X-Leadership-Fence
                # header rebuilds the BindFence and the store validates it
                # against the live lease UNDER THE SAME LOCK the bind
                # applies under — a scheduler replica deposed between
                # minting the token and this request gets LeaderFenced
                # (409, distinct reason), never a silently applied late
                # bind. A malformed header is 400: it must never degrade
                # to an unfenced bind.
                from ..client.leaderelection import (
                    FENCE_HEADER,
                    fence_from_header,
                )

                fence = None
                fence_hdr = self.headers.get(FENCE_HEADER)
                if fence_hdr:
                    try:
                        fence = fence_from_header(fence_hdr)
                    except ValueError as fe:
                        return self._status_error(400, "BadRequest", str(fe))
                # trace-context propagation (utils/tracing.py): the
                # scheduler-minted trace id arrives in X-Trace-Context;
                # re-establish it thread-locally so the store's apply
                # (or LeaderFenced rejection) stamps under the SAME id —
                # a bind that crosses REST keeps its identity
                from ..utils.tracing import TRACE_HEADER, bind_context

                trace_hdr = self.headers.get(TRACE_HEADER) or ""
                bind_key = f"{b.pod_namespace}/{b.pod_name}"
                with bind_context({bind_key: trace_hdr} if trace_hdr else {}):
                    errs = self.store.bind_pods([b], fence=fence)
                if errs and errs[0] is not None:
                    # preserve the store's error taxonomy across the wire
                    # (bind_pods returns the typed exception): a vanished
                    # pod is 404 — the scheduler's reconciler branches on
                    # NotFound — and only real bind conflicts (already
                    # bound / uid mismatch) are 409
                    if isinstance(errs[0], NotFound):
                        return self._status_error(
                            404, "NotFound", str(errs[0])
                        )
                    return self._status_error(409, "Conflict", str(errs[0]))
                return self._json(201, {"kind": "Status", "status": "Success"})
            if resource == "pods" and name and name.endswith("/eviction"):
                # PDB-respecting delete (registry/core/pod/rest/eviction.go)
                from ..api.objects import Eviction
                from ..client.apiserver import TooManyRequests

                ev = codec.from_dict(Eviction, body)
                pod_name = name.rsplit("/", 1)[0]
                if ev.pod_name and ev.pod_name != pod_name:
                    return self._status_error(
                        400, "BadRequest", "eviction body names a different pod"
                    )
                try:
                    self.store.evict_pod(ns or "default", pod_name)
                except TooManyRequests as e:
                    # Retry-After rides along (eviction.go returns the
                    # DisruptedPods-style backoff hint): a paced drainer
                    # (descheduler wave, kubectl drain loop) should wait
                    # for the disruption controller's next budget resync
                    # instead of giving up on the first 429
                    return self._status_error(
                        429,
                        "TooManyRequests",
                        str(e),
                        retry_after_s=getattr(e, "retry_after_s", 1.0),
                    )
                return self._json(201, {"kind": "Status", "status": "Success"})
            if resource == "selfsubjectaccessreviews":
                # authz introspection (SelfSubjectAccessReview): evaluate
                # the chain's own authorizer for the requesting user. The
                # AUTHN gate still applies — a caller who would be 401'd
                # everywhere must be 401'd here too, not told "allowed"
                attrs = body.get("spec", {}).get("resourceAttributes", {})
                user, ok = self._authenticate()
                if not ok:
                    return
                allowed = (
                    self.server.authorizer is None
                    or user is None  # insecure port: everything allowed
                    or self.server.authorizer.authorize(
                        user,
                        attrs.get("verb", "get"),
                        attrs.get("resource", ""),
                        attrs.get("namespace") or "*",
                        attrs.get("name", ""),
                    )
                )
                return self._json(
                    201,
                    {
                        "kind": "SelfSubjectAccessReview",
                        "status": {"allowed": allowed},
                    },
                )
            self._cr_write_gate(resource, body)
            obj = codec.decode(resource, body)
            if ns is not None:
                obj.metadata.namespace = ns
            created = self.store.create(resource, obj)
            return self._json(201, codec.encode(created))
        except AlreadyExists as e:
            return self._status_error(409, "AlreadyExists", str(e))
        except LeaderFenced as e:
            # leadership fence rejection: the caller's lease grant was
            # superseded BEFORE anything applied. 409 with a distinct
            # reason so the client maps it back to LeaderFenced (a plain
            # Conflict is retryable per-pod; this one means "you are not
            # the leader anymore" for the whole batch)
            return self._status_error(409, "LeaderFenced", str(e))
        except DegradedWrites as e:
            return self._degraded_error(e)
        except NotPrimary as e:
            # fenced store: permanent for this process (a successor
            # exists) — 503 without Retry-After; clients must re-discover
            # the primary, not hammer this one
            return self._status_error(503, "ServiceUnavailable", str(e))
        except AdmissionDenied as e:
            # quota denial is 403 Forbidden like the reference's admission
            return self._status_error(403, "Forbidden", str(e))
        except NotFound as e:
            # e.g. evicting/binding a pod that vanished — NotFound is a
            # KeyError subclass, so this must precede the 400 handler
            return self._status_error(404, "NotFound", str(e))
        except ValidationError as e:
            return self._status_error(400, "Invalid", str(e))
        except (KeyError, json.JSONDecodeError) as e:
            return self._status_error(400, "BadRequest", str(e))

    def _handle_PUT(self):
        if self._maybe_proxy():
            return
        resource, ns, name, _q = self._parse()
        if resource is None or not name:
            return self._status_error(404, "NotFound", "unknown path")
        if not self._resource_served(resource):
            return self._status_error(404, "NotFound", f"no such resource {resource}")
        if not self._authorize("update", resource, ns, name or ""):
            return
        try:
            body = self._read_body()
            self._cr_write_gate(resource, body)
            obj = codec.decode(resource, body)
            if ns is not None:
                obj.metadata.namespace = ns
            updated = self.store.update(resource, obj)
            return self._respond_obj(200, updated)
        except NotFound as e:
            return self._status_error(404, "NotFound", str(e))
        except Conflict as e:
            return self._status_error(409, "Conflict", str(e))
        except DegradedWrites as e:
            return self._degraded_error(e)
        except NotPrimary as e:
            return self._status_error(503, "ServiceUnavailable", str(e))
        except AdmissionDenied as e:
            return self._status_error(403, "Forbidden", str(e))
        except ValidationError as e:
            return self._status_error(400, "Invalid", str(e))
        except (KeyError, json.JSONDecodeError) as e:
            return self._status_error(400, "BadRequest", str(e))

    def _handle_DELETE(self):
        if self._maybe_proxy():
            return
        resource, ns, name, _q = self._parse()
        if resource is None or not name:
            return self._status_error(404, "NotFound", "unknown path")
        if not self._resource_served(resource):
            return self._status_error(404, "NotFound", f"no such resource {resource}")
        if not self._authorize("delete", resource, ns, name or ""):
            return
        try:
            self.store.delete(resource, ns or "", name)
            return self._json(200, {"kind": "Status", "status": "Success"})
        except NotFound as e:
            return self._status_error(404, "NotFound", str(e))
        except DegradedWrites as e:
            return self._degraded_error(e)
        except NotPrimary as e:
            return self._status_error(503, "ServiceUnavailable", str(e))
        except AdmissionDenied as e:
            return self._status_error(403, "Forbidden", str(e))


def _list_options_predicate(query: dict):
    """?labelSelector= / ?fieldSelector= -> combined object predicate, or
    None when neither is present (apimachinery ListOptions). ValueError
    (→400) on selector syntax errors.

    Watch caveat vs the reference's cacher: an object MODIFIED out of the
    selector is dropped, not synthesized into a DELETED event; informer
    relists reconcile the difference."""
    lsel_s = query.get("labelSelector")
    fsel_s = query.get("fieldSelector")
    if not lsel_s and not fsel_s:
        return None
    from ..api.selectors import FieldSelector, parse_label_selector

    lsel = parse_label_selector(lsel_s) if lsel_s else None
    fsel = FieldSelector.parse(fsel_s) if fsel_s else None

    def pred(obj) -> bool:
        if lsel is not None and not lsel.matches(obj.metadata.labels or {}):
            return False
        if fsel is not None and not fsel.matches(obj):
            return False
        return True

    return pred


def _backend_ssl_context(spec):
    """SSL context for an https APIService backend: verify against the
    spec's base64 caBundle when set (kube-aggregator apiservice cert
    handling); insecureSkipTLSVerify disables verification entirely;
    neither set falls back to system roots."""
    import base64
    import ssl

    if spec.insecure_skip_tls_verify:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    if spec.ca_bundle:
        pem = base64.b64decode(spec.ca_bundle).decode()
        return ssl.create_default_context(cadata=pem)
    return ssl.create_default_context()


class APIServerHTTP(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(
        self,
        addr,
        store: APIServer,
        authenticator=None,
        authorizer=None,
        max_in_flight: int = 400,
        priority_and_fairness: bool = True,
        audit=None,  # apiserver.audit.AuditLogger, or None
        watch_cache: bool = True,
        bookmark_period_s: float = 2.0,
        watch_cache_window: int = 0,
        freshness_timeout_s: float = 5.0,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
    ):
        super().__init__(addr, _Handler)
        # TLS on the serving hop: wrap the LISTENING socket with the
        # handshake DEFERRED — accept() hands back an un-handshaken
        # SSLSocket and the handshake happens on the handler thread's
        # first read, so a slow (or hostile) handshaker can never stall
        # the accept loop (the same never-block-the-dispatcher contract
        # the relay workers live under)
        self.tls = bool(tls_cert and tls_key)
        if self.tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self.socket = ctx.wrap_socket(
                self.socket, server_side=True, do_handshake_on_connect=False
            )
        self.store = store
        self.authenticator = authenticator  # None = insecure port semantics
        self.authorizer = authorizer
        self.audit = audit
        self.bookmark_period_s = bookmark_period_s
        # the watch cache (apiserver/cacher.py): every watch stream and
        # paginated/rv=0 list serves from it — ONE store watch per kind
        # regardless of client count
        self.cacher = None
        if watch_cache:
            from .cacher import DEFAULT_WINDOW, Cacher

            self.cacher = Cacher(
                store,
                window=watch_cache_window or DEFAULT_WINDOW,
                bookmark_period_s=bookmark_period_s,
                freshness_timeout_s=freshness_timeout_s,
            )
        self._watch_streams_lock = threading.Lock()
        self._watch_streams: dict = {}
        # WithPriorityAndFairness over the same total budget; falls back to
        # WithMaxInFlightLimit (config.go:662-666) when disabled. 0/None
        # max_in_flight disables both
        self.flow = None
        # APF needs identities to classify; on the insecure port every
        # request would be anonymous and the whole server would collapse
        # into global-default's share — fall back to the plain limiter
        if max_in_flight and priority_and_fairness and authenticator is not None:
            from .flowcontrol import FlowController

            self.flow = FlowController(total_concurrency=max_in_flight)
        self.inflight = (
            threading.BoundedSemaphore(max_in_flight) if max_in_flight else None
        )
        self.stopping = threading.Event()

    def watch_streams_adjust(self, resource: str, delta: int) -> None:
        """Track live watch-stream threads per resource: the gauge is how
        the half-open-connection reaper is observable (a dead client's
        thread exits on its next bookmark write and the gauge drops)."""
        from ..utils.metrics import metrics

        with self._watch_streams_lock:
            n = self._watch_streams.get(resource, 0) + delta
            self._watch_streams[resource] = max(0, n)
            metrics.set_gauge(
                "apiserver_watch_streams", self._watch_streams[resource],
                {"resource": resource},
            )

    def watch_stream_count(self, resource: str) -> int:
        with self._watch_streams_lock:
            return self._watch_streams.get(resource, 0)

    def shutdown(self):
        self.stopping.set()
        if self.cacher is not None:
            self.cacher.stop()
        super().shutdown()


def serve(
    store: Optional[APIServer] = None,
    port: int = 0,
    authenticator=None,
    authorizer=None,
    max_in_flight: int = 400,
    priority_and_fairness: bool = True,
    audit=None,
    watch_cache: bool = True,
    bookmark_period_s: float = 2.0,
    watch_cache_window: int = 0,
    freshness_timeout_s: float = 5.0,
    tls_cert: Optional[str] = None,
    tls_key: Optional[str] = None,
) -> Tuple[APIServerHTTP, int, APIServer]:
    """Start the façade on a background thread; returns (server, port, store).
    max_in_flight=0 disables the in-flight limiter. watch_cache=False
    falls back to per-client store watches (the pre-cacher read path).
    tls_cert+tls_key turn the port into an https listener."""
    store = store or APIServer()
    srv = APIServerHTTP(
        ("0.0.0.0", port),
        store,
        authenticator,
        authorizer,
        max_in_flight=max_in_flight,
        priority_and_fairness=priority_and_fairness,
        audit=audit,
        watch_cache=watch_cache,
        bookmark_period_s=bookmark_period_s,
        watch_cache_window=watch_cache_window,
        freshness_timeout_s=freshness_timeout_s,
        tls_cert=tls_cert,
        tls_key=tls_key,
    )
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1], store
