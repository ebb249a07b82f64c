"""Kubelet device-plugin manager with topology hints.

Reference: pkg/kubelet/cm/devicemanager/manager.go:1 (plugin registration,
ListAndWatch device streams, Allocate, checkpointing) and topology_hints.go
(per-resource NUMA-affinity hints merged by the topology manager). The
architecture is preserved — device plugins are SEPARATE PROCESSES speaking
an RPC protocol over unix sockets — with the same framed transport the CRI
boundary uses (kubelet/cri/wire.py) and JSON payloads instead of gRPC:

  plugin -> kubelet (registry socket):
      Register     {"resource": "tpu.dev/chip", "endpoint": "/path.sock",
                    "devices": [{"id": "d0", "healthy": true, "topology": 0}]}
      Update       {"resource": ..., "devices": [...]}   (ListAndWatch push)
  kubelet -> plugin (the plugin's own endpoint socket, dialed back):
      Allocate     {"device_ids": ["d0", "d1"]}  -> {"envs": {...}, ...}

For a TPU-native stack the "topology" id is the chip's locality domain
(NUMA node / host / ICI pod-slice): aligned allocations keep a pod's chips
on one interconnect domain, which is the scheduling decision that matters
for collective bandwidth.

Allocations checkpoint to a JSON file (device_plugin_state) and restore on
kubelet restart, like the reference's checkpoint manager.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger("kubernetes_tpu.kubelet.devicemanager")

_U32 = struct.Struct(">I")


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, method: str, payload: dict) -> None:
    m = method.encode()
    p = json.dumps(payload).encode()
    sock.sendall(_U32.pack(len(m)) + m + _U32.pack(len(p)) + p)


def _recv_frame(sock: socket.socket) -> Tuple[str, dict]:
    (mlen,) = _U32.unpack(_read_exact(sock, 4))
    method = _read_exact(sock, mlen).decode()
    (plen,) = _U32.unpack(_read_exact(sock, 4))
    return method, json.loads(_read_exact(sock, plen) or b"{}")


def _reply(sock: socket.socket, status: int, payload: dict) -> None:
    p = json.dumps(payload).encode()
    sock.sendall(bytes([status]) + _U32.pack(len(p)) + p)


def _read_reply(sock: socket.socket) -> dict:
    status = _read_exact(sock, 1)[0]
    (plen,) = _U32.unpack(_read_exact(sock, 4))
    payload = json.loads(_read_exact(sock, plen) or b"{}")
    if status != 0:
        raise RuntimeError(payload.get("error", "device plugin error"))
    return payload


@dataclass
class Device:
    id: str
    healthy: bool = True
    topology: int = 0  # locality domain (NUMA node / ICI slice)


@dataclass
class _Endpoint:
    """One registered plugin resource."""

    resource: str
    endpoint: str  # plugin's own socket path (dialed back for Allocate)
    devices: Dict[str, Device] = field(default_factory=dict)


class TopologyHint:
    """A set of locality domains that can satisfy a request; preferred
    when it spans exactly one domain (topologymanager's bitmask hints)."""

    __slots__ = ("domains", "preferred")

    def __init__(self, domains: Set[int], preferred: bool):
        self.domains = frozenset(domains)
        self.preferred = preferred

    def __repr__(self):  # pragma: no cover
        return f"Hint({sorted(self.domains)}, preferred={self.preferred})"


class DeviceManager:
    """Kubelet-side manager: registry server + allocation bookkeeping.

    policy: 'best-effort' prefers single-domain allocations but proceeds
    unaligned; 'restricted' fails admission when alignment is impossible
    (topologymanager policies of the same names)."""

    def __init__(
        self,
        socket_path: str,
        checkpoint_path: Optional[str] = None,
        policy: str = "best-effort",
    ):
        if policy not in ("best-effort", "restricted"):
            raise ValueError(f"unknown topology policy {policy!r}")
        self.socket_path = socket_path
        self.checkpoint_path = checkpoint_path
        self.policy = policy
        self._lock = threading.Lock()
        self._endpoints: Dict[str, _Endpoint] = {}  # resource -> endpoint
        # pod key -> resource -> [device ids]
        self._allocations: Dict[str, Dict[str, List[str]]] = {}
        self._srv: Optional[socketserver.ThreadingUnixStreamServer] = None
        self._generation = 0  # bumped on capacity-visible changes
        self._load_checkpoint()

    # -- registry server (kubelet.sock) --------------------------------------

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        method, payload = _recv_frame(self.request)
                        try:
                            resp = outer._dispatch(method, payload)
                            _reply(self.request, 0, resp)
                        except Exception as e:
                            _reply(self.request, 1, {"error": str(e)})
                except (ConnectionError, OSError):
                    pass

        self._srv = socketserver.ThreadingUnixStreamServer(
            self.socket_path, Handler
        )
        self._srv.daemon_threads = True
        threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="deviceplugin-registry"
        ).start()

    def stop(self) -> None:
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def _dispatch(self, method: str, payload: dict) -> dict:
        if method in ("Register", "Update"):
            devices = {
                d["id"]: Device(
                    d["id"], d.get("healthy", True), int(d.get("topology", 0))
                )
                for d in payload.get("devices", [])
            }
            with self._lock:
                ep = self._endpoints.get(payload["resource"])
                if ep is None or method == "Register":
                    ep = _Endpoint(
                        payload["resource"], payload.get("endpoint", "")
                    )
                    self._endpoints[payload["resource"]] = ep
                ep.devices = devices
                self._generation += 1
            logger.info(
                "device plugin %s: %s with %d devices",
                payload["resource"],
                method.lower(),
                len(devices),
            )
            return {}
        raise ValueError(f"unimplemented device-plugin method {method!r}")

    # -- capacity surface ----------------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def capacities(self) -> Dict[str, int]:
        """resource -> healthy device count (merged into Node allocatable by
        the kubelet's status sync; NodeResourcesFit — host and kernel —
        then schedules against them as extended resources)."""
        with self._lock:
            return {
                res: sum(1 for d in ep.devices.values() if d.healthy)
                for res, ep in self._endpoints.items()
            }

    def _in_use(self, resource: str) -> Set[str]:
        used: Set[str] = set()
        for per_pod in self._allocations.values():
            used.update(per_pod.get(resource, ()))
        return used

    # -- topology hints (topology_hints.go) ----------------------------------

    def topology_hints(self, resource: str, count: int) -> List[TopologyHint]:
        """Possible locality-domain sets that can satisfy `count` devices
        of `resource`; single-domain sets are preferred."""
        with self._lock:
            return self._topology_hints_locked(resource, count)

    def _topology_hints_locked(
        self, resource: str, count: int
    ) -> List[TopologyHint]:
        ep = self._endpoints.get(resource)
        if ep is None:
            return []
        used = self._in_use(resource)
        by_domain: Dict[int, int] = {}
        for d in ep.devices.values():
            if d.healthy and d.id not in used:
                by_domain[d.topology] = by_domain.get(d.topology, 0) + 1
        hints = [
            TopologyHint({dom}, True)
            for dom, avail in by_domain.items()
            if avail >= count
        ]
        if sum(by_domain.values()) >= count:
            # the cross-domain (unaligned) fallback hint
            hints.append(TopologyHint(set(by_domain), len(by_domain) <= 1))
        return hints

    def _merge_hints(
        self, per_resource: Dict[str, List[TopologyHint]]
    ) -> Optional[TopologyHint]:
        """Best single merged hint: every resource must be satisfiable
        within the merged domain set; prefer (preferred, fewest domains).
        None = some resource cannot be satisfied at all."""
        merged: Optional[TopologyHint] = None
        import itertools

        for combo in itertools.product(*per_resource.values()):
            domains = frozenset().union(*(h.domains for h in combo))
            preferred = all(h.preferred for h in combo) and len(domains) <= 1
            cand = TopologyHint(set(domains), preferred)
            if merged is None or (cand.preferred, -len(cand.domains)) > (
                merged.preferred,
                -len(merged.domains),
            ):
                merged = cand
        return merged

    # -- allocation (Allocate + checkpoint) ----------------------------------

    def allocate_pod(self, pod) -> Dict[str, List[str]]:
        """Admission-time allocation for every plugin resource the pod's
        containers request. Returns {resource: [device ids]}; raises when
        the request cannot be satisfied (or, under the 'restricted'
        policy, cannot be topology-aligned). Idempotent per pod key."""
        key = pod.metadata.key
        wants: Dict[str, int] = {}
        for c in pod.spec.containers:
            for name, qty in c.requests.items():
                if name in self._endpoints:
                    wants[name] = wants.get(name, 0) + int(str(qty))
        if not wants:
            return {}
        # hints + merge + grant under ONE lock hold: computing the hints
        # lock-free and re-locking for the grant lets a concurrent
        # allocation consume the aligned pool in between, silently
        # spilling cross-domain even under policy='restricted' (the
        # alignment guarantee the merged.preferred check enforces)
        granted: Dict[str, List[str]] = {}
        with self._lock:
            if key in self._allocations:
                return dict(self._allocations[key])
            hints = {
                res: self._topology_hints_locked(res, cnt)
                for res, cnt in wants.items()
            }
            for res, hs in hints.items():
                if not hs:
                    raise RuntimeError(
                        f"insufficient {res}: want {wants[res]}, none available"
                    )
            merged = self._merge_hints(hints)
            if merged is None:
                raise RuntimeError(f"cannot satisfy device request {wants}")
            if self.policy == "restricted" and not merged.preferred:
                raise RuntimeError(
                    f"topology policy=restricted: no aligned allocation for "
                    f"{wants}"
                )
            for res, cnt in wants.items():
                ep = self._endpoints[res]
                used = self._in_use(res)
                pool = [
                    d
                    for d in ep.devices.values()
                    if d.healthy and d.id not in used
                ]
                # aligned devices first, then spill (best-effort)
                pool.sort(key=lambda d: (d.topology not in merged.domains, d.id))
                if len(pool) < cnt:
                    raise RuntimeError(
                        f"insufficient {res}: want {cnt}, have {len(pool)}"
                    )
                grant = pool[:cnt]
                if self.policy == "restricted" and any(
                    d.topology not in merged.domains for d in grant
                ):
                    # belt-and-braces: the hint said aligned capacity
                    # exists; a grant outside merged.domains would violate
                    # the restricted contract — fail admission instead
                    raise RuntimeError(
                        f"topology policy=restricted: aligned pool for {res} "
                        "exhausted during allocation"
                    )
                granted[res] = [d.id for d in grant]
            self._allocations[key] = granted
            self._save_checkpoint_locked()
        # dial each plugin's endpoint for the actual Allocate call (the
        # reference's back-connection to the plugin's gRPC server)
        for res, ids in granted.items():
            ep = self._endpoints[res]
            if ep.endpoint:
                try:
                    self._call_plugin(ep.endpoint, "Allocate", {"device_ids": ids})
                except Exception:
                    with self._lock:
                        self._allocations.pop(key, None)
                        self._save_checkpoint_locked()
                    raise
        return granted

    def free_pod(self, pod_key: str) -> None:
        with self._lock:
            if self._allocations.pop(pod_key, None) is not None:
                self._save_checkpoint_locked()

    def allocations(self, pod_key: str) -> Dict[str, List[str]]:
        with self._lock:
            return dict(self._allocations.get(pod_key, {}))

    @staticmethod
    def _call_plugin(endpoint: str, method: str, payload: dict) -> dict:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10.0)
        try:
            s.connect(endpoint)
            _send_frame(s, method, payload)
            return _read_reply(s)
        finally:
            s.close()

    # -- checkpoint (checkpoint/checkpoint.go) --------------------------------

    def _save_checkpoint_locked(self) -> None:
        if self.checkpoint_path is None:
            return
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"allocations": self._allocations}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.checkpoint_path)

    def _load_checkpoint(self) -> None:
        if self.checkpoint_path is None or not os.path.exists(
            self.checkpoint_path
        ):
            return
        try:
            with open(self.checkpoint_path, encoding="utf-8") as f:
                self._allocations = json.load(f).get("allocations", {})
        except (json.JSONDecodeError, OSError):
            logger.exception("device checkpoint unreadable; starting empty")
            self._allocations = {}


class DevicePluginStub:
    """Plugin-side helper: registers with the kubelet and serves Allocate
    on its own endpoint socket (the e2e device plugin's shape,
    test/e2e_node/testdeviceplugin). Real plugins (a TPU chip plugin) use
    the same wire contract from their own process."""

    def __init__(
        self,
        kubelet_socket: str,
        resource: str,
        devices: List[Device],
        endpoint: Optional[str] = None,
    ):
        self.kubelet_socket = kubelet_socket
        self.resource = resource
        self.devices = list(devices)
        self.endpoint = endpoint or f"{kubelet_socket}.{resource.replace('/', '_')}"
        self.allocated: List[List[str]] = []  # observed Allocate calls
        self._reg: Optional[socket.socket] = None
        self._srv: Optional[socketserver.ThreadingUnixStreamServer] = None

    def start(self) -> None:
        outer = self
        if os.path.exists(self.endpoint):
            os.unlink(self.endpoint)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        method, payload = _recv_frame(self.request)
                        if method == "Allocate":
                            outer.allocated.append(payload["device_ids"])
                            _reply(self.request, 0, {"envs": {}})
                        else:
                            _reply(
                                self.request, 1, {"error": f"bad method {method}"}
                            )
                except (ConnectionError, OSError):
                    pass

        self._srv = socketserver.ThreadingUnixStreamServer(self.endpoint, Handler)
        self._srv.daemon_threads = True
        threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="deviceplugin-stub"
        ).start()
        self._reg = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._reg.settimeout(10.0)
        self._reg.connect(self.kubelet_socket)
        self._send_devices("Register")

    def _send_devices(self, method: str) -> None:
        _send_frame(
            self._reg,
            method,
            {
                "resource": self.resource,
                "endpoint": self.endpoint,
                "devices": [
                    {"id": d.id, "healthy": d.healthy, "topology": d.topology}
                    for d in self.devices
                ],
            },
        )
        _read_reply(self._reg)

    def update_devices(self, devices: List[Device]) -> None:
        """ListAndWatch push: health/topology changes stream to the manager."""
        self.devices = list(devices)
        self._send_devices("Update")

    def stop(self) -> None:
        if self._reg is not None:
            self._reg.close()
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        if os.path.exists(self.endpoint):
            os.unlink(self.endpoint)
