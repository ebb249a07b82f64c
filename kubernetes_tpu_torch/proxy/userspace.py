"""Userspace proxy mode: real TCP listeners + byte splicing.

Reference: pkg/proxy/userspace/proxier.go — the oldest kube-proxy mode
opens a REAL listening socket per service port, accepts connections in
userspace, dials a backend chosen by the load balancer, and copies bytes
both ways. This build does exactly that: one 127.0.0.1 listener per
(service, port), backend selection through the Proxier's resolve table
(round-robin / session affinity), bidirectional splice threads.

Divergence: the reference binds a random proxy port and installs
iptables redirects from the clusterIP; with no iptables here, clients
dial the proxy port directly (``proxy_port()``). Backends must be
reachable addresses (e.g. 127.0.0.1 endpoints) — pods on the simulated
network can't be spliced to, same as any unreachable endpoint."""

from __future__ import annotations

import logging
import socket
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger("kubernetes_tpu.proxy.userspace")

_BUF = 65536


def _splice(a: socket.socket, b: socket.socket) -> None:
    """Copy a→b until EOF/error, then signal write-shutdown downstream."""
    try:
        while True:
            data = a.recv(_BUF)
            if not data:
                break
            b.sendall(data)
    except OSError:
        pass
    finally:
        try:
            b.shutdown(socket.SHUT_WR)
        except OSError:
            pass


class SpliceListener:
    """One real listening socket for one (service vip, port)."""

    def __init__(self, proxier, vip: str, port: int):
        self.proxier = proxier
        self.vip = vip
        self.port = port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(64)
        self.proxy_port = self._sock.getsockname()[1]
        self._closed = False
        self._t = threading.Thread(
            target=self._accept_loop,
            daemon=True,
            name=f"userspace-{vip}:{port}",
        )
        self._t.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, peer = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn, peer), daemon=True
            ).start()

    def _handle(self, conn: socket.socket, peer) -> None:
        backend = self.proxier.resolve(
            self.vip, self.port, client_key=str(peer[0])
        )
        if backend is None:
            conn.close()  # no endpoints: connection refused semantics
            return
        host, bport = backend
        up = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            up.settimeout(10.0)
            up.connect((host, int(bport)))
            up.settimeout(None)
        except OSError:
            conn.close()
            up.close()
            self.proxier.release(backend)
            return
        t = threading.Thread(target=_splice, args=(up, conn), daemon=True)
        t.start()
        _splice(conn, up)
        t.join()
        conn.close()
        up.close()
        self.proxier.release(backend)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class UserspaceManager:
    """Reconciles listeners against the proxier's synced table: one
    listener per (service-key vip, numeric port); services/ports that
    vanish get their listener closed."""

    def __init__(self, proxier):
        self.proxier = proxier
        self._lock = threading.Lock()
        self._listeners: Dict[Tuple[str, int], SpliceListener] = {}

    def reconcile(self, table_keys) -> None:
        want = {
            (vip, port)
            for vip, port in table_keys
            if "/" in vip and isinstance(port, int)
        }
        with self._lock:
            for key in list(self._listeners):
                if key not in want:
                    self._listeners.pop(key).close()
            for vip, port in want:
                if (vip, port) not in self._listeners:
                    try:
                        self._listeners[(vip, port)] = SpliceListener(
                            self.proxier, vip, port
                        )
                    except OSError as e:
                        logger.warning(
                            "userspace listen %s:%s: %s", vip, port, e
                        )

    def proxy_port(self, svc_key: str, port: int) -> Optional[int]:
        with self._lock:
            ln = self._listeners.get((svc_key, port))
            return ln.proxy_port if ln else None

    def close(self) -> None:
        with self._lock:
            for ln in self._listeners.values():
                ln.close()
            self._listeners.clear()
