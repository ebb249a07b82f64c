"""Self-signed TLS material for tests, chaos suites, and the bench.

The container has no ``cryptography`` wheel, but it does ship an
``openssl`` binary — certificates are minted by shelling out, exactly
once per process, into a tempdir that lives for the interpreter's
lifetime. Every caller that needs "TLS on the frontend hop" (relay
workers, REST servers, the serving bench) shares the same keypair so
the handshake cost is realistic and the SAN list covers loopback.

Import-light: stdlib only (subprocess + tempfile), safe for chaos
child processes.
"""

from __future__ import annotations

import atexit
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

_lock = threading.Lock()
_cached: Optional[Tuple[str, str]] = None
_tmpdir: Optional[str] = None

# loopback identities the cert must cover: relay workers and frontends
# all bind 127.0.0.1 in tests and the bench
_SAN = "subjectAltName=IP:127.0.0.1,DNS:localhost"


def openssl_available() -> bool:
    return shutil.which("openssl") is not None


def ensure_self_signed(common_name: str = "kubernetes-tpu-test") -> Tuple[str, str]:
    """(cert_path, key_path) for a process-cached self-signed localhost
    cert. Raises RuntimeError when no openssl binary exists — callers
    gate TLS paths on :func:`openssl_available` and fall back to
    plaintext (the wire contract is identical either way)."""
    global _cached, _tmpdir
    with _lock:
        if _cached is not None:
            return _cached
        exe = shutil.which("openssl")
        if exe is None:
            raise RuntimeError("no openssl binary: cannot mint TLS material")
        _tmpdir = tempfile.mkdtemp(prefix="ktpu-tls-")
        atexit.register(shutil.rmtree, _tmpdir, True)
        cert = os.path.join(_tmpdir, "cert.pem")
        key = os.path.join(_tmpdir, "key.pem")
        subprocess.run(
            [
                exe, "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                "-keyout", key, "-out", cert, "-days", "2",
                "-subj", f"/CN={common_name}",
                "-addext", _SAN,
            ],
            check=True,
            capture_output=True,
        )
        _cached = (cert, key)
        return _cached
