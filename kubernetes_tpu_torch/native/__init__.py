"""Native runtime components (C++), loaded via ctypes.

The compute path is JAX/XLA; the IO runtime around it is native where the
reference's is process-native: the group-commit WAL sink replaces
per-record fsyncs with etcd-style batched commits (walsink.cpp). Builds
lazily with g++ into a content-hash-keyed cache; every consumer has a pure
Python fallback, so environments without a toolchain lose performance,
never correctness.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

logger = logging.getLogger("kubernetes_tpu.native")

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_LOCK = threading.Lock()
_CACHE: dict = {}


def _build(src_name: str) -> Optional[str]:
    """Compile one .cpp into a cached .so; returns the path or None."""
    src = os.path.join(_SRC_DIR, src_name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(
        tempfile.gettempdir(), f"kubernetes_tpu_native_{os.getuid()}"
    )
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{src_name.rsplit('.', 1)[0]}-{digest}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: racing builders both succeed
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning(
            "native build of %s failed (%s); using Python fallback",
            src_name,
            detail.decode(errors="replace")[-500:] or e,
        )
        return None


def load_walsink() -> Optional[ctypes.CDLL]:
    """The group-commit WAL sink library, or None (Python fallback)."""
    with _BUILD_LOCK:
        if "walsink" in _CACHE:
            return _CACHE["walsink"]
        lib = None
        so = _build("walsink.cpp")
        if so is not None:
            try:
                lib = ctypes.CDLL(so)
                lib.wal_open.restype = ctypes.c_void_p
                lib.wal_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
                lib.wal_enqueue.restype = ctypes.c_uint64
                lib.wal_enqueue.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_char_p,
                    ctypes.c_uint64,
                ]
                lib.wal_wait.restype = ctypes.c_int
                lib.wal_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
                lib.wal_flush.restype = ctypes.c_int
                lib.wal_flush.argtypes = [ctypes.c_void_p]
                lib.wal_fsync_count.restype = ctypes.c_uint64
                lib.wal_fsync_count.argtypes = [ctypes.c_void_p]
                lib.wal_close.argtypes = [ctypes.c_void_p]
            except OSError as e:
                logger.warning("walsink load failed: %s", e)
                lib = None
        _CACHE["walsink"] = lib
        return lib
