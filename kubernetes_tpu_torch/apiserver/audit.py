"""API request audit logging.

Reference: staging/src/k8s.io/apiserver/pkg/audit + the WithAudit filter
(server/config.go:668) — every API request emits a structured event with
the authenticated user, verb, resource, and response code. This build
writes one JSON line per completed request (the ResponseComplete stage;
the reference's RequestReceived stage adds little in-process) through an
async writer so auditing never blocks request handling, with an in-memory
ring for tests/debug endpoints.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Optional


class AuditLogger:
    def __init__(
        self,
        path: Optional[str] = None,
        ring_size: int = 1000,
        max_queue: int = 10000,
    ):
        self.path = path
        self.ring = collections.deque(maxlen=ring_size)
        # bounded like the ring: if the writer can't keep up (or died and
        # is backing off), oldest events drop instead of leaking memory
        self._q: "collections.deque[dict]" = collections.deque(maxlen=max_queue)
        self._cond = threading.Condition()
        self._stopped = False
        self._writer: Optional[threading.Thread] = None
        self._write_failures = 0
        self._disabled_until = 0.0  # writer crashed: back off, then retry

    def log(
        self,
        user: Optional[str],
        groups,
        verb: str,
        resource: str,
        namespace: str,
        name: str,
        code: int,
    ) -> None:
        ev = {
            "stage": "ResponseComplete",
            "timestamp": time.time(),
            "user": user or "system:anonymous",
            "groups": list(groups or ()),
            "verb": verb,
            "resource": resource,
            "namespace": namespace,
            "name": name,
            "code": code,
        }
        with self._cond:
            self.ring.append(ev)
            if self.path is not None and not self._stopped:
                self._q.append(ev)
                if self._writer is None and time.time() >= self._disabled_until:
                    self._writer = threading.Thread(
                        target=self._write_loop, daemon=True, name="audit-writer"
                    )
                    self._writer.start()
                self._cond.notify()

    def _write_loop(self) -> None:
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                while True:
                    with self._cond:
                        while not self._q and not self._stopped:
                            self._cond.wait(timeout=1.0)
                        if not self._q:
                            return
                        batch = list(self._q)
                        self._q.clear()
                    for ev in batch:
                        f.write(json.dumps(ev) + "\n")
                    f.flush()
        except OSError:
            # unwritable path / disk error: clear the thread handle so a
            # later log() can restart the writer (after a backoff — a
            # permanently broken path must not spawn a thread per event),
            # rather than silently dropping audit forever
            with self._cond:
                self._write_failures += 1
                self._disabled_until = time.time() + min(
                    30.0 * self._write_failures, 300.0
                )
        finally:
            with self._cond:
                self._writer = None

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
