"""Host-callback delivery of the wave kernel's fast index payload.

The depth-infinity variant of the split-phase readback
(`host_callback_binds` in KubeSchedulerConfiguration): instead of the
host issuing a device->host fetch for the chosen/placed/deferred index
vectors, the kernel itself posts them through a
``jax.experimental.io_callback`` the moment it resolves on device. The
scheduler allocates a ticket per launch, threads it through the kernel
as a traced scalar, and the callback lands the payload here; the resolve
path consumes it without ever blocking on a device sync — the device can
keep chaining wave N+1 while the host observes wave N.

The registry is a plain ticket-keyed dict + per-ticket Event. Callbacks
arrive on XLA's callback threads; consumers are the scheduling loop. A
ticket whose batch dies before resolution (launch failure, sibling
quarantine) is ``discard``ed so the registry can't grow unboundedly —
a late callback for a discarded ticket is dropped on the floor.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["new_ticket", "deliver", "ready", "take", "discard", "backlog"]

_lock = threading.Lock()
_payloads: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
_events: Dict[int, threading.Event] = {}
_tickets = itertools.count(1)


def new_ticket() -> int:
    """Allocate a delivery slot; the caller must eventually take() or
    discard() it."""
    t = next(_tickets)
    with _lock:
        _events[t] = threading.Event()
    return t


def deliver(ticket, chosen, placed, deferred) -> None:
    """io_callback target: land one wave's fast index payload. Runs on
    an XLA callback thread — copies to host numpy and signals the
    consumer. A discarded ticket's late delivery is dropped."""
    t = int(np.asarray(ticket))
    payload = (
        np.asarray(chosen),
        np.asarray(placed),
        np.asarray(deferred),
    )
    with _lock:
        ev = _events.get(t)
        if ev is None:
            return
        _payloads[t] = payload
    ev.set()


def ready(ticket: int) -> bool:
    with _lock:
        return ticket in _payloads


def take(
    ticket: int, timeout: float = 0.0
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Consume a ticket's payload, waiting up to `timeout` seconds for
    the callback to fire. Returns None on timeout or unknown ticket (the
    caller falls back to a plain device fetch); either way the ticket is
    retired."""
    with _lock:
        ev = _events.get(ticket)
    if ev is None:
        return None
    if timeout > 0:
        ev.wait(timeout)
    with _lock:
        _events.pop(ticket, None)
        return _payloads.pop(ticket, None)


def discard(ticket: int) -> None:
    """Retire a ticket whose batch will never be resolved."""
    with _lock:
        _events.pop(ticket, None)
        _payloads.pop(ticket, None)


def backlog() -> int:
    """Outstanding (allocated, unconsumed) tickets — test/debug helper."""
    with _lock:
        return len(_events)
