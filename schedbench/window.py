"""The measured window, made of whole wave batches.

The Scheduler binds a wave batch in one ``APIServer.bind_pods`` call.
``stream.BindClock`` times the end of every bind call on the run's one
server, and each call is a ``Run``: the moment it returned and the pods
it bound. That moment ends one batch and starts the next.

The window opens at the first call that returns after the warm set-up
and closes at the first call that returns at least ``seconds`` later.
Every pod bound by the calls after the opening one, up to and with the
closing one, counts; the time is the distance between the two. So the
window holds whole batches, whatever their length, and no part of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

# event codes of the stream (stream.py)
ADD, BIND, DEL, OTHER = 0, 1, 2, 3


@dataclass(frozen=True)
class Run:
    t: float  # time.monotonic() when the bind call returned
    size: int  # pods it bound
    # the store's resourceVersion as the call began and as it returned:
    # the call's binds are the stream's binds between the two
    rv0: int = 0
    rv1: int = 0


@dataclass(frozen=True)
class Window:
    t_open: float
    t_close: float
    pods: int
    batches: int  # bind runs after the opening edge, the closing one with them

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    @property
    def pods_per_s(self) -> float:
        return self.pods / self.seconds


def whole_batch_window(
    runs: Sequence[Run], t_ready: float, seconds: float
) -> Optional[Window]:
    """The window over `runs`: opened by the first run whose edge comes
    after `t_ready`, closed by the first run whose edge is at least
    `seconds` after that. None while the closing run has not come."""
    opening = None
    pods = 0
    batches = 0
    for r in runs:
        if opening is None:
            if r.t > t_ready:
                opening = r
            continue
        pods += r.size
        batches += 1
        if r.t - opening.t >= seconds:
            return Window(opening.t, r.t, pods, batches)
    return None
