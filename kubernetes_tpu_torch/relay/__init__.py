"""Million-client watch relay: shared-memory fan-out tier.

The serving tier's PR-14 ceiling was the frontend process itself: one
GIL, one ``wfile.write`` per client per frame, plaintext. This package
moves fan-out OUT of the frontend: a publisher writes each kind's
memoized binary watch frames exactly once into a shared-memory frame
ring (``ring``), and N SO_REUSEPORT worker processes (``worker``) fan
the same bytes out to their accepted clients with batched non-blocking
``sendmsg`` — cost scales with frames produced, not clients connected,
and TLS terminates at the worker so the hop is honest about crypto.

Orchestration (``publisher.start_relay``) reserves the shared port,
spawns the workers, and hands back a :class:`~.publisher.RelayHandle`
for chaos surgery (kill/respawn) and stats aggregation.
"""

from .publisher import (  # noqa: F401
    RelayHandle,
    RelayPublisher,
    relay_health_lines,
    start_relay,
)
from .ring import FrameRing, RingReader  # noqa: F401
