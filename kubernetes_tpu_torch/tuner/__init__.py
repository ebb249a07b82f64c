"""Policy gym (port): the jax-free persistence surface only.

``policy.py`` is copied from ``kubernetes_tpu/tuner/policy.py``: the
persisted ``ScorePolicy`` object the ``Scheduler`` adopts at promotion and
``api/serialization.ensure_late_registration`` registers.
``scoring.fragmentation_score`` is copied for
``Scheduler.fragmentation_score``. The gym itself (controller, waves, the
replay half of scoring, candidates) is ROADMAP queue 1 item 2.
"""

from .policy import (  # noqa: F401  (the import-light surface)
    ACTIVE_POLICY_NAME,
    ScorePolicy,
    adopt_persisted_policy,
    persist_active_policy,
    read_persisted_policy,
    set_active_policy_gauge,
    tuner_health_lines,
)
