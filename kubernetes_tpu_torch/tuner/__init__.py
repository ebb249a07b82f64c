"""Policy gym: self-tuning score weights behind a shadow A/B gate.

Eagerly exports only the jax-free persistence surface (policy.py) —
``api/serialization.ensure_late_registration`` imports this package from
decode-only processes that must not pay a jax import. The gym itself
(controller/waves/scoring/candidates) loads lazily via PEP 562.
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

_LAZY = {
    "PolicyTuner": ("controller", "PolicyTuner"),
    "WaveRingBuffer": ("waves", "WaveRingBuffer"),
    "WaveRecord": ("waves", "WaveRecord"),
    "replay_wave": ("scoring", "replay_wave"),
    "build_overlay": ("scoring", "build_overlay"),
    "score_assignment": ("scoring", "score_assignment"),
}

__all__ = [
    "ACTIVE_POLICY_NAME",
    "ScorePolicy",
    "adopt_persisted_policy",
    "persist_active_policy",
    "read_persisted_policy",
    "set_active_policy_gauge",
    "tuner_health_lines",
    *_LAZY,
]


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)
