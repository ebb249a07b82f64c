"""Test helpers: the lock-order watchdog (lockgraph, copied from
kubernetes_tpu.testing) that the encoder's named locks report to."""
