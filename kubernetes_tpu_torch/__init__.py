"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The scheduling data plane of ``kubernetes_tpu`` (a columnar cluster
snapshot kept on the accelerator, updated by batched pods×nodes
filter→score→commit wave kernels) rebuilt on PyTorch tensors for an
NVIDIA Hopper card. The JAX package beside it stays the reference; this
package imports nothing from it and never imports ``jax``.

Layout mirrors the reference wherever a reader should find the
counterpart:
  api/        — object model (copied: Pod/Node/quantities/selectors)
  utils/      — metrics registry (copied)
  testing/    — lock-order watchdog (copied: the encoder's named locks)
  ops/        — snapshot encoding, template batches, the wave kernel and
                the hand-written CUDA fit-mask kernel (csrc/)
  scheduler/  — the device-facing half of the scheduler's wave path
  perf/       — benchmark workload shapes (copied)

Every entry point takes an explicit ``device``; ``device=None`` means the
CUDA card (see device.resolve_device).
"""

__version__ = "0.1.0"
