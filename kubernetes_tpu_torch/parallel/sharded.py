"""Device-loss classification and bounded retry (PyTorch port of
``kubernetes_tpu/parallel/sharded.py``:37-105).

Only the classifier and the retry helpers are ported: the Scheduler's
device-loss ride-through uses them on one card. The node-axis sharded
kernels of the reference module (``make_sharded_schedule_batch``,
``make_sharded_wave_kernel``, ``shard_snapshot``) are the multi-device
slice, ROADMAP queue 1 item 6.

The reference's markers are XLA runtime and tunnel messages; they stay
as they are. On a CUDA card a lost device shows as a CUDA runtime error,
which torch raises as ``torch.AcceleratorError`` (a ``RuntimeError``)
with the runtime's ``cudaGetErrorString`` text in its message. The
markers below add the strings of the runtime errors that mean the card
itself is gone or unusable: ``cudaErrorNoDevice`` (100),
``cudaErrorDevicesUnavailable`` (46), ``cudaErrorECCUncorrectable``
(214) and ``cudaErrorLaunchTimeout`` (702), each also by its enum name
(the form a wrapper that reports ``cudaGetErrorName`` uses). Program
faults — an illegal memory access, a device-side assert, an invalid
launch configuration, out of memory, and the K1/K2 wrappers' own launch
errors — are NOT device loss: retrying them and then latching the card
off would hide a kernel bug behind the host path.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


# -- device-loss classification + bounded retry ------------------------------


class DeviceLossError(RuntimeError):
    """Raised (or re-classified) when a kernel launch/readback failed
    because the device itself is gone or unreachable — as opposed to a
    program bug. The fault injector (testing/device_faults.py) raises this
    directly; a real CUDA runtime error is matched below."""


# substrings (lowercased) that mark a runtime error as device loss rather
# than a program error; deliberately conservative — a false negative
# costs a wave (requeued, zero pod loss), a false positive would retry
# and latch the device off on a genuine kernel bug and mask it
_DEVICE_LOSS_MARKERS = (
    # the reference's (XLA runtime, TPU tunnel)
    "device unavailable",
    "device is unavailable",
    "device lost",
    "device not found",
    "unable to reach device",
    "failed to connect",
    "connection reset",
    "socket closed",
    "deadline exceeded",
    "data transfer failed",
    "halted",
    "unavailable:",
    # the CUDA runtime's cudaGetErrorString texts and enum names of the
    # errors that mean the card is gone (held against libcudart on the
    # card by tests/test_torch_cuda_kernels.py)
    "no cuda-capable device is detected",  # cudaErrorNoDevice
    "busy or unavailable",  # cudaErrorDevicesUnavailable
    "uncorrectable ecc error encountered",  # cudaErrorECCUncorrectable
    "the launch timed out and was terminated",  # cudaErrorLaunchTimeout
    "cudaerrornodevice",
    "cudaerrordevicesunavailable",
    "cudaerroreccuncorrectable",
    "cudaerrorlaunchtimeout",
)


def is_device_loss_error(exc: BaseException) -> bool:
    if isinstance(exc, DeviceLossError):
        return True
    if type(exc).__name__ != "XlaRuntimeError" and not isinstance(
        exc, RuntimeError
    ):
        return False
    msg = str(exc).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def device_retry_delay(attempts: int, base_delay_s: float = 0.05) -> float:
    """Jittered exponential backoff for device-loss retries — ONE policy
    shared by this helper and the scheduler's launch/serial retry loops
    (which can't use call_with_device_retry itself: each of their retries
    must re-encode/re-flush first)."""
    return base_delay_s * (2 ** attempts) * (1.0 + random.uniform(-0.3, 0.3))


def call_with_device_retry(
    fn: Callable,
    attempts: int,
    base_delay_s: float = 0.05,
    on_retry: Optional[Callable] = None,
):
    """Run fn(), retrying device-loss errors up to `attempts` times with
    jittered exponential backoff (a transient transfer failure heals in
    tens of ms; a dead card won't, and the caller's ride-through takes
    over). Only safe for repeatable calls — a launch that DONATED its
    inputs must re-flush before retrying and cannot use this helper."""
    n = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classifier filters
            if not is_device_loss_error(e) or n >= attempts:
                raise
            n += 1
            if on_retry is not None:
                on_retry(n, e)
            time.sleep(device_retry_delay(n, base_delay_s))
