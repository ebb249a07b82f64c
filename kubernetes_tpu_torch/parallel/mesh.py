"""The device probe of ``kubernetes_tpu/parallel/mesh.py`` (PyTorch port).

Only ``_default_probe`` is ported: the single-device branch of the
Scheduler's device-loss ladder asks it whether the card still answers.
The mesh (``make_mesh``, the snapshot shardings) and the mesh-shrink
helpers (``surviving_devices``, ``largest_pow2_prefix``) wait for the
multi-device slice, ROADMAP queue 1 item 8.
"""

from __future__ import annotations

from typing import Optional

import torch


def _default_probe(device: Optional[torch.device]) -> bool:
    """One tiny put/get round-trip: the cheapest 'is this device alive'
    signal that exercises both transfer directions. device=None probes
    the current CUDA device. The synchronize makes a sticky error (a
    lost device, an uncorrectable ECC error) surface here as an
    exception rather than later in an unrelated call."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    x = torch.zeros(1, dtype=torch.float32).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return tuple(x.cpu().shape) == (1,)
