"""Device selection for the port's entry points.

The port's entry points run on the CUDA card unless the caller asks for
the CPU: ``device=None`` resolves to ``cuda`` and raises when no card is
present. Only an explicit ``device="cpu"`` gives the CPU (the tests pass
it). Nothing here falls back quietly."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is
    taken as given, after checking that a CUDA request can be met."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch runs on a CUDA device and none is "
            "available; pass device=\"cpu\" to run on the CPU explicitly"
        )
    return dev
