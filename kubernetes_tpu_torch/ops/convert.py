"""Carry the reference's device state into the port's tensors.

Each function takes a NamedTuple of the reference (``kubernetes_tpu``'s
``DeviceSnapshot``, ``PodBatch``, ``TemplateBatch``, ``PairTable``) — or any
object with the same field names whose values ``np.asarray`` accepts (jax
arrays, numpy arrays) — and returns the port's NamedTuple of torch tensors
on ``device``, dtypes unchanged. This lets a test run the port's wave kernel
on the reference's own encoded state, separating kernel parity from
encoding parity. Nothing here imports the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .encoding import DeviceSnapshot, PodBatch
from .templates import PairTable, TemplateBatch


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), device=device)


def _convert(cls, ref, device: torch.device):
    return cls(**{f: _tensor(getattr(ref, f), device) for f in cls._fields})


def snapshot_from_reference(ref, device: DeviceLike = None) -> DeviceSnapshot:
    return _convert(DeviceSnapshot, ref, resolve_device(device))


def pod_batch_from_reference(ref, device: DeviceLike = None) -> PodBatch:
    return _convert(PodBatch, ref, resolve_device(device))


def template_batch_from_reference(ref, device: DeviceLike = None) -> TemplateBatch:
    dev = resolve_device(device)
    fields = {
        f: _tensor(getattr(ref, f), dev)
        for f in TemplateBatch._fields
        if f != "tpl"
    }
    return TemplateBatch(tpl=_convert(PodBatch, ref.tpl, dev), **fields)


def pair_table_from_reference(ref, device: DeviceLike = None) -> PairTable:
    return _convert(PairTable, ref, resolve_device(device))


def weights_from_reference(weights, device: DeviceLike = None) -> torch.Tensor:
    """The score weight vector as a float32 tensor on ``device``."""
    return torch.tensor(
        np.asarray(weights, np.float32), device=resolve_device(device)
    )
