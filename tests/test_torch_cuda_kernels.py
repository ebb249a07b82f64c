"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips
without a CUDA device (the kernels have no CPU or interpret mode; the
plain versions are held against the JAX reference in the CPU tests).

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Tolerance: none — the fit mask is boolean and must be bit-equal.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops.fit_kernels import fit_mask, fit_mask_plain


def _case(seed, tpl, n, r):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[rng.random((tpl, r)) < 0.3] = 0  # zero requests fit anywhere
    alloc = rng.integers(1000, 64000, size=(n, r)).astype(np.int32)
    free = alloc - (alloc * rng.random((n, r)) * 0.9).astype(np.int32)
    free[::7] -= 70000  # negative free
    return torch.from_numpy(req).cuda(), torch.from_numpy(free).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "tpl,n,r",
    [(4, 8192, 6), (8, 8192, 6), (64, 8192, 6), (5, 700, 6), (3, 5001, 1),
     (7, 1000, 12), (300, 129, 6), (1, 1, 16)],
)
def test_fit_mask_kernel_matches_plain(tpl, n, r):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free = _case(tpl * 1000 + n + r, tpl, n, r)
    before = fit_mask.launches
    got = fit_mask(req, free)
    torch.cuda.synchronize()
    assert fit_mask.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (tpl, n)
    assert torch.equal(got, fit_mask_plain(req, free))


@pytest.mark.cuda
def test_fit_mask_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    req, free = _case(0, 4, 256, 6)
    with pytest.raises(TypeError):
        fit_mask(req.long(), free)
    with pytest.raises(ValueError):
        fit_mask(req, free.cpu())
    with pytest.raises(ValueError):
        fit_mask(req[:, :5], free)
    with pytest.raises(ValueError):
        fit_mask(*_case(1, 2, 64, 17))
