"""The port's resource-fit mask (kubernetes_tpu_torch/ops/fit_kernels.py)
against the reference's Pallas kernel (kubernetes_tpu/ops/pallas_ops.py)
run in interpret mode and against its jnp fallback, on the CPU.

Tolerance: none — the mask is boolean and must be bit-equal. Inputs are
the seeds and edge cases of tests/test_pallas_ops.py: seeds 0-2, ragged
N = 700, zero requests, exact fit, over by one, R > 8 and negative free.

The CUDA kernel itself has no interpret mode: tests/test_torch_cuda_kernels.py
compares it with the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu.ops.pallas_ops import (
    BLOCK_N,
    fit_mask as ref_fit_mask,
    fit_mask_least_alloc,
    pad_inputs,
)
from kubernetes_tpu_torch.ops.fit_kernels import fit_mask, fit_mask_plain


def _random_case(seed, tpl=16, r=6, n=700):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[rng.random((tpl, r)) < 0.3] = 0  # sparse requests
    alloc = rng.integers(1000, 64000, size=(n, r)).astype(np.int32)
    used = (alloc * rng.random((n, r)) * 0.9).astype(np.int32)
    return req, alloc - used, alloc


def _plain(req, free):
    return fit_mask_plain(torch.from_numpy(req), torch.from_numpy(free)).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_mask_plain_matches_pallas_interpret(seed):
    """Ragged N = 700: the Pallas kernel runs (interpret) on the padded
    layout of pad_inputs; its mask over the real columns is the port's."""
    req, free, alloc = _random_case(seed)
    rq, fr, al, n = pad_inputs(req, free, alloc)
    mask, _score = fit_mask_least_alloc(rq, fr, al, interpret=True)
    np.testing.assert_array_equal(_plain(req, free), np.asarray(mask)[:, :n])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_mask_plain_matches_reference_fit_mask(seed):
    """The reference wrapper at a tiling N (Pallas, interpret) and at the
    ragged N = 700 (its jnp fallback)."""
    req, free, _ = _random_case(seed, n=640)
    want = np.asarray(ref_fit_mask(jnp.asarray(req), jnp.asarray(free), interpret=True))
    np.testing.assert_array_equal(_plain(req, free), want)
    free2 = free[:93]  # N not 128-divisible
    want2 = np.asarray(ref_fit_mask(jnp.asarray(req), jnp.asarray(free2), interpret=True))
    np.testing.assert_array_equal(_plain(req, free2), want2)
    req3, free3, _ = _random_case(seed, n=700)
    want3 = np.asarray(ref_fit_mask(jnp.asarray(req3), jnp.asarray(free3), interpret=True))
    np.testing.assert_array_equal(_plain(req3, free3), want3)


def test_fit_mask_edge_semantics():
    """Zero-request templates fit everywhere (negative free included); a
    request one unit over free fails; exact fit passes."""
    req = np.zeros((5, 3), np.int32)
    req[1, 0] = 100  # exact
    req[2, 0] = 101  # over by one
    req[3, 1] = 50  # can't fit anywhere
    req[4, 2] = 1  # only where free >= 1
    free = np.zeros((BLOCK_N, 3), np.int32)
    free[:, 0] = 100
    free[:, 1] = 49
    free[:, 2] = -5  # over-committed column
    free[::2, 2] = 1
    got = _plain(req, free)
    want = np.asarray(ref_fit_mask(jnp.asarray(req), jnp.asarray(free), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0].all() and got[1].all()
    assert not got[2].any() and not got[3].any()
    np.testing.assert_array_equal(got[4], free[:, 2] >= 1)


def test_fit_mask_wide_resources_match_fallback():
    """R > 8 (extended resources past the TPU's sublane pad): the reference
    takes its jnp fallback; the port's plain version agrees."""
    req, free, _ = _random_case(3, tpl=12, r=11, n=640)
    want = np.asarray(ref_fit_mask(jnp.asarray(req), jnp.asarray(free), interpret=True))
    np.testing.assert_array_equal(_plain(req, free), want)


def test_fit_mask_wrapper_takes_plain_on_cpu():
    req, free, _ = _random_case(4, n=333)
    before = fit_mask.launches
    got = fit_mask(torch.from_numpy(req), torch.from_numpy(free)).numpy()
    np.testing.assert_array_equal(got, _plain(req, free))
    assert fit_mask.launches == before  # no kernel on the CPU
