"""K2, the port's fused fit mask + least-allocated score
(kubernetes_tpu_torch/ops/fit_kernels.py::fit_mask_least_alloc_plain),
against the reference's Pallas kernel (kubernetes_tpu/ops/pallas_ops.py::
fit_mask_least_alloc) run in interpret mode and against its jnp oracle
(fit_mask_least_alloc_reference), on the CPU.

The reference takes its TPU layout ([TPL, 8] requests, [8, N'] transposed
free/alloc with N' a multiple of 512): its inputs go through its own
``pad_inputs``. The port takes the natural [N, R] layout unpadded; the
results are compared on the real columns. Inputs are the seeds and edge
cases of tests/test_pallas_ops.py (seeds 0-2, ragged N = 700, zero
requests, exact fit, over by one) plus negative free and alloc = 0, and
the shapes the CUDA kernel's tiling makes special (``TILING_EDGES``: N =
1, 3, 5, 129, 8191 — N % 4 != 0, N < 4, a partial 64-node tile — by TPL
= 1, 3, 5, 17 — a partial 4-template tile).

Tolerance: the mask is boolean and must be equal; the score within rtol
1e-5 (the reference sums its eight padded resource rows in XLA's order,
the port sums the real ones in order).

The CUDA kernel has no interpret mode: tests/test_torch_cuda_kernels.py
compares it with the plain version on the card.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.pallas_ops import (
    BLOCK_N,
    fit_mask_least_alloc as ref_kernel,
    fit_mask_least_alloc_reference as ref_oracle,
    pad_inputs,
)
from kubernetes_tpu_torch.ops.fit_kernels import (
    fit_mask_least_alloc,
    fit_mask_least_alloc_plain,
)

RTOL = 1e-5


def _random_case(seed, tpl=16, r=6, n=700):
    rng = np.random.default_rng(seed)
    req = rng.integers(0, 2000, size=(tpl, r)).astype(np.int32)
    req[rng.random((tpl, r)) < 0.3] = 0  # sparse requests
    alloc = rng.integers(1000, 64000, size=(n, r)).astype(np.int32)
    used = (alloc * rng.random((n, r)) * 0.9).astype(np.int32)
    return req, alloc - used, alloc


def _plain(req, free, alloc):
    m, s = fit_mask_least_alloc_plain(
        torch.from_numpy(req), torch.from_numpy(free), torch.from_numpy(alloc)
    )
    return m.numpy(), s.numpy()


def _reference(req, free, alloc):
    """(interpret-mode kernel, oracle), each cut back to the real N."""
    rq, fr, al, n = pad_inputs(req, free, alloc)
    km, ks = ref_kernel(rq, fr, al, interpret=True)
    om, os_ = ref_oracle(rq, fr, al)
    cut = lambda x: np.asarray(x)[:, :n]  # noqa: E731
    return (cut(km), cut(ks)), (cut(om), cut(os_))


def _assert_matches_reference(req, free, alloc):
    mask, score = _plain(req, free, alloc)
    assert mask.dtype == np.bool_ and score.dtype == np.float32
    for ref_mask, ref_score in _reference(req, free, alloc):
        np.testing.assert_array_equal(mask, ref_mask)
        np.testing.assert_allclose(score, ref_score, rtol=RTOL)


# (seed, TPL, N): the reference test's seeds at ragged N = 700, then every
# TPL in {1, 3, 5, 17} at every N in {1, 3, 5, 129, 8191}
TILING_EDGES = [pytest.param(s, 16, 700, id=str(s)) for s in (0, 1, 2)] + [
    pytest.param(10 + i, tpl, n, id=f"tpl{tpl}-n{n}")
    for i, (tpl, n) in enumerate(
        (tpl, n) for n in (1, 3, 5, 129, 8191) for tpl in (1, 3, 5, 17)
    )
]


@pytest.mark.parametrize("seed,tpl,n", TILING_EDGES)
def test_least_alloc_plain_matches_pallas_interpret_and_oracle(seed, tpl, n):
    _assert_matches_reference(*_random_case(seed, tpl=tpl, n=n))


def test_least_alloc_edge_semantics():
    """Zero-request templates fit everywhere with score 0; a request one
    unit over free fails; exact fit passes with score 0 — the reference
    test's cases, on the port."""
    req = np.zeros((4, 3), np.int32)
    req[1, 0] = 100  # exact
    req[2, 0] = 101  # over by one
    req[3, 1] = 50
    free = np.zeros((BLOCK_N, 3), np.int32)
    free[:, 0] = 100
    free[:, 1] = 49  # template 3 can't fit anywhere
    alloc = np.full((BLOCK_N, 3), 200, np.int32)
    mask, score = _plain(req, free, alloc)
    assert mask[0].all() and (score[0] == 0).all()
    assert mask[1].all()
    assert not mask[2].any()
    assert not mask[3].any()
    np.testing.assert_allclose(score[1], 0.0, atol=1e-6)
    _assert_matches_reference(req, free, alloc)


def test_least_alloc_negative_free_and_zero_alloc():
    """Over-committed nodes (negative free) and alloc = 0 columns (the
    denominator clamps to 1) agree with the reference too."""
    req, free, alloc = _random_case(5, tpl=9, r=5, n=300)
    free[::7] -= 70000
    alloc[::5, 2] = 0
    alloc[3] = 0
    _assert_matches_reference(req, free, alloc)


def test_least_alloc_zero_padded_columns_change_nothing():
    """The reference pads R to 8 with zero columns; padding the port's
    input the same way leaves mask and score unchanged bit for bit."""
    req, free, alloc = _random_case(6, tpl=7, r=5, n=257)
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((a.shape[0], 3), np.int32)], axis=1
    )
    m5, s5 = _plain(req, free, alloc)
    m8, s8 = _plain(pad(req), pad(free), pad(alloc))
    np.testing.assert_array_equal(m5, m8)
    np.testing.assert_array_equal(s5, s8)


def test_least_alloc_wrapper_takes_plain_on_cpu():
    req, free, alloc = _random_case(4, n=333)
    before = fit_mask_least_alloc.launches
    m, s = fit_mask_least_alloc(
        torch.from_numpy(req), torch.from_numpy(free), torch.from_numpy(alloc)
    )
    pm, ps = _plain(req, free, alloc)
    np.testing.assert_array_equal(m.numpy(), pm)
    np.testing.assert_array_equal(s.numpy(), ps)
    assert fit_mask_least_alloc.launches == before  # no kernel on the CPU


def test_least_alloc_wrapper_refuses_mixed_devices():
    """A CUDA request can never quietly take the plain version: tensors
    that are not all on the CPU must all be on one CUDA device, and here
    that check raises before any kernel is built."""
    req, free, alloc = _random_case(4, n=33)
    meta = torch.empty((33, 6), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fit_mask_least_alloc(
            torch.from_numpy(req), torch.from_numpy(free), meta
        )
