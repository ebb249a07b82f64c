"""Randomized wave-kernel parity: the seeded random clusters and pod
batches of tests/test_fuzz_differential.py (labels, taints of every
effect, unschedulable nodes, capacities, existing pods carrying
(anti-)affinity terms; pods with node selectors, required and preferred
inter-pod terms, topology spread, tolerations, host ports, priorities and
pinned nodes) through the reference's wave kernel and the port's, on the
reference's own encoded state and tie noise, with the tolerances and the
near-tie rule of tests/test_torch_wavelattice.py. Even seeds route Stage
A's fit through the fit-mask kernel path, odd seeds through the plain
broadcast, on both sides.
"""

import random

import pytest

from test_fuzz_differential import _build_random_cluster, _rand_pod
from test_torch_wavelattice import run_both


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6, 7, 8])
def test_wave_kernel_matches_reference_on_random_clusters(seed):
    rng = random.Random(seed)
    enc, _infos, nodes = _build_random_cluster(rng, rng.randrange(8, 33))
    names = [n.metadata.name for n in nodes]
    pods = [
        _rand_pod(rng, f"p{i}", allow_pin=names)
        for i in range(rng.randrange(4, 17))
    ]
    run_both(enc, pods, use_pallas_fit=seed % 2 == 0, seed=seed)
