"""The ``DTensor`` forward and train step of
``tests/test_torch_dtensor_compute.py`` on a (2, 2) ("data", "model")
mesh of 4 gloo ranks: the batch on "data", tensor parallelism on
"model" and the FSDP pick on "data"; the same archs, weights and gates.
"""

import pytest

from repro_torch.launch import mesh as lm
from test_torch_dtensor_compute import ARCHS, CHECKS, compute_rank, unsharded


@pytest.fixture(scope="module")
def ranks():
    return lm.run_ranks(compute_rank, 4, (2, 2))[0]


@pytest.fixture(scope="module")
def plain():
    return {arch: unsharded(arch) for arch in ARCHS}


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_model_mesh_equals_unsharded(ranks, plain, arch, check):
    CHECKS[check](ranks[arch], plain[arch])
