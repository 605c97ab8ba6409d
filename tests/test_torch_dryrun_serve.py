"""The serving cells of the reference's ``TestTinyMeshDryrun`` through
the port's dry-run on the ``tiny`` mesh: mamba2 ``long_500k`` (the cache
sequence on "data"), deepseek ``decode_32k`` (MLA + MoE decode against a
sharded cache) and jamba ``prefill_32k`` (hybrid SSM + MoE), with the
gates and the reference comparisons of ``tests/test_torch_dryrun.py``.
"""

import pytest

from test_torch_dryrun import CHECKS, run_cells, small

CELLS = {
    f"{arch}-{shape}": (arch, shape, "tiny", small(arch))
    for arch, shape in (("mamba2-1.3b", "long_500k"),
                        ("deepseek-v2-lite-16b", "decode_32k"),
                        ("jamba-1.5-large-398b", "prefill_32k"))
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return run_cells(CELLS, tmp_path_factory)


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_serve_cell(records, cell, check):
    CHECKS[check](records[cell], CELLS[cell])
