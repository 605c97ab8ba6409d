"""On the card: the control of each kind of cell at a size a test run
holds. The tiny cells run through the program on CUDA in float32 and
agree with the float32 reference; the reference with its products in
fp8 fails the same limits. At the cells' own sizes the control runs as
``perfbench/control.py`` (see PERF.md for its readings).

    python -m pytest -q perfbench/test_perfbench_gpu.py
"""

import time

import pytest
import torch

from perfbench import judge, manifest, serve_cell, train_cell

SEED = 2 ** 31 + 7


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch sees no CUDA device)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny-dense.open", "tiny-moe.closed"])
def test_serving_control_on_the_card(tiny, name):
    dev = _card()
    root, here = tiny
    cell = manifest.load_cell(name, root, here)
    got = serve_cell.run(cell, SEED, 0.6, False, dev, time.perf_counter())
    gaps, low = judge.served_gaps(
        got["weights"], cell.config,
        *serve_cell.served(got["sample"], dev), lower=("fp8",))
    assert gaps.max() <= cell.spec["limits"]["gap_max"] < low["fp8"].max()


@pytest.mark.gpu
def test_training_control_on_the_card(tiny):
    dev = _card()
    root, here = tiny
    cell = manifest.load_cell("tiny-dense.train", root, here)
    state, step, prog = train_cell.program(cell, SEED, dev)
    f32 = train_cell.reference(cell, SEED, dev)
    prog["losses"] = prog["losses"][:3]
    ok, _ = judge.verdict(judge.train_numbers(prog, f32), cell.spec["limits"])
    assert ok
    low = judge.train_numbers(train_cell.reference(cell, SEED, dev,
                                                   prec="fp8"), f32)
    assert not judge.verdict(low, cell.spec["limits"])[0], low
