"""On the card, at each cell's own size: a short run of the sound program
comes out correct, and one with the cell's control switched on does not.
Marked `cuda`; skipped where there is no card."""

import time

import pytest

from fhebench import harness, spec

# seconds a run: long enough to fill the cell's sample of outputs
SECONDS = {"d48.boot": 6.0, "d48.leveled": 3.0, "std128.nand-b128": 3.0,
           "std128.huint8-add": 5.0}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_the_sound_program_is_correct_and_its_control_is_not(card, cell):
    bench = spec.Bench()
    limits = bench.limits(cell)
    seed = 2 ** 31 + 977
    sound, _ = harness.run(bench, cell, seed, SECONDS[cell], False, card, time.perf_counter())
    assert sound["correct"], sound["checks"]
    control, _ = harness.run(bench, cell, seed, SECONDS[cell], False, card, time.perf_counter(),
                             limits["controls"][limits["control"]])
    assert not control["correct"], control["checks"]
