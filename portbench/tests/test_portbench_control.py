"""The control, on the card at the cells' own sizes: the plain reference put
in the program's place with its matrix products in TF32 (the nearest
precision below the configurations' float32 with TF32 off) comes out not
correct, as does the training cell's planted fault (the loss's mean over
half the batch). ``python3 -m pytest portbench/tests -m card`` on the H100;
they skip elsewhere."""

import pytest

from portbench import control
from portbench.harness import manifest


def _fails(readings, cell):
    limits = manifest.workload(manifest.benchmark(), cell)["limits"]
    return any(readings[k] > limit for k, limit in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("seed", [4300000001, 4300000002, 4300000003])
def test_serving_control_is_not_correct(card, seed):
    cell = "pomo_cvrp50.serve_aug8"
    assert _fails(control.serve_control(cell, seed, 2.0, card)["control"], cell)


@pytest.mark.card
@pytest.mark.parametrize("seed", [4300000001, 4300000002, 4300000003])
def test_training_control_and_fault_are_not_correct(card, seed):
    cell = "am_tsp100.train"
    got = control.train_control(cell, seed, card)
    assert _fails(got["control"], cell) and _fails(got["half_batch"], cell)
