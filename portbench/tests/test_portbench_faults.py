"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program's call, on the CPU at tiny
sizes (the harness's look for a card skipped)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from conftest import TINY_CFG, TINY_PARAMS
from portbench.harness.core import run_cell


def _run(cell, hooks):
    line, _ = run_cell(cell, 2**31 + 23, 0.5, False, torch.device("cpu"), time.perf_counter(),
                       cfg_overrides=TINY_CFG, param_overrides=TINY_PARAMS[cell], hooks=hooks)
    return line


def _serving(alter):
    """A serve hook: the program's dispatch, its answers passed through ``alter``."""
    def make(cell, weights):
        def serve(cfg, env, policy, inst, method, batch, device):
            return alter(env, *cell.program.serve(cfg, env, policy, inst, method, batch, device))
        return serve
    return make


# every answer altered, so that the judge's sample holds one whatever it draws

def swap_two_stops(env, rewards, actions):
    actions = actions.copy()
    for row in actions:
        stops = np.flatnonzero(row > 0)[:2]
        row[stops] = row[stops[::-1]]
    return rewards, actions


def shift_one_cost(env, rewards, actions):
    return rewards - 1e-3 * np.abs(rewards), actions


def half_the_batch(env, rewards, actions):
    return rewards[: len(rewards) // 2], actions[: len(actions) // 2]


def best_of_broken(cell, weights):
    """The best over symmetries left out: each answer the best of copy 0's starts."""
    def serve(cfg, env, policy, inst, method, batch, device):
        return cell.program.serve(cfg, env, policy, inst, "multistart_greedy", batch, device)
    return serve


def stuck_state(cell, weights):
    """The env's step returns its state unchanged."""
    def serve(cfg, env, policy, inst, method, batch, device):
        stuck = type("Stuck", (type(env),), {"step": lambda self, state, action: state})
        return cell.program.serve(cfg, stuck(**dataclasses.asdict(env)), policy, inst, method,
                                  batch, device)
    return serve


@pytest.mark.parametrize("fault", [_serving(swap_two_stops), _serving(shift_one_cost),
                                   _serving(half_the_batch), best_of_broken,
                                   stuck_state],
                         ids=["token_altered", "answer_altered", "half_batch", "best_of_broken",
                              "state_unchanged"])
def test_serving_fault_is_not_correct(fault):
    line = _run("pomo_cvrp50.serve_aug8", {"serve": fault})
    assert line["correct"] is False
    assert line["failed"] > 0 or max(c["value"] / c["limit"] for c in line["checks"].values()) > 1


def frozen_update(algo, inst):
    """A step that returns its state unchanged: no optimiser step."""
    step = algo.optimizer.step
    algo.optimizer.step = lambda *a, **k: None
    try:
        return algo.update(inst)
    finally:
        algo.optimizer.step = step


def half_batch_update(algo, inst):
    """Half of the batch left out, the mean taken over the rest."""
    return algo.update({k: v[: v.shape[0] // 2] for k, v in inst.items()})


def one_weight_twice(algo, inst):
    """One weight of one layer takes its step twice; the rest as they should."""
    weight = dict(algo.policy.named_parameters())["encoder_net.layer_1.ffn.Dense_0.weight"]
    before = weight.detach().clone()
    out = algo.update(inst)
    with torch.no_grad():
        weight.add_(weight - before)
    return out


@pytest.mark.parametrize("fault", [frozen_update, half_batch_update, one_weight_twice],
                         ids=["state_unchanged", "half_batch", "one_weight_twice"])
def test_training_fault_is_not_correct(fault):
    line = _run("am_tsp100.train", {"update": fault})
    assert line["correct"] is False
    assert max(c["value"] / c["limit"] for c in line["checks"].values()) > 1


def test_one_weight_wrong_shows_at_the_worst_weight():
    checks = _run("am_tsp100.train", {"update": one_weight_twice})["checks"]
    assert checks["update_gap_worst"]["value"] > 0.5       # its change twice the reference's
    assert checks["update_gap"]["value"] <= checks["update_gap"]["limit"]   # the median passes
