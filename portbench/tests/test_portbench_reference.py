"""The plain reference against the port's plain path (its CPU path) at tiny
sizes, on the weights the benchmark draws."""

import time

import pytest
import torch

from conftest import TINY_CFG, TINY_PARAMS
from portbench.harness import inputs, manifest
from portbench.harness.core import run_cell
from portbench.reference import attention_model as ref

CELLS = {"pomo_cvrp50.serve_aug8": "pomo_cvrp50", "am_tsp100.train": "am_tsp100"}


def _setup(config, tiny=True, seed=5):
    bench = manifest.benchmark()
    cfg = {**manifest.config(bench, config), **(TINY_CFG if tiny else {})}
    program, _ = manifest.family(cfg["family"])
    weights = inputs.make_weights(ref.param_schema(cfg), inputs.generator(seed, 1, "cpu"), "cpu")
    policy = program.make_policy(cfg, weights, "cpu")
    inst = inputs.make_instances(cfg, 6, inputs.generator(seed, 2, "cpu"), "cpu")
    return cfg, program, weights, policy, inst


@pytest.mark.parametrize("config", ["pomo_cvrp50", "am_tsp100"])
def test_schema_is_the_ports_state_dict_at_full_width(config):
    cfg, _, weights, policy, _ = _setup(config, tiny=False)
    assert {k: tuple(v.shape) for k, v in policy.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in weights.items()}
    # the port holds a copy: the weights handed to the reference are not its own
    for k, v in policy.state_dict().items():
        assert v.data_ptr() != weights[k].data_ptr() and torch.equal(v, weights[k])


@pytest.mark.parametrize("config", ["pomo_cvrp50", "am_tsp100"])
def test_encoder_matches(config):
    cfg, _, weights, policy, inst = _setup(config)
    with torch.no_grad():
        got = policy.encode(inst)
    torch.testing.assert_close(ref.encode(weights, cfg, inst), got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", ["pomo_cvrp50", "am_tsp100"])
def test_greedy_multistart_matches(config):
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.policies.constructive import rollout

    cfg, program, weights, policy, inst = _setup(config)
    env = program.make_env(cfg)
    s = cfg["num_loc"]
    spec = DecodeSpec(kind="greedy", multistart=True, num_starts=s, tanh_clipping=10.0)
    with torch.no_grad():
        out = rollout(policy, env, inst, spec, device="cpu")
        want = ref.rollout(weights, cfg, inst, starts=s, mode="greedy")
    b = inst["locs"].shape[0]
    assert torch.equal(out.actions.reshape(s, b, -1).transpose(0, 1), want["actions"])
    torch.testing.assert_close(-out.reward.reshape(s, b).t(), want["cost"], rtol=1e-6, atol=1e-6)
    # the replay of the port's own tours reads no gap
    with torch.no_grad():
        replay = ref.rollout(weights, cfg, inst, starts=s, mode="force", actions=want["actions"])
    assert float(replay["gap"].max()) == 0.0


def test_sampling_with_the_same_uniforms_matches():
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.models.policies.constructive import rollout

    cfg, program, weights, policy, inst = _setup("am_tsp100")
    env = program.make_env(cfg)
    gen = inputs.generator(9, 3, "cpu")
    start = gen.get_state()
    out = rollout(policy, env, inst, DecodeSpec(kind="sampling", tanh_clipping=10.0),
                  generator=gen, device="cpu")
    gen.set_state(start)
    us = [torch.rand(6, generator=gen) for _ in range(ref.max_steps(cfg))]
    want = ref.rollout(weights, cfg, inst, mode="sample", uniforms=us)
    assert torch.equal(out.actions, want["actions"][:, 0])
    torch.testing.assert_close(out.log_likelihood, want["ll"][:, 0], rtol=1e-5, atol=1e-4)


def test_symmetries_keep_costs():
    cfg, _, weights, _, inst = _setup("pomo_cvrp50")
    aug = ref.augment8(inst)
    assert torch.equal(aug["locs"][:6], inst["locs"]) and torch.equal(aug["demand"][6:12], inst["demand"])
    tour = torch.arange(1, 11)[None, None, :].expand(48, 1, 10)
    acts = torch.cat([tour, torch.zeros(48, 1, 10, dtype=torch.long)], dim=-1)
    env = ref._Env(cfg, aug, 1)
    cost = env.tour_length(acts).reshape(8, 6)
    torch.testing.assert_close(cost, cost[:1].expand(8, 6), rtol=1e-6, atol=0)


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(cell):
    line, lines = run_cell(cell, 2**31 + 11, 0.5, False, torch.device("cpu"), time.perf_counter(),
                           cfg_overrides=TINY_CFG, param_overrides=TINY_PARAMS[cell])
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert all(c["value"] < 1e-4 for c in line["checks"].values()), line["checks"]
    assert list(line)[-1] == "checks" and lines[-1].startswith("check ")
