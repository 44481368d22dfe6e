"""MVMoE (`models/zoo/mvmoe.py`) against `rl4co_tpu/models/zoo/mvmoe.py`: the
parameter tree (no ``encoder_net``: the JAX policy builds AM's and never
calls it), the decode step, and MVMoE_POMO's loss, metrics and every
gradient on CVRP with the port replaying the JAX package's actions.

Tolerances: logits rtol 2e-4, atol 2e-5; actions equal; loss and metrics
atol 2e-5; gradients rtol 1e-3, atol 1e-5, as `test_torch_reinforce.py`
(f32 on both sides, other summation orders through instance norm, the
experts and 16 decode steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.policies.constructive import init_policy_params
from rl4co_tpu.models.zoo.mvmoe import MVMoE_POMO as JaxMVMoE_POMO
from rl4co_tpu.models.zoo.mvmoe import MVMoEPolicy as JaxMVMoEPolicy
from rl4co_tpu_torch.convert import convert_params, load_params
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import rollout
from rl4co_tpu_torch.models.nn import attention
from rl4co_tpu_torch.models.zoo.mvmoe import MVMoE_AM, MVMoE_POMO, MVMoEPolicy
from rl4co_tpu_torch.models.zoo.pomo import POMO
from rl4co_tpu_torch.rl.baselines import RolloutBaseline, WarmupBaseline

from _torch_port import (SMALL, decode_logits_pair, random_cvrp, t2n, tree_to_numpy,
                         zoo_pair)

torch.set_num_threads(1)

N, B = 8, 4
KEY = jax.random.PRNGKey(0)
POMO_DIMS = dict(normalization="instance", use_graph_context=False)


def test_a_flax_tree_fills_the_policy_leaf_for_leaf():
    jpol = JaxMVMoEPolicy(env_name="cvrp", **SMALL, **POMO_DIMS)
    tree = tree_to_numpy(init_policy_params(jpol, jax_get_env("cvrp", num_loc=N),
                                            jax.random.PRNGKey(1)))["params"]
    assert "encoder_net" not in tree and "moe_layer_1" in tree
    policy = load_params(MVMoEPolicy(env_name="cvrp", device="cpu", **SMALL, **POMO_DIMS), tree)
    assert policy.encoder_net is None
    kernel = tree["moe_layer_0"]["moe_ffn"]["experts"]["Dense_0"]["kernel"]
    assert kernel.shape == (4, SMALL["embed_dim"], SMALL["feedforward_hidden"])
    np.testing.assert_array_equal(
        t2n(policy.moe_layer_0.moe_ffn.experts.Dense_0.kernel), kernel)  # kept [E, in, out]
    np.testing.assert_array_equal(t2n(policy.pointer.project_out_moe.w_gate),
                                  tree["pointer"]["project_out_moe"]["w_gate"])


@pytest.mark.parametrize("repeats", [1, N], ids=["single", "grouped"])
@pytest.mark.parametrize("after", [False, True], ids=["step0", "step1"])
def test_decode_step_logits_match_jax(repeats, after):
    jpol, jparams, tpol = zoo_pair("mvmoe", "cvrp", seed=2, **POMO_DIMS)
    inst = random_cvrp(3, B, N)
    first = np.random.RandomState(4).randint(1, N + 1, size=repeats * B) if after else None
    want, got = decode_logits_pair(jpol, jparams, tpol, "cvrp", inst, repeats, first)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_no_decode_step_reaches_the_pointer_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("MVMoE's pointer reached the pointer kernel's wrapper")

    monkeypatch.setattr(attention, "fused_pointer_logits", refuse)
    monkeypatch.setattr(attention, "pointer_logits_plain", refuse)
    _, _, tpol = zoo_pair("mvmoe", "cvrp", seed=2, **POMO_DIMS)
    out = rollout(tpol, get_env("cvrp", num_loc=N), random_cvrp(5, B, N),
                  DecodeSpec(kind="greedy", multistart=True, num_starts=N), device="cpu")
    assert torch.isfinite(out.reward).all()


def algos(seed=6):
    jpol, jparams, tpol = zoo_pair("mvmoe", "cvrp", seed=seed, **POMO_DIMS)
    tpol.train().requires_grad_(True)
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxMVMoE_POMO(jax_get_env("cvrp", num_loc=N), policy=jpol, train_spec=JaxSpec(**spec))
    object.__setattr__(jalgo, "train_spec", dataclasses.replace(jalgo.train_spec, kind="greedy"))
    talgo = MVMoE_POMO(get_env("cvrp", num_loc=N), policy=tpol, train_spec=DecodeSpec(**spec))
    return jalgo, jparams, talgo


def test_pomo_loss_and_every_gradient_match_jax_on_replayed_actions():
    jalgo, jparams, talgo = algos()
    inst = random_cvrp(7, B, N)
    (jloss, (jmetrics, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, None, {k: jnp.asarray(v) for k, v in inst.items()}, KEY)
    tloss, (tmetrics, tout) = talgo.loss({k: torch.from_numpy(v) for k, v in inst.items()},
                                         replay_actions=np.array(jout.actions))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    assert set(tmetrics) == set(jmetrics)
    for name in jmetrics:
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]), atol=2e-5,
                                   err_msg=name)
    assert abs(tloss.item()) > 1e-3
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}
    got = dict(talgo.policy.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(t2n(p.grad), want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2


def test_constructors_take_the_jax_configurations():
    env = get_env("cvrp", num_loc=N)
    pomo = MVMoE_POMO(env, policy_kwargs=dict(embed_dim=32, num_heads=4, feedforward_hidden=64,
                                              device="cpu"))
    assert isinstance(pomo, POMO) and isinstance(pomo.policy, MVMoEPolicy)
    p = pomo.policy
    assert (p.num_encoder_layers, p.normalization, p.use_graph_context) == (6, "instance", False)
    assert (p.num_experts, p.moe_topk) == (4, 2) and p.project_fixed_context is None
    am = MVMoE_AM(get_env("tsp", num_loc=N),
                  policy_kwargs=dict(SMALL, device="cpu"))
    assert isinstance(am.baseline, WarmupBaseline)
    assert isinstance(am.baseline.inner, RolloutBaseline)
    assert am.policy.moe_layer_1.norm1.normalization == "batch"
