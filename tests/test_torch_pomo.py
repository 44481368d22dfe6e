"""POMO on CVRP through the port against the JAX package: the CVRP embedding
and context modules, the multistart rollout, the POMO loss and every
parameter's gradient on replayed actions, the evaluation step,
`evaluate_policy`'s two multistart methods and `Trainer.fit`.

The two frameworks' random streams cannot be matched: the JAX side runs its
multistart train spec greedily and the port replays the JAX actions
(``kind="evaluate"``), or both run greedily. Tolerances: modules atol 1e-5;
rollout actions equal, rewards rtol 1e-5, log-likelihoods atol 1e-4; loss
and metrics atol 2e-5; gradients rtol 1e-3, atol 1e-5 (f32 on both sides,
other summation orders through instance norm and 20 decode steps), as in
`test_torch_reinforce.py`."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models import rollout as jax_rollout
from rl4co_tpu.models.nn.env_embeddings.context import VRPContext as JaxVRPContext
from rl4co_tpu.models.nn.env_embeddings.init import VRPInitEmbedding as JaxVRPInit
from rl4co_tpu.models.zoo.pomo import POMO as JaxPOMO
from rl4co_tpu.tasks.eval import evaluate_policy as jax_evaluate
from rl4co_tpu_torch.convert import convert_params
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import rollout
from rl4co_tpu_torch.models.nn.env_embeddings import (
    env_context_embedding,
    env_init_embedding,
)
from rl4co_tpu_torch.models.zoo.pomo import POMO, make_pomo_policy
from rl4co_tpu_torch.rl.baselines import SharedBaseline
from rl4co_tpu_torch.tasks.eval import evaluate_policy
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig
from rl4co_tpu_torch.utils.ops import batchify

from _torch_port import SMALL, pomo_pair, random_cvrp, t2n, tree_to_numpy

torch.set_num_threads(1)

N, B, D = 10, 4, 32
KEY = jax.random.PRNGKey(0)
METRICS = ("loss", "reinforce_loss", "bl_loss", "reward", "bl_val", "max_reward", "entropy")


def to_torch(inst):
    return {k: torch.from_numpy(v) for k, v in inst.items()}


def to_jax(inst):
    return {k: jnp.asarray(v) for k, v in inst.items()}


def drawn(rs, shape):
    return (rs.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


def test_vrp_init_embedding_matches_jax():
    inst = random_cvrp(0, B, N)
    rs = np.random.RandomState(1)
    params = {"init_embed_depot": {"kernel": drawn(rs, (2, D)), "bias": drawn(rs, (D,))},
              "init_embed": {"kernel": drawn(rs, (3, D)), "bias": drawn(rs, (D,))}}
    want = JaxVRPInit(embed_dim=D).apply({"params": params}, to_jax(inst))
    module = env_init_embedding("cvrp", D)
    module.load_state_dict(convert_params(params))
    got = module(to_torch(inst))
    assert got.shape == (B, N + 1, D)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)
    # the depot row comes first and reads the depot alone
    np.testing.assert_allclose(t2n(got[:, 0]), inst["depot"] @ params["init_embed_depot"]["kernel"]
                               + params["init_embed_depot"]["bias"], atol=1e-5)


@pytest.mark.parametrize("repeats", [1, 3], ids=["flat", "grouped"])
def test_vrp_context_matches_jax(repeats):
    rs = np.random.RandomState(2)
    emb = rs.standard_normal((B, N + 1, D)).astype(np.float32)
    cur = rs.randint(0, N + 1, size=repeats * B)
    used = rs.random_sample(repeats * B).astype(np.float32)
    params = {"project_context": {"kernel": drawn(rs, (D + 1, D))}}
    # JAX reads the embeddings tiled to the flat state; the port reads them untiled
    tiled = np.concatenate([emb] * repeats)
    jstate = types.SimpleNamespace(current_node=jnp.asarray(cur), used_capacity=jnp.asarray(used))
    want = JaxVRPContext(embed_dim=D).apply({"params": params}, jnp.asarray(tiled), jstate)
    module = env_context_embedding("cvrp", D)
    module.load_state_dict(convert_params(params))
    assert tuple(module.project_context.weight.shape) == (D, D + 1)
    tstate = types.SimpleNamespace(current_node=torch.from_numpy(cur),
                                   used_capacity=torch.from_numpy(used))
    got = module(torch.from_numpy(emb), tstate)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)


def test_pomo_policy_and_algorithm_take_the_jax_configuration():
    policy = make_pomo_policy("cvrp", embed_dim=D, num_heads=4, feedforward_hidden=64,
                              device="cpu")
    assert policy.num_encoder_layers == 6 and not policy.use_graph_context
    assert policy.project_fixed_context is None
    assert not any("project_fixed_context" in k for k in policy.state_dict())
    assert policy.encoder_net.layer_0.norm1.normalization == "instance"
    env = get_env("cvrp", num_loc=N)
    algo = POMO(env, policy, train_spec=DecodeSpec(kind="greedy", tanh_clipping=10.0))
    jalgo = JaxPOMO(env=jax_get_env("cvrp", num_loc=N), policy=None,
                    train_spec=JaxSpec(kind="greedy", tanh_clipping=10.0))
    for f in ("kind", "multistart", "num_starts", "tanh_clipping"):
        assert getattr(algo.train_spec, f) == getattr(jalgo.train_spec, f), f
    assert algo.num_starts == jalgo.num_starts == N
    assert algo.baseline == SharedBaseline(num_repeats=N)
    assert (algo.num_augment, algo.augment_fn) == (jalgo.num_augment, jalgo.augment_fn)


@pytest.mark.parametrize("jimpl", ["pallas", "xla"])
def test_multistart_greedy_rollout_matches_jax(jimpl):
    jpol, jparams, tpol = pomo_pair(seed=3, jax_pointer_impl=jimpl)
    inst = random_cvrp(4, B, N)
    spec = dict(kind="greedy", tanh_clipping=10.0, multistart=True, num_starts=N)
    jout = jax_rollout(jpol, jparams, jax_get_env("cvrp", num_loc=N), to_jax(inst), KEY,
                       JaxSpec(**spec))
    tout = rollout(tpol, get_env("cvrp", num_loc=N), inst, DecodeSpec(**spec), device="cpu")
    assert tout.actions.shape == (N * B, 2 * N)
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    # starts-major: row s * B + b starts instance b at customer s + 1
    np.testing.assert_array_equal(t2n(tout.actions[:, 0]), np.repeat(np.arange(1, N + 1), B))
    np.testing.assert_allclose(t2n(tout.reward), np.asarray(jout.reward), rtol=1e-5)
    np.testing.assert_allclose(t2n(tout.log_likelihood), np.asarray(jout.log_likelihood),
                               atol=1e-4)
    np.testing.assert_allclose(t2n(tout.entropy), np.asarray(jout.entropy), atol=1e-4)


def pomo_algos(jimpl, seed=5):
    """(JAX POMO with its train spec made greedy, its params, the port's POMO)
    on the same weights; the port's policy records gradients."""
    jpol, jparams, tpol = pomo_pair(seed=seed, jax_pointer_impl=jimpl)
    tpol.train().requires_grad_(True)
    jalgo = JaxPOMO(env=jax_get_env("cvrp", num_loc=N), policy=jpol,
                    train_spec=JaxSpec(kind="sampling", tanh_clipping=10.0))
    object.__setattr__(jalgo, "train_spec", dataclasses.replace(jalgo.train_spec, kind="greedy"))
    talgo = POMO(get_env("cvrp", num_loc=N), tpol,
                 train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0))
    return jalgo, jparams, talgo


@pytest.mark.parametrize("jimpl,port", [("xla", "replay"), ("pallas", "replay"),
                                        ("xla", "greedy")])
def test_loss_metrics_and_every_gradient_match_jax(jimpl, port):
    jalgo, jparams, talgo = pomo_algos(jimpl)
    inst = random_cvrp(6, B, N)
    (jloss, (jmetrics, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, None, to_jax(inst), KEY)
    if port == "replay":
        tloss, (tmetrics, tout) = talgo.loss(to_torch(inst), replay_actions=np.array(jout.actions))
    else:
        talgo.train_spec = dataclasses.replace(talgo.train_spec, kind="greedy")
        tloss, (tmetrics, tout) = talgo.loss(to_torch(inst))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    assert set(tmetrics) == set(METRICS) == set(jmetrics)
    for name in METRICS:
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]), atol=2e-5,
                                   err_msg=name)
    assert abs(tloss.item()) > 1e-3  # a zero advantage would make the rest vacuous
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}
    got = {k: p.grad for k, p in talgo.policy.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    assert max(np.abs(w).max() for w in want.values()) > 1e-2


def test_eval_step_matches_jax():
    jalgo, jparams, talgo = pomo_algos("xla", seed=7)
    inst = random_cvrp(8, B, N)
    jm = jalgo.make_eval_step()(jparams, to_jax(inst), KEY)
    tm = talgo.make_eval_step()(inst)
    assert set(tm) == set(jm) == {"reward", "max_reward", "max_aug_reward"}
    for k in tm:
        assert not tm[k].requires_grad, k
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)
    assert tm["max_aug_reward"] >= tm["max_reward"] >= tm["reward"]


def cvrp_cost64(inst, actions):
    locs = np.concatenate([inst["depot"][:, None], inst["locs"]], axis=1).astype(np.float64)
    pts = np.take_along_axis(locs, actions[:, :, None], axis=1)
    pts = np.concatenate([locs[:, :1], pts], axis=1)
    return np.linalg.norm(pts - np.roll(pts, 1, axis=1), axis=-1).sum(-1)


@pytest.mark.parametrize("method", ["multistart_greedy", "multistart_greedy_augment_dihedral_8"])
def test_evaluate_policy_on_cvrp_matches_jax(method):
    jpol, jparams, tpol = pomo_pair(seed=9)
    count, batch = 10, 4   # a ragged tail of 2
    inst = random_cvrp(10, count, N)
    jres = jax_evaluate(jax_get_env("cvrp", num_loc=N), jpol, jparams, inst, method,
                        batch_size=batch, check_solutions=True, warmup=False)
    tres = evaluate_policy(get_env("cvrp", num_loc=N), tpol, inst, method, batch_size=batch,
                           check_solutions=True, warmup=False, device="cpu")
    assert set(tres) == set(jres)
    assert tres["rewards"].shape == (count,) and tres["actions"].shape == (count, 2 * N)
    np.testing.assert_allclose(tres["rewards"], jres["rewards"], rtol=1e-5)
    # best actions equal, up to exact ties: two starts that end in one route
    # set in another order differ in the last bit between frameworks
    differ = (tres["actions"] != jres["actions"]).any(axis=1)
    assert differ.mean() <= 0.2, differ
    rows = {k: v[differ] for k, v in inst.items()}
    np.testing.assert_allclose(cvrp_cost64(rows, tres["actions"][differ]),
                               cvrp_cost64(rows, jres["actions"][differ]), rtol=1e-9)
    np.testing.assert_allclose(cvrp_cost64(inst, tres["actions"]), -tres["rewards"], rtol=1e-5)


def test_trainer_fits_pomo_on_cvrp():
    torch.manual_seed(0)
    env = get_env("cvrp", num_loc=N)
    algo = POMO(env, policy_kwargs=dict(SMALL, device="cpu"))
    before = [p.detach().clone() for p in algo.policy.parameters()]
    trainer = Trainer(algo, TrainerConfig(epochs=2, batch_size=4, train_data_size=8,
                                          val_data_size=4, val_batch_size=4, seed=3),
                      logger=lambda m: None)
    trainer.fit()
    assert algo.step == 4 and [r["epoch"] for r in trainer.history] == [0, 1]
    rec = trainer.history[-1]
    assert rec["val/max_aug_reward"] >= rec["val/max_reward"] >= rec["val/reward"]
    assert np.isfinite(rec["val/reward"])
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(algo.policy.parameters(), before))
    assert moved > 1e-6 and algo.optimizer.grad_norm.item() > 0
    # a fresh batch's starts through the policy's grouped decode: one per customer
    inst = env.generate(2, torch.Generator().manual_seed(1), device="cpu")
    with torch.no_grad():
        out = rollout(algo.policy, env, inst, algo.train_spec,
                      generator=torch.Generator().manual_seed(2), device="cpu")
    np.testing.assert_array_equal(t2n(out.actions[:, 0]), np.repeat(np.arange(1, N + 1), 2))
    env.check_solution_validity(batchify(inst, N), out.actions)
