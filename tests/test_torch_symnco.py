"""SymNCO (`models/zoo/symnco.py`) against `rl4co_tpu/models/zoo/symnco.py`:
the projection head's parameters, the decode step, and the loss with its
three terms gated as the JAX package gates them (`loss_ps` with starts,
`loss_ss` with augmentations, `loss_inv` with augmentations and a head),
with every gradient on replayed actions. As the gates cross the axes the
baselines average over (`loss_ps` over the augmentations, `loss_ss` over the
starts), the two REINFORCE terms are both non-zero only with augmentations
and starts: with starts alone every term is zero, and with augmentations
alone (the default, ``num_starts=0``) only the invariance term remains.

The augmentation is drawn from the JAX key by the JAX package and handed to
the port (its own draws come from a `torch.Generator`; the transform itself
is held to JAX's in `test_torch_transforms.py`); the JAX train spec runs
greedily and the port replays its actions. Tolerances: logits rtol 2e-4,
atol 2e-5; actions equal; loss and metrics atol 2e-5; gradients rtol 1e-3,
atol 1e-5, as `test_torch_reinforce.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.data.transforms import augment_instances as jax_augment
from rl4co_tpu.decoding import DecodeSpec as JaxSpec
from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.models.policies.constructive import init_policy_params
from rl4co_tpu.models.zoo.symnco import SymNCO as JaxSymNCO
from rl4co_tpu.models.zoo.symnco import SymNCOPolicy as JaxSymNCOPolicy
from rl4co_tpu_torch.convert import convert_params, load_params
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models.zoo.symnco import SymNCO, SymNCOPolicy
from rl4co_tpu_torch.rl.baselines import NoBaseline

from _torch_port import SMALL, decode_logits_pair, random_locs, t2n, tree_to_numpy, zoo_pair

torch.set_num_threads(1)

N, B = 10, 4
KEY = jax.random.PRNGKey(3)
METRICS = ("loss", "loss_ps", "loss_ss", "loss_inv", "reward", "entropy")


def test_a_flax_tree_fills_the_policy_leaf_for_leaf():
    jpol = JaxSymNCOPolicy(env_name="tsp", **SMALL)
    tree = tree_to_numpy(init_policy_params(jpol, jax_get_env("tsp", num_loc=N),
                                            jax.random.PRNGKey(1)))["params"]
    assert set(tree["projection_head"]) == {"layers_0", "layers_2"}
    policy = load_params(SymNCOPolicy(env_name="tsp", device="cpu", **SMALL), tree)
    without = SymNCOPolicy(env_name="tsp", device="cpu", use_projection_head=False, **SMALL)
    assert not any("projection_head" in k for k in without.state_dict())
    assert len(policy.state_dict()) == len(without.state_dict()) + 4


@pytest.mark.parametrize("repeats", [1, N], ids=["single", "grouped"])
def test_decode_step_logits_match_jax(repeats):
    jpol, jparams, tpol = zoo_pair("symnco", seed=2)
    first = np.random.RandomState(4).randint(0, N, size=repeats * B)
    want, got = decode_logits_pair(jpol, jparams, tpol, "tsp", {"locs": random_locs(3, B, N)},
                                   repeats, first)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def algos(num_augment, num_starts, seed=5):
    jpol, jparams, tpol = zoo_pair("symnco", seed=seed)
    tpol.train().requires_grad_(True)
    spec = dict(kind="sampling", tanh_clipping=10.0)
    jalgo = JaxSymNCO(env=jax_get_env("tsp", num_loc=N), policy=jpol, train_spec=JaxSpec(**spec),
                      num_augment=num_augment, num_starts=num_starts)
    object.__setattr__(jalgo, "train_spec", dataclasses.replace(jalgo.train_spec, kind="greedy"))
    talgo = SymNCO(get_env("tsp", num_loc=N), tpol, train_spec=DecodeSpec(**spec),
                   num_augment=num_augment, num_starts=num_starts)
    return jalgo, jparams, talgo


# (augments, starts) -> the terms that come out non-zero
CASES = {(3, N): {"loss_ps", "loss_ss", "loss_inv"}, (1, N): set(), (3, 0): {"loss_inv"}}


@pytest.mark.parametrize("num_augment,num_starts", list(CASES),
                         ids=["augments-and-starts", "starts-only", "augments-only"])
def test_loss_terms_and_every_gradient_match_jax_on_replayed_actions(num_augment, num_starts):
    jalgo, jparams, talgo = algos(num_augment, num_starts)
    locs = {"locs": jnp.asarray(random_locs(6, B, N))}
    (jloss, (jmetrics, jout)), jgrads = jax.value_and_grad(jalgo.loss, has_aux=True)(
        jparams, None, locs, KEY)
    # the copies JAX trained on (its loss splits the key: augmentation first)
    kaug, _ = jax.random.split(KEY)
    copies = (jax_augment(locs, num_augment, "symmetric", key=kaug) if num_augment > 1
              else locs)
    talgo.augment = lambda instances: {k: torch.from_numpy(np.array(v))
                                       for k, v in copies.items()}
    tloss, (tmetrics, tout) = talgo.loss({k: torch.from_numpy(np.array(v)) for k, v in locs.items()},
                                         replay_actions=np.array(jout.actions))
    np.testing.assert_array_equal(t2n(tout.actions), np.asarray(jout.actions))
    assert tout.actions.shape == (max(num_starts, 1) * num_augment * B, N)
    assert set(tmetrics) == set(METRICS) == set(jmetrics)
    for name in METRICS:
        np.testing.assert_allclose(tmetrics[name].item(), float(jmetrics[name]), atol=2e-5,
                                   err_msg=name)
    nonzero = {t for t in ("loss_ps", "loss_ss", "loss_inv") if tmetrics[t] != 0}
    assert nonzero == CASES[num_augment, num_starts]
    tloss.backward()
    want = {k: v.numpy() for k, v in convert_params(tree_to_numpy(jgrads)).items()}
    got = dict(talgo.policy.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        g = t2n(p.grad) if p.grad is not None else np.zeros_like(want[name])
        np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    largest = max(np.abs(w).max() for w in want.values())
    assert largest > 1e-2 if nonzero else largest == 0.0


def test_configuration_is_the_jax_one():
    jalgo, _, talgo = algos(4, N)
    assert isinstance(talgo.baseline, NoBaseline)
    for f in ("kind", "multistart", "num_starts", "tanh_clipping"):
        want = getattr(jalgo.train_spec, f) if f != "kind" else "sampling"
        assert getattr(talgo.train_spec, f) == want, f
    defaults = SymNCO(get_env("tsp", num_loc=N), policy_kwargs=dict(SMALL, device="cpu"))
    jdef = JaxSymNCO(env=jax_get_env("tsp", num_loc=N), policy=None)
    for f in ("num_augment", "augment_fn", "alpha", "beta", "num_starts"):
        assert getattr(defaults, f) == getattr(jdef, f), f
    assert not defaults.train_spec.multistart


def test_train_step_draws_its_augmentation_from_the_generator():
    _, _, talgo = algos(4, N, seed=8)
    talgo.reseed(1)
    a = talgo.augment({"locs": torch.from_numpy(random_locs(9, B, N))})["locs"]
    talgo.reseed(1)
    b = talgo.augment({"locs": torch.from_numpy(random_locs(9, B, N))})["locs"]
    assert torch.equal(a, b) and a.shape == (4 * B, N, 2)
    metrics = talgo.train_step(B)
    assert all(torch.isfinite(metrics[m]) for m in METRICS)
