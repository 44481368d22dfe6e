"""Helpers shared by the tests of the PyTorch port (`tests/test_torch_*.py`).

The tests, unlike the port, import both frameworks: inputs and weights are
made with numpy and go through the JAX package and through its counterpart.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
from rl4co_tpu.models.zoo.pomo import make_pomo_policy as jax_make_pomo_policy
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.envs.routing.cvrp import default_capacity
from rl4co_tpu_torch.models import AttentionModelPolicy as TorchPolicy
from rl4co_tpu_torch.models.zoo.pomo import make_pomo_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSP50_FILE = os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz")
TSP100_FILE = os.path.join(ROOT, "data", "tsp", "test100_seed1234.npz")
CVRP50_FILE = os.path.join(ROOT, "data", "cvrp", "test50_seed1234.npz")

# the small size of the port's tests
SMALL = dict(embed_dim=32, num_heads=4, num_encoder_layers=2, feedforward_hidden=64)


def tree_to_numpy(tree):
    """A JAX/Flax parameter tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def tree_to_jax(tree):
    """Nested dicts of numpy arrays as a Flax ``{"params": ...}`` tree."""
    return {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def policy_pair(seed=0, jax_pointer_impl="xla", torch_pointer_impl="kernel", **dims):
    """The same seeded weights as (JAX policy, its params, PyTorch policy on the CPU)."""
    dims = {**SMALL, **dims}
    tree = random_params_numpy(
        seed, dims["embed_dim"], dims["num_encoder_layers"], dims["feedforward_hidden"]
    )
    jpol = JaxPolicy(env_name="tsp", pointer_impl=jax_pointer_impl, **dims)
    tpol = TorchPolicy(env_name="tsp", pointer_impl=torch_pointer_impl,
                       device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def random_locs(seed, b, n):
    return np.random.RandomState(seed).random_sample((b, n, 2)).astype(np.float32)


def pomo_tree(seed, embed_dim, num_encoder_layers, feedforward_hidden):
    """A POMO/CVRP ``params`` tree from numpy seeds: AM's encoder with instance
    norm, the CVRP embeddings, no graph-context projection."""
    tree = random_params_numpy(seed, embed_dim, num_encoder_layers, feedforward_hidden,
                               normalization="instance")
    rs, d = np.random.RandomState(seed + 1), embed_dim

    def dense(fan_in, fan_out, use_bias=True):
        out = {"kernel": (rs.standard_normal((fan_in, fan_out))
                          / np.sqrt(fan_in)).astype(np.float32)}
        if use_bias:
            out["bias"] = (0.1 * rs.standard_normal(fan_out)).astype(np.float32)
        return out

    tree["init_embedding"] = {"init_embed_depot": dense(2, d), "init_embed": dense(3, d)}
    tree["context_embedding"] = {"project_context": dense(d + 1, d, use_bias=False)}
    del tree["project_fixed_context"]
    return tree


def pomo_pair(seed=0, jax_pointer_impl="xla", torch_pointer_impl="kernel", **dims):
    """The same seeded weights as (JAX POMO policy, its params, the port's on the CPU)."""
    dims = {**SMALL, **dims}
    tree = pomo_tree(seed, dims["embed_dim"], dims["num_encoder_layers"],
                     dims["feedforward_hidden"])
    jpol = jax_make_pomo_policy("cvrp", pointer_impl=jax_pointer_impl, **dims)
    tpol = make_pomo_policy("cvrp", pointer_impl=torch_pointer_impl, device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def random_cvrp(seed, b, n):
    """CVRP instances as numpy arrays: uniform locations and depot, integer
    demands 1..9 divided by the capacity of the table."""
    rs = np.random.RandomState(seed)
    return {
        "locs": rs.random_sample((b, n, 2)).astype(np.float32),
        "depot": rs.random_sample((b, 2)).astype(np.float32),
        "demand": (rs.randint(1, 10, size=(b, n)) / default_capacity(n)).astype(np.float32),
    }


def zoo_pair(policy, env_name="tsp", seed=0, **dims):
    """The same seeded weights (`random_params_numpy(policy=...)`) as (JAX
    policy of the zoo, its params, the port's policy on the CPU). ``dims``
    holds the policy's own arguments (``k``, ``num_experts``, ...) beside the
    small widths."""
    from rl4co_tpu.models.zoo.mvmoe import MVMoEPolicy as JaxMVMoE
    from rl4co_tpu.models.zoo.polynet import PolyNetPolicy as JaxPolyNet
    from rl4co_tpu.models.zoo.symnco import SymNCOPolicy as JaxSymNCO
    from rl4co_tpu_torch.models.zoo.mvmoe import MVMoEPolicy
    from rl4co_tpu_torch.models.zoo.polynet import PolyNetPolicy
    from rl4co_tpu_torch.models.zoo.symnco import SymNCOPolicy

    dims = {**SMALL, **dims}
    tree_keys = ("embed_dim", "num_encoder_layers", "feedforward_hidden", "normalization",
                 "use_graph_context", "num_experts", "k", "poly_layer_dim")
    tree = random_params_numpy(seed, policy=policy, env_name=env_name,
                               **{k: v for k, v in dims.items() if k in tree_keys})
    classes = {"symnco": (JaxSymNCO, SymNCOPolicy), "mvmoe": (JaxMVMoE, MVMoEPolicy),
               "polynet": (JaxPolyNet, PolyNetPolicy)}[policy]
    jpol = classes[0](env_name=env_name, **dims)
    tpol = classes[1](env_name=env_name, device="cpu", **dims)
    return jpol, tree_to_jax(tree), load_params(tpol, tree).eval()


def decode_logits_pair(jpol, jparams, tpol, env_name, inst, repeats, first=None):
    """Both packages' logits of one decode step on ``inst`` (numpy) with
    ``repeats`` queries per instance: step 0, or the step after the forced
    flat actions ``first``. Returns (JAX logits, the port's), numpy."""
    from rl4co_tpu.envs import get_env as jax_get_env
    from rl4co_tpu.utils.ops import batchify as jax_batchify
    from rl4co_tpu_torch.envs import get_env
    from rl4co_tpu_torch.utils.ops import batchify

    num_loc = next(iter(inst.values())).shape[1]
    jenv, tenv = jax_get_env(env_name, num_loc=num_loc), get_env(env_name, num_loc=num_loc)
    jinst = {k: jnp.asarray(v) for k, v in inst.items()}
    cache = jpol.apply(jparams, jpol.apply(jparams, jinst, method="encode"), method="precompute")
    state = jenv.reset_batch(jax_batchify(jinst, repeats))
    if first is not None:
        state = jenv.step_batch(state, jnp.asarray(first))
    want = jpol.apply(jparams, cache, state, jenv.action_mask_batch(state), repeats,
                      method="decode_step")
    tinst = {k: torch.from_numpy(v) for k, v in inst.items()}
    with torch.no_grad():
        tcache = tpol.precompute(tpol.encode(tinst))
        tstate = tenv.reset(batchify(tinst, repeats))
        if first is not None:
            tstate = tenv.step(tstate, torch.from_numpy(first))
        got = tpol.decode_step(tcache, tstate, tenv.action_mask(tstate), repeats)
    return np.asarray(want), t2n(got)
