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
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.models import AttentionModelPolicy as TorchPolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TSP50_FILE = os.path.join(ROOT, "data", "tsp", "test50_seed1234.npz")

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
