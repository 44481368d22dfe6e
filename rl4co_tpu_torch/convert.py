"""Weights carried across from the JAX package.

`convert_params` takes the JAX package's ``params`` tree as nested dicts of
numpy arrays (a restored checkpoint's ``["state"]["params"]``, or
``jax.device_get(params)`` with leaves turned into numpy; the caller does
that: nothing here imports JAX) and returns a ``state_dict`` for
`AttentionModelPolicy`, whose sub-modules carry the tree's names:

- a Flax ``Dense`` ``kernel [in, out]`` becomes ``nn.Linear.weight``
  ``[out, in]`` (transposed); ``bias`` and a norm's ``scale``/``bias`` go as
  they are;
- a vmapped MoE's stacked expert ``kernel [E, in, out]`` (3-D) keeps its
  name and layout: `StackedDense` uses it as ``x @ kernel``;
- ``pointer/project_out_kernel [D, D]`` (and its ``project_out_bias``) and
  an MoE's ``w_gate [in, E]`` are **not** transposed (used as ``x @ W``);
- ``context_embedding/W_placeholder`` is copied raw (the −1.0 is applied at
  use, in `TSPContext`);
- PtrNet's raw parameters ``v`` and ``decoder_input0`` go as they are; its
  Flax LSTM cells keep their tree's names (``enc_lstm/ii/kernel``, ...), which
  `models/zoo/ptrnet.py::LSTMCell` registers as ``nn.Linear``s;
- the multi-env policy's per-env embeddings keep their tree's names
  (``init_embeddings_op``, ``context_embeddings_pctsp``, ...), which
  `models/policies/multi_env.py` registers as they are.

`load_params` fills a policy and insists that every leaf is consumed and
every parameter set. `save_params_npz` / `load_params_npz` carry a tree
through a flat npz whose keys are the ``/``-joined paths, which is how the
trained checkpoints reach a machine without the JAX package
(`rl4co_tpu_torch/golden/*_params.npz`). `random_params_numpy` makes a tree of the same
structure from a numpy seed, so that tests, the golden file and the chip
smoke run share one set of weights without sharing a framework.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# leaves copied as they are, by their last path component
_RAW_LEAVES = ("bias", "scale", "project_out_kernel", "project_out_bias", "W_placeholder",
               "w_gate", "v", "decoder_input0")


def _flatten(tree: dict, prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def save_params_npz(tree: dict, path: str) -> None:
    """Write a nested dict of arrays as a flat npz, keys the ``/``-joined paths."""
    np.savez(path, **{"/".join(p): a for p, a in _flatten(tree).items()})


def load_params_npz(path: str) -> dict:
    """The nested tree back from a flat npz of `save_params_npz`: what
    `load_params` takes. Leaves are numpy arrays as stored."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            if leaf in node:
                raise ValueError(f"{path}: key {key} is stored twice")
            node[leaf] = data[key]
    return tree


def convert_params(tree: dict) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``state_dict`` (f32 CPU tensors).
    Accepts the tree with or without Flax's outer ``"params"`` key."""
    if set(tree.keys()) == {"params"} and isinstance(tree["params"], dict):
        tree = tree["params"]
    state = {}
    for path, arr in _flatten(tree).items():
        *parents, leaf = path
        if leaf == "kernel":
            if arr.ndim == 2:
                name, arr = ".".join(parents + ["weight"]), arr.T
            elif arr.ndim == 3:  # stacked experts [E, in, out]
                name = ".".join(path)
            else:
                raise ValueError(f"{'/'.join(path)}: a Dense kernel must be 2-D (or 3-D for "
                                 f"stacked experts), got shape {arr.shape}")
        elif leaf in _RAW_LEAVES:
            name = ".".join(path)
        else:
            raise ValueError(f"leaf {'/'.join(path)} has no counterpart in the port")
        state[name] = torch.tensor(np.asarray(arr, dtype=np.float32))  # a copy
    return state


def load_params(policy: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Fill ``policy`` from a JAX ``params`` tree. A leaf left over, a
    parameter not set, or a shape that differs raises with its path."""
    state = convert_params(tree)
    own = policy.state_dict()
    left_over = sorted(set(state) - set(own))
    if left_over:
        raise ValueError(f"leaves with no parameter in the policy: {left_over}")
    unset = sorted(set(own) - set(state))
    if unset:
        raise ValueError(f"parameters of the policy not set by the tree: {unset}")
    for name, t in state.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: tree has shape {tuple(t.shape)}, "
                             f"the policy {tuple(own[name].shape)}")
    policy.load_state_dict(state, strict=True)
    return policy


_TREE_POLICIES = ("am", "symnco", "mvmoe", "polynet", "ptrnet", "multienv", "multienv_moe")
_TREE_ENVS = ("tsp", "cvrp", "op", "pctsp", "spctsp")


def random_params_numpy(
    seed: int,
    embed_dim: int = 128,
    num_encoder_layers: int = 3,
    feedforward_hidden: int = 512,
    normalization: str = "batch",
    policy: str = "am",
    env_name: str = "tsp",
    use_graph_context: bool = True,
    num_experts: int = 4,
    k: int = 64,
    poly_layer_dim: int = 256,
    hidden_dim: int = 128,
    env_names: tuple = ("op", "pctsp"),
) -> dict:
    """A ``params`` tree (without the outer ``"params"`` key) of ``policy``
    (``"am"``, ``"symnco"``, ``"mvmoe"`` or ``"polynet"`` on ``env_name``,
    one of ``tsp``, ``cvrp``, ``op``, ``pctsp`` and ``spctsp``;
    ``"multienv"`` or ``"multienv_moe"`` over ``env_names``; ``"ptrnet"``
    with ``embed_dim`` and ``hidden_dim``; ``num_experts`` for the MoE
    trees, ``k`` and ``poly_layer_dim`` for PolyNet), drawn from
    ``np.random.RandomState(seed)``: kernels normal scaled by
    ``1/sqrt(fan_in)``, biases and MoE gates normal·0.1, norm scales
    1 + normal·0.1, ``W_placeholder`` uniform in [0, 2), PtrNet's ``v`` and
    ``decoder_input0`` uniform in [0, 0.2). The draw order is fixed (the
    golden file depends on that of AM on TSP)."""
    multi = policy in ("multienv", "multienv_moe")
    envs = tuple(env_names) if multi else (env_name,)
    if policy not in _TREE_POLICIES or any(e not in _TREE_ENVS for e in envs):
        raise ValueError(f"no tree for policy={policy!r} on {envs}")
    rs = np.random.RandomState(seed)
    d, f = embed_dim, feedforward_hidden

    def kernel(fan_in, fan_out):
        return (rs.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in)).astype(np.float32)

    def bias(n):
        return (0.1 * rs.standard_normal(n)).astype(np.float32)

    def dense(fan_in, fan_out, use_bias=True):
        out = {"kernel": kernel(fan_in, fan_out)}
        if use_bias:
            out["bias"] = bias(fan_out)
        return out

    if policy == "ptrnet":
        h = hidden_dim

        def lstm(fan_in):  # Flax's cell: input kernels without bias, hidden ones with
            cell = {f"i{g}": {"kernel": kernel(fan_in, h)} for g in "ifgo"}
            cell.update({f"h{g}": dense(h, h) for g in "ifgo"})
            return cell

        return {"embed": dense(2, d), "enc_lstm": lstm(d), "dec_lstm": lstm(d),
                "W_q": dense(h, h, use_bias=False), "W_ref": dense(h, h, use_bias=False),
                "v": (0.2 * rs.random_sample(h)).astype(np.float32),
                "decoder_input0": (0.2 * rs.random_sample(d)).astype(np.float32)}

    def norm():
        if normalization in (None, "none", "layer"):
            return None
        out = {"scale": (1.0 + 0.1 * rs.standard_normal(d)).astype(np.float32)}
        if normalization in ("batch", "instance"):
            out["bias"] = bias(d)
        return out

    def moe(fan_in, fan_out, hidden=()):
        dims = [fan_in, *hidden, fan_out]
        experts = {f"Dense_{i}": {
            "kernel": np.stack([kernel(dims[i], dims[i + 1]) for _ in range(num_experts)]),
            "bias": np.stack([bias(dims[i + 1]) for _ in range(num_experts)])}
            for i in range(len(dims) - 1)}
        return {"w_gate": (0.1 * rs.standard_normal((fan_in, num_experts))).astype(np.float32),
                "experts": experts}

    def init_embedding(env):
        if env == "tsp":
            return {"init_embed": dense(2, d)}
        features = {"cvrp": 3, "op": 3, "pctsp": 4, "spctsp": 4}[env]
        return {"init_embed_depot": dense(2, d), "init_embed": dense(features, d)}

    def context_embedding(env):
        if env == "tsp":
            return {"W_placeholder": (2.0 * rs.random_sample(2 * d)).astype(np.float32),
                    "project_context": dense(2 * d, d, use_bias=False)}
        return {"project_context": dense(d + 1, d, use_bias=False)}

    moe_trunk = policy in ("mvmoe", "multienv_moe")
    if multi:
        tree = {f"init_embeddings_{e}": init_embedding(e) for e in envs}
    else:
        tree = {"init_embedding": init_embedding(env_name)}
    layers = {}
    for i in range(num_encoder_layers):
        layer = {"mha": {"Wqkv": dense(d, 3 * d), "out_proj": dense(d, d)}}
        if moe_trunk:
            layer["moe_ffn"] = moe(d, d, (f,))
        else:
            layer["ffn"] = {"Dense_0": dense(d, f), "Dense_1": dense(f, d)}
        for name in ("norm1", "norm2"):
            p = norm()
            if p is not None:
                layer[name] = p
        layers[f"layer_{i}"] = layer
    if moe_trunk:  # the layers sit at the top, named moe_layer_{i}
        tree.update({f"moe_{name}": layer for name, layer in layers.items()})
    else:
        tree["encoder_net"] = layers
    tree["project_node_embeddings"] = dense(d, 3 * d, use_bias=False)
    if use_graph_context:
        tree["project_fixed_context"] = dense(d, d, use_bias=False)
    if multi:
        tree.update({f"context_embeddings_{e}": context_embedding(e) for e in envs})
    else:
        tree["context_embedding"] = context_embedding(env_name)
    if moe_trunk:
        tree["pointer"] = {"project_out_moe": moe(d, d)}
    elif policy == "polynet":
        bits = max(1, int(np.ceil(np.log2(k))))
        tree["pointer"] = {"poly_layer_1": dense(d + bits, poly_layer_dim),
                           "poly_layer_2": dense(poly_layer_dim, d),
                           "project_out": dense(d, d, use_bias=False)}
    else:
        tree["pointer"] = {"project_out_kernel": kernel(d, d)}
    if policy == "symnco":
        tree["projection_head"] = {"layers_0": dense(d, d), "layers_2": dense(d, d)}
    return tree
