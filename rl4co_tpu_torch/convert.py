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
  use, in `TSPContext`), and so is mPDP's ``init_embedding/depot_copy_offset``;
- a Flax ``GRUCell`` (NeuOpt's ``decoder/rnn1``, ``rnn2``) becomes the
  stacked rows of `torch.nn.GRUCell` (`_pack_gru_cells`); NeuOpt's raw
  ``linear_V1``, ``linear_V2`` and ``init_query`` go as they are;
- the improvement policies (`models/zoo/{dact,n2s,neuopt}.py`) and their
  `ImprovementCritic` register every sub-module under the Flax tree's name,
  its MLPs' layers as ``Dense_{i}``; EAS-Lay's layer goes through
  `convert_eas_params`;
- PtrNet's raw parameters ``v`` and ``decoder_input0`` go as they are; its
  Flax LSTM cells keep their tree's names (``enc_lstm/ii/kernel``, ...), which
  `models/zoo/ptrnet.py::LSTMCell` registers as ``nn.Linear``s;
- the multi-env policy's per-env embeddings keep their tree's names
  (``init_embeddings_op``, ``context_embeddings_pctsp``, ...), which
  `models/policies/multi_env.py` registers as they are;
- MatNet's mixer parameters (``mix_W1``, ``mix_b1``, ``mix_W2``, ``mix_b2``)
  go as they are stored, the uniform draw (the forward shifts them), and so
  do MatNet-FFSP's ``no_job_emb`` and ``stage_emb`` and L2D-attention's
  ``dummy``;
- the NAR encoders (`models/zoo/nargnn.py`, `gfacs.py`) register their
  embeddings under Flax's automatic names (``TSPInitEmbedding_0``,
  ``VRPEdgeEmbedding_0``, ...) and the rest under the tree's names.

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
               "w_gate", "v", "decoder_input0", "depot_copy_offset", "linear_V1", "linear_V2",
               "init_query", "weight_ih", "weight_hh", "bias_ih", "bias_hh",
               "mix_W1", "mix_b1", "mix_W2", "mix_b2", "no_job_emb", "stage_emb", "dummy")
# a Flax GRUCell's sub-modules, in the order of torch.nn.GRUCell's stacked rows
_GRU_INPUT, _GRU_HIDDEN = ("ir", "iz", "in"), ("hr", "hz", "hn")


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


def _pack_gru_cells(tree: dict) -> dict:
    """Every Flax ``GRUCell`` subtree (``ir, iz, in`` with biases, ``hr, hz``
    without, ``hn`` with) as `torch.nn.GRUCell`'s stacked ``r, z, n`` rows:
    ``weight_ih [3D, in]``, ``weight_hh [3D, D]``, ``bias_ih``, and
    ``bias_hh`` zero in its r and z rows."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) and set(val) == set(_GRU_INPUT + _GRU_HIDDEN):
            hn_bias = np.asarray(val["hn"]["bias"], dtype=np.float32)
            zeros = np.zeros_like(hn_bias)
            val = {
                "weight_ih": np.concatenate([np.asarray(val[g]["kernel"]).T for g in _GRU_INPUT]),
                "weight_hh": np.concatenate([np.asarray(val[g]["kernel"]).T
                                             for g in _GRU_HIDDEN]),
                "bias_ih": np.concatenate([np.asarray(val[g]["bias"]) for g in _GRU_INPUT]),
                "bias_hh": np.concatenate([zeros, zeros, hn_bias]),
            }
            if any(set(tree[key][g]) != {"kernel"} for g in ("hr", "hz")):
                raise ValueError(f"{key}: a GRUCell's hr and hz carry no bias in Flax")
        elif isinstance(val, dict):
            val = _pack_gru_cells(val)
        out[key] = val
    return out


def convert_eas_params(tree: dict) -> Dict[str, torch.Tensor]:
    """EAS-Lay's layer (``w1 [D, H]``, ``b1``, ``w2 [H, D]``, ``b2``, used as
    ``x @ w``: nothing is transposed) as f32 tensors, what
    `models/zoo/eas.py::EASLay.init_state` takes as ``eas_init``."""
    if set(tree) != {"w1", "b1", "w2", "b2"}:
        raise ValueError(f"an EAS-Lay tree has w1, b1, w2, b2; got {sorted(tree)}")
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in tree.items()}


def convert_params(tree: dict) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> ``state_dict`` (f32 CPU tensors).
    Accepts the tree with or without Flax's outer ``"params"`` key."""
    if set(tree.keys()) == {"params"} and isinstance(tree["params"], dict):
        tree = tree["params"]
    tree = _pack_gru_cells(tree)
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


_TREE_POLICIES = ("am", "symnco", "mvmoe", "polynet", "ptrnet", "multienv", "multienv_moe",
                  "nargnn", "gfacs", "critic")


def _check_env(env_name: str) -> None:
    """Raise ValueError for an env that is in neither package."""
    from rl4co_tpu_torch.envs import ENV_REGISTRY

    if env_name not in ENV_REGISTRY:
        raise ValueError(f"no env '{env_name}' in the JAX package or the port")


def _zoo_policy(policy: str, kwargs: dict) -> torch.nn.Module:
    """The port's policy ``policy`` of the rest of the zoo, built on the meta
    device (shapes only, no draw from torch's stream)."""
    import importlib

    module, cls = _MODULE_TREES[policy]
    make = getattr(importlib.import_module(f"rl4co_tpu_torch.models.zoo.{module}"), cls)
    with torch.device("meta"):
        return make(**{**kwargs, "device": "meta"})


# the rest of the zoo: tree name -> (zoo module, class); their trees are drawn
# from the port's module (`_module_tree`), whose sub-modules carry the Flax names
_MODULE_TREES = {
    "matnet": ("matnet", "MatNetPolicy"),
    "matnet_ffsp": ("matnet_ffsp", "MatNetFFSPPolicy"),
    "mdam": ("mdam", "MDAMPolicy"),
    "ham": ("ham", "HAMPolicy"),
    "l2d": ("l2d", "L2DPolicy"),
    "l2d_attn": ("l2d", "L2DAttnPolicy"),
}
# raw parameters of those trees, drawn uniform in [0, high) as Flax draws them
_UNIFORM_LEAVES = {"W_placeholder": 2.0, "no_job_emb": 1.0, "stage_emb": 1.0, "dummy": 1.0,
                   "mix_W1": 2 * 0.5 ** 0.5, "mix_b1": 2 * 0.5 ** 0.5,
                   "mix_W2": 2 * 0.25, "mix_b2": 2 * 0.25}


def _module_tree(module: torch.nn.Module, rs: np.random.RandomState) -> dict:
    """The Flax tree of a port module whose names are the Flax ones, drawn
    from ``rs`` in the module's registration order: an ``nn.Linear``'s
    weight as ``kernel [in, out]`` normal over sqrt(fan in), biases
    normal·0.1, a norm's scale 1 + normal·0.1, the pointer's output kernel
    like a kernel, the raw parameters of `_UNIFORM_LEAVES` uniform."""
    tree: dict = {}
    owners = dict(module.named_modules())
    for name, p in module.named_parameters():
        *parents, leaf = name.split(".")
        owner = owners[".".join(parents)]
        shape = tuple(p.shape)
        if isinstance(owner, torch.nn.Linear) and leaf == "weight":
            fan_in, fan_out = shape[1], shape[0]
            leaf, value = "kernel", rs.standard_normal((fan_in, fan_out)) / np.sqrt(fan_in)
        elif leaf == "project_out_kernel":
            value = rs.standard_normal(shape) / np.sqrt(shape[0])
        elif leaf == "scale":
            value = 1.0 + 0.1 * rs.standard_normal(shape)
        elif leaf in ("bias", "project_out_bias"):
            value = 0.1 * rs.standard_normal(shape)
        elif leaf in _UNIFORM_LEAVES:
            value = _UNIFORM_LEAVES[leaf] * rs.random_sample(shape)
        else:
            raise ValueError(f"no draw rule for parameter {name} of {type(module).__name__}")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(value, dtype=np.float32)
    return tree


def _embedding_module(kind: str, env_name: str, embed_dim: int, **kwargs) -> torch.nn.Module:
    """The port's ``kind`` (init, context or dynamic) embedding of
    ``env_name`` with the module's ``kwargs`` (``use_bias``,
    ``vehicle_capacity``, ...), built on the meta device: its shapes alone,
    no draw from torch's random stream."""
    from rl4co_tpu_torch.models.nn import env_embeddings as emb

    make = {"init": emb.env_init_embedding, "context": emb.env_context_embedding,
            "dynamic": emb.env_dynamic_embedding}[kind]
    with torch.device("meta"):
        return make(env_name, embed_dim, **kwargs)


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
    gnn_layers: int = 15,
    heatmap_layers: int = 5,
    z_out_dim: int = 1,
    critic_hidden_dim: int = 256,
    init_embedding_kwargs: dict | None = None,
    context_embedding_kwargs: dict | None = None,
    policy_kwargs: dict | None = None,
) -> dict:
    """A ``params`` tree (without the outer ``"params"`` key) of ``policy``
    (``"am"``, ``"symnco"``, ``"mvmoe"`` or ``"polynet"`` on ``env_name``,
    any env of the port's registry: its init, context and dynamic
    embeddings are read from the port's modules, which carry the Flax
    names; an env in neither package raises `ValueError`;
    ``"multienv"`` or ``"multienv_moe"`` over ``env_names``; ``"ptrnet"``
    with ``embed_dim`` and ``hidden_dim``; ``"nargnn"`` (DeepACO's encoder)
    and ``"gfacs"`` (with its logZ head of ``z_out_dim``) with
    ``gnn_layers`` and ``heatmap_layers``; ``"critic"`` (PPO's and A2C's
    `CriticNetwork` on ``env_name``, its value head ``critic_hidden_dim``
    wide); ``num_experts`` for the MoE
    trees, ``k`` and ``poly_layer_dim`` for PolyNet;
    ``init_embedding_kwargs`` / ``context_embedding_kwargs`` as the policy
    takes them: ``use_bias=False`` gives an init embedding without bias
    leaves), drawn from
    ``np.random.RandomState(seed)``: kernels normal scaled by
    ``1/sqrt(fan_in)``, biases and MoE gates normal·0.1, norm scales
    1 + normal·0.1, ``W_placeholder`` uniform in [0, 2), mPDP's
    ``depot_copy_offset`` normal·0.02, PtrNet's ``v`` and
    ``decoder_input0`` uniform in [0, 0.2). The draw order is fixed (the
    golden files depend on it), an embedding's by its module's registration
    order, a dynamic embedding's last.

    The rest of the zoo, ``"matnet"``, ``"matnet_ffsp"``, ``"mdam"``,
    ``"ham"``, ``"l2d"`` (with its critic when ``policy_kwargs`` say
    ``with_critic=True``) and ``"l2d_attn"``, is drawn from the port's policy
    built with ``policy_kwargs`` (its own defaults otherwise; the other
    arguments are not read), in its registration order (`_module_tree`):
    the mixers' parameters uniform in [0, 2·init), the learned embeddings
    (``no_job_emb``, ``stage_emb``, ``dummy``) in [0, 1)."""
    if policy in _MODULE_TREES:
        return _module_tree(_zoo_policy(policy, policy_kwargs or {}), np.random.RandomState(seed))
    multi = policy in ("multienv", "multienv_moe")
    envs = tuple(env_names) if multi else (env_name,)
    if policy not in _TREE_POLICIES:
        raise ValueError(f"no tree for policy={policy!r}")
    if policy != "ptrnet":
        for e in envs:
            _check_env(e)
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

    def module_tree(module):
        """The tree of one of the port's embedding modules, whose names are
        the Flax module's: its own parameters first (TSP's ``W_placeholder``,
        mPDP's ``depot_copy_offset``), then each ``nn.Linear`` child, in the
        order they were registered."""
        tree = {}
        for name, p in module.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if name == "W_placeholder":
                tree[name] = (2.0 * rs.random_sample(shape)).astype(np.float32)
            elif name == "depot_copy_offset":
                tree[name] = (0.02 * rs.standard_normal(shape)).astype(np.float32)
            else:
                raise ValueError(f"no draw rule for parameter {name} of {type(module).__name__}")
        for name, child in module.named_children():
            if not isinstance(child, torch.nn.Linear):
                raise ValueError(f"no draw rule for {name} of {type(module).__name__}")
            tree[name] = dense(child.in_features, child.out_features, child.bias is not None)
        return tree

    def init_embedding(env):
        return module_tree(_embedding_module("init", env, d, **(init_embedding_kwargs or {})))

    def context_embedding(env):
        return module_tree(_embedding_module("context", env, d,
                                             **(context_embedding_kwargs or {})))

    if policy in ("nargnn", "gfacs"):
        from rl4co_tpu_torch.models.nn.env_embeddings.edge import EDGE_EMBEDDING_REGISTRY
        from rl4co_tpu_torch.models.nn.env_embeddings.init import INIT_EMBEDDING_REGISTRY

        def batch_norm():
            return {"scale": (1.0 + 0.1 * rs.standard_normal(d)).astype(np.float32),
                    "bias": bias(d)}

        # the embeddings under Flax's automatic names, from their classes
        tree = {f"{INIT_EMBEDDING_REGISTRY[env_name].__name__}_0": init_embedding(env_name),
                f"{EDGE_EMBEDDING_REGISTRY[env_name].__name__}_0": {"edge_embed": dense(1, d)}}
        layers = {}
        for i in range(gnn_layers):
            layers[f"layer_{i}"] = {n: dense(d, d) for n in
                                    ("v_lin1", "v_lin2", "v_lin3", "v_lin4", "e_lin")}
            layers[f"layer_{i}"].update(v_bn=batch_norm(), e_bn=batch_norm())
        tree["graph_network"] = layers
        tree["heatmap_generator"] = {f"lin_{i}": dense(d, d) for i in range(heatmap_layers - 1)}
        tree["heatmap_generator"]["output"] = dense(d, 1)
        if policy == "gfacs":
            tree["z_net_0"], tree["z_net_1"] = dense(d, d), dense(d, z_out_dim)
        return tree

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
    if policy == "critic":  # Flax's automatic names
        init_name = f"{type(_embedding_module('init', env_name, d)).__name__}_0"
        return {init_name: tree["init_embedding"], "GraphAttentionNetwork_0": layers,
                "Dense_0": dense(d, critic_hidden_dim), "Dense_1": dense(critic_hidden_dim, 1)}
    if moe_trunk:  # the layers sit at the top, named moe_layer_{i}
        tree.update({f"moe_{name}": layer for name, layer in layers.items()})
    else:
        tree["encoder_net"] = layers
    tree["project_node_embeddings"] = dense(d, 3 * d, use_bias=False)
    if use_graph_context:
        tree["project_fixed_context"] = dense(d, d, use_bias=False)
    # a context without parameters (DPP's) has no subtree, as in Flax
    if multi:
        tree.update({f"context_embeddings_{e}": ctx for e in envs
                     if (ctx := context_embedding(e))})
    elif ctx := context_embedding(env_name):
        tree["context_embedding"] = ctx
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
    for e in envs:  # SDVRP's `projection`; the static embedding has no leaf
        dynamic = module_tree(_embedding_module("dynamic", e, d))
        if dynamic:
            tree["dynamic_embedding"] = dynamic
    return tree
