"""The port's Mixture-of-Experts (`models/nn/moe.py`) against
`rl4co_tpu/models/nn/moe.py` on the same numpy-seeded weights: the mixed
output, its gradients, threshold gating with ties (every expert kept at the
zero-initialised gate) and the load-balancing value the JAX module sows into
``losses``. Tolerances: outputs atol 1e-5, aux rtol 1e-5 (f32 on both
sides), gradients rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.models.nn.moe import MoE as JaxMoE
from rl4co_tpu_torch.convert import convert_params
from rl4co_tpu_torch.models.nn.moe import MoE

from _torch_port import t2n, tree_to_numpy

torch.set_num_threads(1)

D, OUT, E, T = 12, 10, 4, 15


def moe_tree(rs, hidden, w_gate):
    dims = [D, *hidden, OUT]
    experts = {f"Dense_{i}": {
        "kernel": (rs.standard_normal((E, dims[i], dims[i + 1])) / np.sqrt(dims[i])
                   ).astype(np.float32),
        "bias": (0.1 * rs.standard_normal((E, dims[i + 1]))).astype(np.float32)}
        for i in range(len(dims) - 1)}
    return {"w_gate": w_gate.astype(np.float32), "experts": experts}


def pair(hidden=(16,), w_gate=None, seed=0, k=2):
    rs = np.random.RandomState(seed)
    if w_gate is None:
        w_gate = rs.standard_normal((D, E))
    tree = moe_tree(rs, hidden, np.asarray(w_gate))
    x = rs.standard_normal((3, T // 3, D)).astype(np.float32)
    module = MoE(D, OUT, hidden, num_experts=E, k=k)
    module.load_state_dict(convert_params(tree))
    jmoe = JaxMoE(OUT, hidden, num_experts=E, k=k)
    return jmoe, tree, module, x


def jax_apply(jmoe, tree, x):
    out, state = jmoe.apply({"params": tree}, jnp.asarray(x), mutable=["losses"])
    return np.asarray(out), float(state["losses"]["moe_aux"][0])


@pytest.mark.parametrize("hidden", [(), (16,)], ids=["projection", "ffn"])
def test_moe_output_and_aux_match_jax(hidden):
    jmoe, tree, module, x = pair(hidden)
    want, want_aux = jax_apply(jmoe, tree, x)
    got = module(torch.from_numpy(x))
    assert got.shape == want.shape == (3, T // 3, OUT)
    np.testing.assert_allclose(t2n(got), want, atol=1e-5)
    gates = module.gates(torch.from_numpy(x).reshape(-1, D))
    assert ((gates > 0).sum(-1) == 2).all()  # random gates: the top 2 exactly
    np.testing.assert_allclose(module.aux_loss(gates).item(), want_aux, rtol=1e-5)
    assert want_aux > 0


def test_zero_gate_keeps_every_expert_tied():
    """At its zero initialisation every expert ties with the k-th and is kept,
    at weight 1/E: the output is the experts' mean, the aux value 0."""
    jmoe, tree, module, x = pair(w_gate=np.zeros((D, E)))
    want, want_aux = jax_apply(jmoe, tree, x)
    flat = torch.from_numpy(x).reshape(-1, D)
    gates = module.gates(flat)
    assert torch.equal(gates, torch.full((T, E), 1.0 / E))
    np.testing.assert_allclose(t2n(module(torch.from_numpy(x))), want, atol=1e-5)
    mean = module.experts(flat).mean(dim=0).reshape(want.shape)
    np.testing.assert_allclose(t2n(mean), want, atol=1e-5)
    assert module.aux_loss(gates).item() == want_aux == 0.0


def test_ties_with_the_kth_logit_are_kept():
    """Logits (2, 1, 1, 0) with k 2: the experts tied at the 2nd are both kept."""
    w_gate = np.zeros((D, E))
    jmoe, tree, module, _ = pair(w_gate=w_gate)
    x = np.zeros((1, 2, D), np.float32)
    x[..., 0] = 1.0
    tree["w_gate"][0] = [2.0, 1.0, 1.0, 0.0]
    module.load_state_dict(convert_params(tree))
    want, want_aux = jax_apply(jmoe, tree, x)
    gates = module.gates(torch.from_numpy(x).reshape(-1, D))
    assert ((gates > 0).sum(-1) == 3).all() and (gates[:, 3] == 0).all()
    np.testing.assert_allclose(t2n(module(torch.from_numpy(x))), want, atol=1e-5)
    np.testing.assert_allclose(module.aux_loss(gates).item(), want_aux, rtol=1e-5)


def test_moe_gradients_match_jax():
    jmoe, tree, module, x = pair()
    cot = np.random.RandomState(3).standard_normal((3, T // 3, OUT)).astype(np.float32)

    def f(params):
        return jnp.sum(jmoe.apply({"params": params}, jnp.asarray(x)) * cot)

    jgrads = convert_params(tree_to_numpy(jax.grad(f)(jax.tree_util.tree_map(jnp.asarray, tree))))
    (module(torch.from_numpy(x)) * torch.from_numpy(cot)).sum().backward()
    for name, p in module.named_parameters():
        np.testing.assert_allclose(t2n(p.grad), jgrads[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    assert set(dict(module.named_parameters())) == set(jgrads)
