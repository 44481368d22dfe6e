"""``lamb``, ``lion`` and ``adafactor`` in the port (`rl4co_tpu_torch/utils/optim.py`)
against optax (`rl4co_tpu/utils/optim.py`) over three steps, on a 128 × 160
matrix (Adafactor factors it), an 8 × 130 one (it does not: 8 < 128) and two
vectors: the parameters within rtol 1e-6. An element that crosses zero is
held within atol 1e-8 (1e-6 of the learning rate): LAMB's trust ratio and
Adafactor's RMS are sums over 20 480 elements, which XLA and PyTorch add in
different orders."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl4co_tpu.utils.optim import get_optimizer as jax_get_optimizer
from rl4co_tpu_torch.utils.optim import get_optimizer

torch.set_num_threads(1)

SHAPES = {"w": (128, 160), "v": (160,), "m": (8, 130), "s": (3,)}
LR = 1e-2


@pytest.mark.parametrize("name", ["lamb", "lion", "adafactor"])
@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_three_steps_are_optax_steps(name, grad_clip):
    rs = np.random.RandomState(0)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rs.randn(*s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    tx = jax_get_optimizer(name, LR, grad_clip=grad_clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = get_optimizer(tparams.values(), name, LR, grad_clip=grad_clip)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


def test_adafactor_factors_only_large_matrices():
    p = {k: torch.nn.Parameter(torch.ones(s)) for k, s in SHAPES.items()}
    opt = get_optimizer(p.values(), "adafactor", LR)
    for q in p.values():
        q.grad = torch.ones_like(q)
    opt.step()
    state = opt.inner.state
    assert state[p["w"]]["v_row"].shape == (128,) and state[p["w"]]["v_col"].shape == (160,)
    assert "v" in state[p["m"]] and state[p["m"]]["v"].shape == (8, 130)
