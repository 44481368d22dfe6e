"""The port's optimizer and schedule factories against `rl4co_tpu/utils/optim.py`
(optax). Both frameworks are handed the same numpy gradients for three steps,
so that the optimiser is tested apart from the gradients: an Adam update is
``lr · g/(|g| + eps)`` at step 1 and would amplify any gradient error.

Tolerances: parameters atol 1e-7 after three steps at lr 1e-4 (updates are of
the size of lr, f32 on both sides; 1e-6 where the update is composed in
another order on parameters of size 1, whose f32 spacing is 1.2e-7); schedules
rtol 5e-6 plus 1e-7 of the peak learning rate (optax evaluates them in f32, the
port in Python floats: a power of gamma carries f32 rounding, and the cosine's
``1 + cos`` cancels in f32 near its end)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rl4co_tpu.utils.optim import get_lr_schedule as jax_schedule
from rl4co_tpu.utils.optim import get_optimizer as jax_optimizer
from rl4co_tpu_torch.utils.optim import Optimizer, get_lr_schedule, get_optimizer

torch.set_num_threads(1)

SHAPES = {"a": (4, 3), "b": (3,), "c": (2, 2, 2)}


def shared_problem(scales, seed=0):
    """Parameters and one gradient set per step; ``scales`` sets each step's
    global gradient norm relative to the clip norm of 1."""
    rs = np.random.RandomState(seed)
    params = {k: rs.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for scale in scales:
        g = {k: rs.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
        grads.append({k: (x * scale / norm).astype(np.float32) for k, x in g.items()})
    return params, grads


def run_both(name, lr, grad_clip, scales, **kwargs):
    params, grads = shared_problem(scales)
    tx = jax_optimizer(name, lr, grad_clip=grad_clip, **kwargs)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = get_optimizer(tparams.values(), name, lr, grad_clip=grad_clip, **kwargs)
    assert isinstance(opt, Optimizer)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return tparams, jparams, params, opt


@pytest.mark.parametrize("scales", [(5.0, 3.0, 20.0), (0.3, 0.05, 0.7), (5.0, 0.5, 1.0)],
                         ids=["above-the-clip-norm", "below-the-clip-norm", "mixed"])
def test_adam_with_clipping_matches_optax(scales):
    tparams, jparams, start, opt = run_both("adam", 1e-4, 1.0, scales)
    for k in SHAPES:
        got = tparams[k].detach().numpy()
        assert np.abs(got - start[k]).max() > 1e-5  # it moved
        np.testing.assert_allclose(got, np.asarray(jparams[k]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(opt.grad_norm), scales[-1], rtol=1e-5)
    assert opt.count == 3


@pytest.mark.parametrize("name,kwargs,atol", [
    ("adam", {}, 1e-7),
    # decay applied to p before the Adam update (torch) or with it (optax)
    ("adamw", {}, 1e-6),                       # optax's default weight decay, 1e-4
    ("adamw", {"weight_decay": 0.01}, 1e-6),
    ("sgd", {}, 1e-7),
    ("sgd", {"momentum": 0.9}, 1e-7),
    # eps inside (optax) or outside (torch) the root: a relative 1e-7 here
    ("rmsprop", {}, 1e-6),
    ("adagrad", {}, 1e-6),
], ids=lambda v: str(v))
def test_optimizers_match_optax_without_clipping(name, kwargs, atol):
    tparams, jparams, _, opt = run_both(name, 1e-3, None, (2.0, 0.5, 1.0), **kwargs)
    assert opt.grad_norm is None
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=0, atol=atol)


def test_clipping_is_optax_form_not_torchs():
    """A gradient exactly at ten times the clip norm comes out with norm 1 to
    f32 rounding; `clip_grad_norm_`'s 1e-6 in the denominator would leave it
    1e-7 short, and a gradient below the clip norm is left untouched."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = get_optimizer([p], "sgd", 1.0, grad_clip=1.0)
    p.grad = torch.tensor([5.0, 5.0, 5.0, 5.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), -0.5 * np.ones(4), rtol=0, atol=1e-7)
    p.grad = torch.tensor([0.1, 0.0, 0.0, 0.0])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy()[0], -0.6, rtol=0, atol=1e-7)


STEPS = [0, 1, 4, 9, 10, 11, 19, 20, 25, 39, 40, 45, 99, 100, 109, 110, 500]


@pytest.mark.parametrize("kwargs", [
    dict(name="constant", learning_rate=3e-4),
    dict(name="constant", learning_rate=3e-4, warmup_steps=10),
    dict(name="multistep", learning_rate=1e-3, milestones=(2, 4), gamma=0.1, steps_per_epoch=10),
    dict(name="multistep", learning_rate=1e-3, milestones=(2, 4), gamma=0.1, steps_per_epoch=10,
         warmup_steps=10),
    dict(name="cosine", learning_rate=1e-3, total_steps=100),
    dict(name="cosine", learning_rate=1e-3, total_steps=100, warmup_steps=10, min_lr=1e-5),
    dict(name="exponential", learning_rate=1e-3, gamma=0.9, steps_per_epoch=10),
    dict(name="exponential", learning_rate=1e-3, gamma=0.9, steps_per_epoch=10, warmup_steps=10),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items() if k != "learning_rate"))
def test_schedules_match_optax(kwargs):
    js, ts = jax_schedule(**kwargs), get_lr_schedule(**kwargs)
    for step in STEPS:
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=5e-6,
                                   atol=1e-7 * kwargs["learning_rate"],
                                   err_msg=f"step {step}")


def test_a_schedule_drives_the_learning_rate_by_step_index():
    sched = get_lr_schedule("multistep", 1.0, milestones=(1,), gamma=0.1, steps_per_epoch=2)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = get_optimizer([p], "sgd", sched)
    seen = []
    for _ in range(4):
        p.grad = torch.ones(1)
        before = p.item()
        opt.step()
        seen.append(before - p.item())
    np.testing.assert_allclose(seen, [1.0, 1.0, 0.1, 0.1], atol=1e-6)
    # the step index survives a checkpoint
    opt2 = get_optimizer([p], "sgd", sched)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 4


def test_unknown_names_raise():
    p = [torch.nn.Parameter(torch.zeros(1))]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        get_optimizer(p, "nope")
    with pytest.raises(ValueError, match="Unknown schedule"):
        get_lr_schedule("nope")
    with pytest.raises(ValueError, match="total_steps"):
        get_lr_schedule("cosine", 1e-3)
