"""Reptile in the port (`rl4co_tpu_torch/meta.py`) against the JAX package's
(`rl4co_tpu/meta.py`): the task sequence of ``random.Random(seed)``, the
decay of β and the outer update on converted parameters (equal to the bit),
and a two-epoch run whose meta-weights move by exactly β (θ_task − θ_meta)
from each task's trained weights, each task trained from the meta-weights
by an algorithm of its own."""

import numpy as np
import pytest
import torch

from rl4co_tpu.meta import Reptile as JaxReptile
from rl4co_tpu.meta import ReptileConfig as JaxReptileConfig
from rl4co_tpu_torch.convert import convert_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.meta import Reptile, ReptileConfig
from rl4co_tpu_torch.models import AttentionModelPolicy
from rl4co_tpu_torch.rl.reinforce import REINFORCE

from _torch_port import tree_to_jax

torch.set_num_threads(1)

TASKS = ({"num_loc": 5}, {"num_loc": 6}, {"num_loc": 7})


@pytest.mark.parametrize("seed", [0, 3])
def test_task_sequence_and_beta_are_the_jax_ones(seed):
    port = Reptile(None, ReptileConfig(tasks=TASKS, seed=seed))
    ref = JaxReptile(None, JaxReptileConfig(tasks=TASKS, seed=seed))
    assert [port.sample_task() for _ in range(12)] == [ref.sample_task() for _ in range(12)]
    for decay in (True, False):
        p = Reptile(None, ReptileConfig(meta_beta=0.7, beta_decay=decay))
        r = JaxReptile(None, JaxReptileConfig(meta_beta=0.7, beta_decay=decay))
        assert [p.beta_at(e, 5) for e in range(6)] == [r.beta_at(e, 5) for e in range(6)]


def test_outer_update_is_the_jax_one_on_converted_parameters():
    dims = (16, 1, 32)
    meta, task = random_params_numpy(0, *dims), random_params_numpy(1, *dims)
    want = convert_params(JaxReptile(None, JaxReptileConfig()).outer_update(
        tree_to_jax(meta), tree_to_jax(task), 0.3))
    got = Reptile(None, ReptileConfig()).outer_update(convert_params(meta),
                                                      convert_params(task), 0.3)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_two_epochs_move_the_meta_weights_by_beta_toward_each_task():
    built, updates = [], []

    def make_algo(task):
        policy = AttentionModelPolicy(env_name="tsp", embed_dim=16, num_heads=2,
                                      num_encoder_layers=1, feedforward_hidden=32, device="cpu")
        algo = REINFORCE(get_env("tsp", **task), policy, baseline="mean",
                         train_spec=DecodeSpec(kind="sampling", tanh_clipping=10.0), lr=1e-2)
        built.append((task, algo))
        return algo

    class Recorded(Reptile):
        def outer_update(self, meta, task_params, beta):
            out = super().outer_update(meta, task_params, beta)
            updates.append((meta, task_params, beta, out))
            return out

    torch.manual_seed(0)
    reptile = Recorded(make_algo, ReptileConfig(tasks=TASKS, seed=0))
    final = reptile.run(epochs=2, steps_per_task=2, batch_size=4, logger=lambda m: None)
    ref = JaxReptile(None, JaxReptileConfig(tasks=TASKS, seed=0))
    assert [t for t, _ in built] == [ref.sample_task() for _ in range(3)]
    assert [b for _, _, b, _ in updates] == [1.0, 0.5]
    first_meta = dict(built[0][1].policy.named_parameters())
    for epoch, (meta, task_params, beta, out) in enumerate(updates):
        trained = dict(built[epoch + 1][1].policy.named_parameters())
        for k, m in meta.items():
            assert torch.equal(task_params[k], trained[k].detach())
            assert torch.equal(out[k], m + beta * (task_params[k] - m))
        if epoch == 0:
            assert all(torch.equal(meta[k], first_meta[k].detach()) for k in meta)
            assert any(not torch.equal(task_params[k], meta[k]) for k in meta)
        else:
            assert all(torch.equal(meta[k], updates[0][3][k]) for k in meta)
    assert all(torch.equal(final[k], updates[-1][3][k]) for k in final)
