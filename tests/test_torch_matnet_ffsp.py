"""MatNet on FFSP in the port against the JAX package
(`rl4co_tpu/models/zoo/matnet_ffsp.py`), and the golden file of the chip
phase.

- The policy's tree has the JAX module's structure (the pointer's output
  bias among it); the encoder's job and machine embeddings atol 2e-4 (its
  first instance norm meets nearly equal rows).
- Greedy rollouts on FFSP: actions equal, makespans equal.

`python tests/test_torch_matnet_ffsp.py` rewrites
`rl4co_tpu_torch/golden/matnet_ffsp20.npz` (the MatNet paper's FFSP20: 3
stages of 4 machines, 20 jobs, run times 2-9; the policy at 256 wide, 16
heads, 3 layers, FFN 512 with seeded weights; 256 instances from
`jax.random` with the JAX CPU greedy makespans and actions); no collected
test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models import rollout as jax_rollout  # noqa: E402
from rl4co_tpu.models.policies.constructive import init_policy_params  # noqa: E402
from rl4co_tpu.models.zoo.matnet_ffsp import MatNetFFSPPolicy as JaxPolicy  # noqa: E402
from rl4co_tpu_torch.convert import random_params_numpy  # noqa: E402
from rl4co_tpu_torch.decoding import DecodeSpec  # noqa: E402
from rl4co_tpu_torch.envs import get_env  # noqa: E402
from rl4co_tpu_torch.models import rollout  # noqa: E402
from rl4co_tpu_torch.models.zoo.matnet_ffsp import MatNetFFSPPolicy  # noqa: E402

from _torch_port import (  # noqa: E402
    KEY,
    jax_instances,
    t2n,
    to_jax,
    to_torch,
    tree_to_jax,
    zoo_tree_pair,
)

torch.set_num_threads(1)

ENV = dict(num_stage=2, num_machine=3, num_job=5)
SMALL = dict(num_stage=2, num_machine=3, embed_dim=32, num_heads=4, num_encoder_layers=2,
             feedforward_hidden=64)
B = 4
GOLDEN = os.path.join(os.path.dirname(_HERE), "rl4co_tpu_torch", "golden",
                      "matnet_ffsp20.npz")


def test_tree_structure_encoder_and_greedy_makespans_match_jax():
    jpol, jparams, tpol = zoo_tree_pair("matnet_ffsp", JaxPolicy, MatNetFFSPPolicy, 0, **SMALL)
    jenv = jax_get_env("ffsp", **ENV)
    shapes = jax.eval_shape(lambda k: init_policy_params(jpol, jenv, k), KEY)
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jparams)
    assert "project_out_bias" in jparams["params"]["pointer"]
    inst = jax_instances(jenv, 1, B)
    want = jpol.apply(jparams, to_jax(inst), method="encode")
    with torch.no_grad():
        got = tpol.encode(to_torch(inst))
    # the first layer's rows start at zero, so their attention depends on the
    # run times alone and the rows come out nearly equal: the instance norm
    # over them divides f32 noise by a small spread (1e-5 holds per layer at
    # ATSP's inputs, `test_torch_matnet.py`)
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), np.asarray(w), atol=2e-4)
    for seed in (1, 2):
        inst = jax_instances(jenv, seed, B)
        want = jax_rollout(jpol, jparams, jenv, to_jax(inst), KEY, JaxSpec(kind="greedy"))
        with torch.no_grad():
            got = rollout(tpol, get_env("ffsp", **ENV), inst, DecodeSpec(kind="greedy"),
                          device="cpu")
        np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
        np.testing.assert_array_equal(t2n(got.reward), np.asarray(want.reward))


def test_golden_file_holds_its_shapes():
    with np.load(GOLDEN) as g:
        assert g["run_time"].shape == (256, 20, 12)
        assert g["run_time"].min() >= 2 and g["run_time"].max() <= 9
        assert g["makespan"].shape == (256,) and g["actions"].shape == (256, 180)


# ---- the golden file of the chip phase ----

FFSP20 = dict(num_stage=3, num_machine=4, num_job=20, min_time=2, max_time=10)
FULL = dict(num_stage=3, num_machine=4, embed_dim=256, num_heads=16, num_encoder_layers=3,
            feedforward_hidden=512)
GOLDEN_SEED, GOLDEN_COUNT = 19, 256


def write_golden():
    jenv = jax_get_env("ffsp", **FFSP20)
    inst = jax_instances(jenv, GOLDEN_SEED, GOLDEN_COUNT)
    tree = random_params_numpy(GOLDEN_SEED, policy="matnet_ffsp", policy_kwargs=FULL)
    jpol = JaxPolicy(**FULL)
    out = jax.jit(lambda p, i: jax_rollout(jpol, p, jenv, i, KEY, JaxSpec(kind="greedy")))(
        tree_to_jax(tree), to_jax(inst))
    np.savez_compressed(GOLDEN, seed=GOLDEN_SEED, run_time=inst["run_time"].astype(np.int8),
                        makespan=-np.asarray(out.reward),
                        actions=np.asarray(out.actions).astype(np.int8))
    print(f"wrote {GOLDEN}: mean makespan {-np.asarray(out.reward).mean():.4f}")


if __name__ == "__main__":
    write_golden()
