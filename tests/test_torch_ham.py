"""HAM in the port against the JAX package (`rl4co_tpu/models/zoo/ham.py`),
and the golden file of the chip phase.

- `HeterogeneousMHA` and `HAMEncoderLayer` on numpy-seeded weights: atol and
  rtol 1e-5; an even graph size is refused.
- The policy's tree has the JAX module's structure (no ``encoder_net``);
  greedy rollouts on PDP: actions equal, rewards rtol 1e-5; the train CLI
  turns another env into PDP.

`python tests/test_torch_ham.py` rewrites
`rl4co_tpu_torch/golden/ham_pdp50.npz` (HAM at AM's published widths with
seeded weights on 1 024 PDP-50 instances from `jax.random`: the JAX CPU
greedy costs and tours) in about a minute; no collected test runs it.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]  # for a run as a script

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from rl4co_tpu.decoding import DecodeSpec as JaxSpec  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.models import rollout as jax_rollout  # noqa: E402
from rl4co_tpu.models.policies.constructive import init_policy_params  # noqa: E402
from rl4co_tpu.models.zoo.ham import HAMEncoderLayer as JaxLayer  # noqa: E402
from rl4co_tpu.models.zoo.ham import HAMPolicy as JaxPolicy  # noqa: E402
from rl4co_tpu.models.zoo.ham import HeterogeneousMHA as JaxMHA  # noqa: E402
from rl4co_tpu_torch.convert import convert_params, random_params_numpy  # noqa: E402
from rl4co_tpu_torch.models.zoo.ham import (  # noqa: E402
    HAMEncoderLayer,
    HAMPolicy,
    HeterogeneousMHA,
)
from rl4co_tpu_torch.train import WorkloadSpec, build  # noqa: E402

from _torch_port import (  # noqa: E402
    KEY,
    jax_instances,
    port_rollout,
    t2n,
    to_jax,
    tree_to_jax,
    zoo_tree_pair,
)

torch.set_num_threads(1)

SMALL = dict(embed_dim=32, num_heads=4, num_encoder_layers=2, feedforward_hidden=64)
N, B = 8, 4
GOLDEN = os.path.join(os.path.dirname(_HERE), "rl4co_tpu_torch", "golden", "ham_pdp50.npz")


def test_heterogeneous_attention_and_layer_match_jax():
    sub = random_params_numpy(0, policy="ham", policy_kwargs=SMALL)["ham_layer_0"]
    x = np.random.RandomState(0).standard_normal((B, N + 1, 32)).astype(np.float32)
    mha = HeterogeneousMHA(32, 4)
    mha.load_state_dict(convert_params(sub["hetero_mha"]))
    want = JaxMHA(32, 4).apply({"params": sub["hetero_mha"]}, x)
    np.testing.assert_allclose(t2n(mha(torch.from_numpy(x))), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    layer = HAMEncoderLayer(32, 4, feedforward_hidden=64)
    layer.load_state_dict(convert_params(sub))
    want = JaxLayer(32, 4, feedforward_hidden=64).apply({"params": sub}, x)
    np.testing.assert_allclose(t2n(layer(torch.from_numpy(x))), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="odd graph size"):
        mha(torch.zeros(2, N, 32))


def test_tree_has_the_jax_structure_and_greedy_matches_jax():
    jpol, jparams, tpol = zoo_tree_pair("ham", JaxPolicy, HAMPolicy, 1, **SMALL)
    jenv = jax_get_env("pdp", num_loc=N)
    shapes = jax.eval_shape(lambda k: init_policy_params(jpol, jenv, k), KEY)
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jparams)
    assert "encoder_net" not in jparams["params"]
    inst = jax_instances(jenv, 2, B)
    want = jax_rollout(jpol, jparams, jenv, to_jax(inst), KEY, JaxSpec(kind="greedy"))
    got = port_rollout(tpol, "pdp", inst, kind="greedy")
    np.testing.assert_array_equal(t2n(got.actions), np.asarray(want.actions))
    np.testing.assert_allclose(t2n(got.reward), np.asarray(want.reward), rtol=1e-5)


def test_train_cli_builds_ham_on_pdp_whatever_the_env():
    spec = WorkloadSpec(model="ham", env_name="tsp", env_kwargs=(("num_loc", 6),),
                        policy_kwargs=(("embed_dim", 16), ("num_heads", 2),
                                       ("num_encoder_layers", 1)), device="cpu")
    algo, _ = build(spec)
    assert algo.env.name == "pdp" and algo.env.num_loc == 6
    assert isinstance(algo.policy, HAMPolicy)


def test_golden_file_holds_its_shapes():
    with np.load(GOLDEN) as g:
        assert g["locs"].shape == (1024, 50, 2) and g["depot"].shape == (1024, 2)
        assert g["cost"].shape == (1024,) and g["actions"].shape[0] == 1024


# ---- the golden file of the chip phase ----

GOLDEN_SEED, GOLDEN_COUNT = 19, 1024


def write_golden():
    n = 50
    jenv = jax_get_env("pdp", num_loc=n)
    inst = jax_instances(jenv, GOLDEN_SEED, GOLDEN_COUNT)
    tree = random_params_numpy(GOLDEN_SEED, policy="ham")
    jpol = JaxPolicy()
    out = jax.jit(lambda p, i: jax_rollout(jpol, p, jenv, i, KEY, JaxSpec(kind="greedy")))(
        tree_to_jax(tree), to_jax(inst))
    np.savez_compressed(GOLDEN, seed=GOLDEN_SEED, **inst, cost=-np.asarray(out.reward),
                        actions=np.asarray(out.actions).astype(np.int8))
    print(f"wrote {GOLDEN}: mean cost {-np.asarray(out.reward).mean():.6f}")


if __name__ == "__main__":
    write_golden()
