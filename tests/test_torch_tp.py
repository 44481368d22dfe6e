"""Tensor and expert parallelism in the port (`rl4co_tpu_torch/parallel/mesh.py`,
the ``model`` axis) on the CPU, against one process and against the JAX
package's `shard_params_model_axis` (`tests/test_sharding.py` holds the JAX
package's ``(2, 2)`` step to its dp-only one).

- Placement: every parameter's decision (``row`` / ``col`` / ``expert`` /
  replicated) is the JAX package's ``PartitionSpec`` on a ``(2, 2)`` CPU
  mesh, for AM and MVMoE, with the role markers and with the path
  fragments; a renamed block keeps its row split only with the markers.
- Train steps: four gloo processes as ``(dp 2, model 2)``, then two as
  ``(dp 1, model 2)`` (`_torch_tp_child.py`), each configuration against the
  one-process port run at `test_torch_dp.py`'s tolerances (metrics rtol
  1e-5, atol 1e-5; parameters within `PARAM_ATOL` and `CLOSE_SHARE` of
  their elements within 1e-6), every process's whole parameters equal to
  the bit and the model ranks' tours equal to the bit. AM under the rollout
  and the mean baselines, POMO (K1's grouped decode) and MVMoE with its 4
  experts split 2 per rank. AM's close share is taken over every parameter,
  as `test_torch_dp.py` takes it (98.49 to 98.54 % measured). Every
  configuration's is also taken over the parameters whose one-process
  gradient carries a signal at both steps (99.24 to 99.31 % for AM, 98.78 %
  for POMO, 99.50 % for MVMoE), leaving out those whose gradient at some
  step is below `NOISE` of that step's largest: the FFN's and the
  attention's output biases, which a mean-subtracting norm follows, and
  MVMoE's experts' output biases and graph-context projection at the first
  step. Such gradients vanish but for rounding, and Adam turns them into
  steps of +-lr (see `test_torch_dp.py`) whatever the order of the sums.
  Over every parameter POMO's share is 97.97 % (its node embedding's bias
  has a gradient of 3e-6 of the largest, 3 of its 16 elements within 1e-6)
  and MVMoE's 96.32 %. Every parameter is held at `PARAM_ATOL`.
- The replayed loss and whole gradients of AM on given tours under
  ``(2, 2)`` against `jax.value_and_grad` of the JAX loss on parameters that
  the JAX `shard_params_model_axis` placed on a ``(2, 2)`` CPU mesh, at
  `test_torch_reinforce.py`'s tolerances (loss atol 2e-5; gradients rtol
  1e-3, atol 1e-5).
- A checkpoint written under ``(2, 2)`` holds the whole tree: one process
  loads it to the gathered parameters, and a split algorithm restored from
  it takes the same next step as the run that wrote it, to the bit.
- Refusals: heads that do not divide by ``model``, and a split with no
  eager form, raise before anything moves.
"""

import os
import socket
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import _torch_tp_child as child  # noqa: E402
from _torch_port import tree_to_jax  # noqa: E402
from rl4co_tpu.envs import get_env as jax_get_env  # noqa: E402
from rl4co_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from rl4co_tpu.parallel.mesh import shard_params_model_axis as jax_shard  # noqa: E402
from rl4co_tpu_torch.parallel import mesh as tmesh  # noqa: E402

torch.set_num_threads(1)

PARAM_ATOL = 4e-4     # test_torch_dp.py's
CLOSE_SHARE = 0.98    # test_torch_dp.py's
# a one-process gradient below this share of its step's largest is rounding noise
NOISE = 1e-6


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The processes' outputs: ``{"22": [4 ranks], "12": [2 ranks]}`` and
    the checkpoint's path (one spawn for the whole module)."""
    out = tmp_path_factory.mktemp("tp")
    ports = [str(_free_port()), str(_free_port())]
    procs = [subprocess.Popen([sys.executable, child.__file__, str(r), "4", *ports, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a tensor-parallel rank timed out")
        assert p.returncode == 0, err[-3000:]
    return ({"22": [dict(np.load(out / f"tp22_rank{r}.npz")) for r in range(4)],
             "12": [dict(np.load(out / f"tp12_rank{r}.npz")) for r in range(2)]},
            str(out / "tp_ckpt.pt"))


# ---- placement against the JAX package ----

JAX_MESH = None


def jax_decisions(params, roles=None) -> dict:
    """{path: decision} of the JAX `shard_params_model_axis` on a (2, 2) mesh."""
    global JAX_MESH
    if JAX_MESH is None:
        JAX_MESH = jax_make_mesh(devices=jax.devices()[:4], dp=2, model=2)
    placed = jax_shard(params, JAX_MESH, min_dim=child.MIN_DIM, roles=roles)
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(placed)[0]:
        keys = [str(p.key) for p in path]
        spec = tuple(x.sharding.spec)
        name = "/".join(keys[1:] if keys[0] == "params" else keys)
        if "model" not in spec:
            out[name] = "replicated"
        elif "experts']" in jax.tree_util.keystr(path):
            out[name] = "expert"
        else:
            out[name] = {("model", None): "row", (None, "model"): "col"}[spec]
    return out


def jax_policy(name):
    from rl4co_tpu.models import AttentionModelPolicy
    from rl4co_tpu.models.policies.constructive import init_policy_params, policy_tp_roles
    from rl4co_tpu.models.zoo.mvmoe import MVMoEPolicy

    env = jax_get_env("tsp", num_loc=child.N)
    if name == "mvmoe":
        pol = MVMoEPolicy(env_name="tsp", normalization="instance", num_experts=4,
                          moe_topk=2, **child.SMALL)
    else:
        pol = AttentionModelPolicy(env_name="tsp", **child.SMALL)
    params = init_policy_params(pol, env, jax.random.PRNGKey(0))   # MVMoE's has "losses"
    return {"params": params["params"]}, policy_tp_roles(pol, env)


@pytest.mark.parametrize("with_roles", [True, False], ids=["roles", "fragments"])
@pytest.mark.parametrize("name", ["am", "mvmoe"])
def test_placement_is_the_jax_placement(name, with_roles):
    from rl4co_tpu_torch.models.policies.constructive import policy_tp_roles

    params, jroles = jax_policy(name)
    policy = child.make_algo("mvmoe" if name == "mvmoe" else "am-mean").policy
    roles = policy_tp_roles(policy)
    assert tmesh.tp_role_lookup(roles) == {
        k: v for k, v in tmesh.tp_role_lookup(jroles).items() if v != "none"}
    got = tmesh.tp_decisions(policy, 2, min_dim=child.MIN_DIM,
                             roles=roles if with_roles else None)
    want = jax_decisions(params, jroles if with_roles else None)
    assert got == want
    kinds = set(got.values())
    assert {"row", "col", "replicated"} <= kinds
    assert ("expert" in kinds) == (name == "mvmoe")


def test_renamed_block_keeps_its_row_split_only_with_roles():
    """`test_sharding.py`'s renamed block: ``attn``/``feedforward`` defeat
    the path fragments but not the markers, in both packages."""
    import flax.linen as fnn

    from rl4co_tpu.models.nn.attention import MultiHeadAttention as JaxMHA
    from rl4co_tpu.models.nn.ops import TransformerFFN as JaxFFN
    from rl4co_tpu_torch.models.nn.attention import MultiHeadAttention
    from rl4co_tpu_torch.models.nn.ops import TransformerFFN
    from rl4co_tpu_torch.models.policies.constructive import policy_tp_roles

    class JaxBlock(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = JaxMHA(embed_dim=16, num_heads=2, name="attn")(x)
            return JaxFFN(embed_dim=16, feedforward_hidden=32, name="feedforward")(x)

    variables = JaxBlock().init(jax.random.PRNGKey(0), jnp.ones((2, 8, 16)),
                                mutable=["params", "intermediates"])
    block = torch.nn.Module()
    block.attn = MultiHeadAttention(16, 2)
    block.feedforward = TransformerFFN(16, 32)
    for roles, jroles in ((None, None), (policy_tp_roles(block), variables["intermediates"])):
        got = tmesh.tp_decisions(block, 2, min_dim=8, roles=roles)
        assert got == jax_decisions({"params": variables["params"]}, jroles)
        rows = sorted(k for k, v in got.items() if v == "row")
        assert rows == ([] if roles is None else
                        ["attn/out_proj/kernel", "feedforward/Dense_1/kernel"]), rows


# ---- train steps against one process ----

@pytest.mark.parametrize("mesh,name", [("22", n) for n in child.CONFIGS_22]
                         + [("12", n) for n in child.CONFIGS_12])
def test_split_train_steps_are_the_one_process_steps(ranks, mesh, name):
    outs = ranks[0][mesh]
    prefix = f"{name}/"
    got = [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)} for r in outs]
    want = child.train_config(name)
    grads = [{k[len(f"grad{step}/"):]: np.abs(v).max() for k, v in want.items()
              if k.startswith(f"grad{step}/")} for step in range(child.STEPS)]
    noise = {f"param/{k}" for g in grads for k, v in g.items() if v < NOISE * max(g.values())}
    want = {k: v for k, v in want.items() if not k.startswith("grad")}
    assert all(set(g) == set(want) for g in got)
    params = [k for k in want if k.startswith("param/")]
    assert any(k.endswith(("Wqkv.weight", "experts.Dense_0.kernel")) for k in params)
    for g in got[1:]:
        for k in params:
            np.testing.assert_array_equal(g[k], got[0][k], err_msg=k)   # every process
    model = 2
    for d in range(len(got) // model):   # the model ranks of a dp rank: the same tours
        for j in range(1, model):
            for step in range(child.STEPS):
                np.testing.assert_array_equal(got[d * model + j][f"tours{step}"],
                                              got[d * model][f"tours{step}"])
    close, signal = [], []
    for k in want:
        if k.startswith("param/"):
            np.testing.assert_allclose(got[0][k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
            close.append((np.abs(got[0][k] - want[k]) <= 1e-6).ravel())
            if k not in noise:
                signal.append(close[-1])
        elif not k.startswith("tours"):
            np.testing.assert_allclose(got[0][k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    if name.startswith("am-"):   # test_torch_dp.py's model: its share, over every parameter
        assert np.concatenate(close).mean() >= CLOSE_SHARE
    assert np.concatenate(signal).mean() >= CLOSE_SHARE


def test_replayed_loss_and_gradients_equal_jax_on_placed_parameters(ranks):
    from rl4co_tpu.decoding import DecodeSpec as JaxSpec
    from rl4co_tpu.models import AttentionModelPolicy as JaxPolicy
    from rl4co_tpu.models import rollout as jax_rollout
    from rl4co_tpu.models.policies.constructive import policy_tp_roles as jax_roles
    from rl4co_tpu_torch.convert import convert_params, random_params_numpy

    jenv = jax_get_env("tsp", num_loc=child.N)
    jpol = JaxPolicy(env_name="tsp", **child.SMALL)
    tree = random_params_numpy(0, child.SMALL["embed_dim"], child.SMALL["num_encoder_layers"],
                               child.SMALL["feedforward_hidden"])
    jax_decisions(tree_to_jax(tree))   # makes the mesh
    params = jax_shard(tree_to_jax(tree), JAX_MESH, min_dim=child.MIN_DIM,
                       roles=jax_roles(jpol, jenv))
    locs, actions = child.replay_inputs()

    def loss_fn(p):
        out = jax_rollout(jpol, p, jenv, {"locs": jnp.asarray(locs)}, jax.random.PRNGKey(0),
                          JaxSpec(kind="evaluate", tanh_clipping=10.0), jnp.asarray(actions))
        return -((out.reward - out.reward.mean()) * out.log_likelihood).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = {k: v.numpy() for k, v in convert_params(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}
    for r in ranks[0]["22"]:
        np.testing.assert_allclose(r["replay/loss"], float(jloss), atol=2e-5)
        got = {k[len("replay/grad/"):]: v for k, v in r.items() if k.startswith("replay/grad/")}
        assert set(got) == set(want)
        for name, g in got.items():
            np.testing.assert_allclose(g, want[name], rtol=1e-3, atol=1e-5, err_msg=name)
    assert abs(float(jloss)) > 1e-3 and max(np.abs(w).max() for w in want.values()) > 1e-2


def test_checkpoint_written_under_tp_loads_in_one_process(ranks):
    from rl4co_tpu_torch.checkpoint import restore_checkpoint

    outs, path = ranks[0]["22"], ranks[1]
    state = restore_checkpoint(path, "cpu")["state"]
    algo = child.make_algo("am-rollout")
    algo.load_state_dict(state)
    for name, p in algo.policy.named_parameters():
        for r in outs:
            np.testing.assert_array_equal(p.detach().numpy(), r[f"ckpt/restored/{name}"],
                                          err_msg=name)
            np.testing.assert_array_equal(r[f"ckpt/resumed/{name}"], r[f"ckpt/live/{name}"],
                                          err_msg=name)
    assert algo.step == 1 and state["optimizer"]["count"] == 1
    exp_avg = state["optimizer"]["inner"]["state"]
    shapes = [tuple(p.shape) for p in algo.policy.parameters()]
    assert [tuple(exp_avg[i]["exp_avg"].shape) for i in range(len(shapes))] == shapes


# ---- refusals ----

def test_placements_with_no_eager_form_raise_before_anything_moves():
    """No process group is needed: the refusals come before any collective."""
    from rl4co_tpu_torch.models import AttentionModelPolicy
    from rl4co_tpu_torch.models.nn.moe import MoE

    mesh = tmesh.Mesh(rank=0, world=1, model=2)
    policy = AttentionModelPolicy(env_name="tsp", device="cpu",
                                  **{**child.SMALL, "num_heads": 1})
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    with pytest.raises(ValueError, match="1 heads do not split over 2 model ranks"):
        tmesh.shard_params_model_axis(policy, mesh, min_dim=8)
    assert all(torch.equal(before[k], v) for k, v in policy.state_dict().items())
    assert not tmesh.tp_parameters(policy)
    # a gate of 8 experts is a 2-D kernel the column rule takes, used whole
    with pytest.raises(NotImplementedError, match="w_gate"):
        tmesh.shard_params_model_axis(MoE(16, 16, (), num_experts=8), mesh, min_dim=8)
