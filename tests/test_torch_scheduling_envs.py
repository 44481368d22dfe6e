"""The port's ATSP, FFSP, FJSP and JSSP envs and the FJSP file format against
the JAX package's (`rl4co_tpu/envs/routing/atsp.py`,
`rl4co_tpu/envs/scheduling/{ffsp,fjsp,parser}.py`).

- Random feasible episodes on JAX-generated instances: every state field,
  every mask and the rewards exactly equal at every step (run times and
  processing times are integers; ATSP's costs are the same f32 operations
  in the same order). FFSP's advance, a `lax.while_loop` per instance in
  JAX, is one closed-form pass over the batch in the port.
- ATSP's min-plus closure of JAX's raw matrices to the bit; the validity
  checks; FJSP's lower bounds (rtol 1e-6) and readiness (exact).
- The generators' ranges and structure; the FJSP file format round trip
  against the JAX package's parser.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rl4co_tpu.envs import get_env as jax_get_env
from rl4co_tpu.envs.scheduling import parser as jax_parser
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.envs.routing.atsp import tmat_closure
from rl4co_tpu_torch.envs.scheduling import parser

from _torch_port import jax_instances, t2n, to_torch

torch.set_num_threads(1)

SIZES = {
    "atsp": dict(num_loc=9),
    "ffsp": dict(num_stage=2, num_machine=3, num_job=5),
    "fjsp": dict(num_jobs=4, num_mas=3),
    "jssp": dict(num_jobs=4, num_mas=3),
}


def pair(name):
    return get_env(name, **SIZES[name]), jax_get_env(name, **SIZES[name])


def assert_state_equal(ts, js, what):
    for f in dataclasses.fields(ts):
        got = t2n(getattr(ts, f.name))
        want = np.asarray(getattr(js, f.name))
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f"{what}: {f.name}")


def random_episode(name, seed, b=6, wait_bias=None):
    """Both envs through one random feasible episode; every state, mask and
    the reward held equal. Returns the port's final state and actions."""
    tenv, jenv = pair(name)
    inst = jax_instances(jenv, seed, b)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch({k: jnp.asarray(v)
                                                          for k, v in inst.items()})
    step = jax.jit(jenv.step_batch)
    mask_fn = jax.jit(jenv.action_mask_batch)
    rs = np.random.RandomState(seed)
    actions = []
    for t in range(tenv.max_steps):
        assert_state_equal(ts, js, f"{name} step {t}")
        mask = t2n(tenv.action_mask(ts))
        np.testing.assert_array_equal(mask, np.asarray(mask_fn(js)), err_msg=f"mask {t}")
        act = []
        for row in mask:
            ok = np.flatnonzero(row)
            if wait_bias is not None and len(ok) > 1:   # FFSP: waiting rarely
                ok = ok[ok != wait_bias] if rs.random_sample() > 0.1 else ok
            act.append(rs.choice(ok))
        act = np.asarray(act)
        actions.append(act)
        ts, js = tenv.step(ts, torch.from_numpy(act)), step(js, jnp.asarray(act, jnp.int32))
    assert_state_equal(ts, js, f"{name} final")
    actions = np.stack(actions, 1)
    got = t2n(tenv.reward(ts, torch.from_numpy(actions)))
    want = np.asarray(jenv.reward_batch(js, jnp.asarray(actions)))
    np.testing.assert_array_equal(got, want)
    return tenv, ts, actions, inst


@pytest.mark.parametrize("name,seed", [("atsp", 0), ("atsp", 1), ("ffsp", 0), ("ffsp", 1),
                                       ("fjsp", 0), ("fjsp", 1), ("jssp", 0), ("jssp", 1)])
def test_random_feasible_episodes_match_step_by_step(name, seed):
    tenv, ts, actions, inst = random_episode(
        name, seed, wait_bias=SIZES["ffsp"]["num_job"] if name == "ffsp" else None)
    assert bool(ts.done.all()), name
    tenv.check_solution_validity(inst, actions)


def test_atsp_closure_is_the_jax_closure_to_the_bit():
    n = 12
    raw = np.random.RandomState(0).random_sample((3, n, n)).astype(np.float32)
    raw *= 1.0 - np.eye(n, dtype=np.float32)

    def jax_closure(m):
        return jax.lax.fori_loop(0, n, lambda i, m: jnp.minimum(
            m, m[:, i][:, None] + m[i, :][None, :]), m)

    want = np.stack([np.asarray(jax_closure(jnp.asarray(m))) for m in raw])
    np.testing.assert_array_equal(t2n(tmat_closure(torch.from_numpy(raw))), want)
    # the closure holds the triangle inequality
    got = t2n(tmat_closure(torch.from_numpy(raw)))
    assert (got[:, :, None, :] <= got[:, :, :, None] + got[:, None, :, :] + 1e-6).all()


def test_atsp_generator_and_validity():
    env = get_env("atsp", num_loc=7)
    inst = env.generate(4, torch.Generator().manual_seed(0), "cpu")["cost_matrix"]
    assert inst.shape == (4, 7, 7) and (inst >= 0).all() and (inst < 1).all()
    assert (torch.diagonal(inst, dim1=1, dim2=2) == 0).all()
    env.check_solution_validity({}, np.array([[3, 1, 4, 0, 2, 6, 5]]))
    jenv = jax_get_env("atsp", num_loc=7)
    for tour in ([3, 1, 4, 0, 2, 6, 6], [0, 1, 2, 3, 4, 5, 7]):
        with pytest.raises(AssertionError):
            env.check_solution_validity({}, np.array([tour]))
        with pytest.raises(AssertionError):
            jenv.check_solution_validity({}, np.array(tour))


def test_fjsp_lower_bounds_and_readiness_match_jax():
    tenv, jenv = pair("fjsp")
    inst = jax_instances(jenv, 3, 5)
    ts, js = tenv.reset(to_torch(inst)), jenv.reset_batch({k: jnp.asarray(v)
                                                          for k, v in inst.items()})
    lb = jax.jit(jax.vmap(jenv.calc_lower_bound))
    ready = jax.jit(jax.vmap(jenv.op_is_ready))
    rs = np.random.RandomState(3)
    for _ in range(tenv.max_steps):
        np.testing.assert_allclose(t2n(tenv.calc_lower_bound(ts)), np.asarray(lb(js)),
                                   rtol=1e-6)
        np.testing.assert_array_equal(t2n(tenv.op_is_ready(ts)), np.asarray(ready(js)))
        mask = t2n(tenv.action_mask(ts))
        act = np.array([rs.choice(np.flatnonzero(m)) for m in mask])
        ts, js = tenv.step(ts, torch.from_numpy(act)), jenv.step_batch(js, jnp.asarray(act))


@pytest.mark.parametrize("name", ["ffsp", "fjsp", "jssp"])
def test_generators_keep_the_structure(name):
    env = get_env(name, **SIZES[name])
    inst = env.generate(16, torch.Generator().manual_seed(1), "cpu")
    if name == "ffsp":
        rt = inst["run_time"]
        assert rt.shape == (16, 5, 6) and rt.min() >= 2 and rt.max() <= 9
        return
    proc, pad = inst["proc_times"], inst["pad_mask"]
    assert proc.shape == (16, env.num_mas, env.n_ops_max)
    eligible = (proc > 0).sum(1)
    assert (eligible[pad] == 0).all() and (eligible[~pad] >= 1).all()
    assert proc[proc > 0].min() >= 1 and proc.max() <= 20
    if name == "jssp":
        assert (eligible == 1).all() and not pad.any()
        machines = proc.argmax(1).reshape(16, env.num_jobs, env.num_mas)
        assert (machines.sort(-1).values == torch.arange(env.num_mas)).all()
    else:
        assert (eligible[~pad] <= 2).all()
        n_ops = inst["end_op_per_job"] - inst["start_op_per_job"] + 1
        assert n_ops.min() >= 2 and n_ops.max() <= 4
        assert (n_ops.sum(1) == (~pad).sum(1)).all()


def test_fjsp_file_format_round_trips_as_the_jax_parser(tmp_path):
    jenv = jax_get_env("fjsp", **SIZES["fjsp"])
    inst = jax_instances(jenv, 4, 3)
    for i in range(3):
        one = {k: v[i] for k, v in inst.items()}
        parser.write_fjsp_file(str(tmp_path / "port" / f"{i}.fjs"), one)
        jax_parser.write_fjsp_file(str(tmp_path / "jax" / f"{i}.fjs"), one)
        assert (tmp_path / "port" / f"{i}.fjs").read_text() == (
            tmp_path / "jax" / f"{i}.fjs").read_text()
    got = parser.load_fjsp_dir(str(tmp_path / "port"), n_ops_max=jenv.n_ops_max)
    want = jax_parser.load_fjsp_dir(str(tmp_path / "jax"), n_ops_max=jenv.n_ops_max)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["proc_times"], inst["proc_times"])
