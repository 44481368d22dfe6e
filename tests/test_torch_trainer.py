"""The port's trainer: the counterparts of `tests/test_training.py`, at the
same sizes and margins, on ``device="cpu"``. Weights come from
`convert.random_params_numpy` or a seeded `torch.manual_seed`, so that two
trainers start alike."""

import numpy as np
import pytest
import torch

from rl4co_tpu_torch.checkpoint import restore_checkpoint
from rl4co_tpu_torch.convert import load_params, random_params_numpy
from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.envs import get_env
from rl4co_tpu_torch.models import AttentionModelPolicy
from rl4co_tpu_torch.models.zoo.am import AttentionModel
from rl4co_tpu_torch.rl.reinforce import REINFORCE, seeded_generator
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig
from rl4co_tpu_torch.utils.optim import get_lr_schedule

torch.set_num_threads(1)

TINY = dict(embed_dim=16, num_encoder_layers=1, feedforward_hidden=32, num_heads=2)
SPEC = DecodeSpec(kind="sampling", tanh_clipping=10.0)
CPU = torch.device("cpu")


def tiny_policy(seed=0, normalization="batch", **dims):
    dims = {**TINY, **dims}
    tree = random_params_numpy(seed, dims["embed_dim"], dims["num_encoder_layers"],
                               dims["feedforward_hidden"], normalization)
    policy = AttentionModelPolicy(env_name="tsp", normalization=normalization,
                                  device="cpu", **dims)
    return load_params(policy, tree)


def tiny_setup(baseline="rollout", **algo_kwargs):
    env = get_env("tsp", num_loc=6)
    algo = REINFORCE(env, tiny_policy(), baseline=baseline, train_spec=SPEC, **algo_kwargs)
    cfg = TrainerConfig(epochs=1, batch_size=4, train_data_size=12,
                        val_data_size=8, val_batch_size=8, seed=0)
    return algo, cfg


def generate(env, n, seed):
    return env.generate(n, seeded_generator(CPU, seed), "cpu")


@pytest.mark.parametrize("baseline", ["no", "exponential", "mean", "rollout"])
def test_reinforce_trains_one_epoch(baseline):
    algo, cfg = tiny_setup(baseline=baseline)
    before = [p.detach().clone() for p in algo.policy.parameters()]
    trainer = Trainer(algo, cfg, logger=lambda m: None)
    state = trainer.fit()
    assert state is algo and state.step == 3
    rec = trainer.history[-1]
    assert np.isfinite(rec["val/reward"]) and rec["val/max_reward"] >= rec["val/reward"]
    assert rec["time/epoch_s"] > 0
    assert rec["env_steps_per_s"] == pytest.approx(3 * 4 * 6 / rec["time/epoch_s"])
    assert any(not torch.equal(p, q) for p, q in zip(algo.policy.parameters(), before))


def test_reinforce_improves_on_tsp():
    # A few hundred steps on TSP-6 should beat the initial policy clearly.
    env = get_env("tsp", num_loc=6)
    torch.manual_seed(0)
    algo = AttentionModel(
        env, baseline="exponential", lr=5e-3, train_spec=SPEC,
        policy_kwargs=dict(embed_dim=32, num_encoder_layers=1, feedforward_hidden=64,
                           num_heads=4, device="cpu"))
    eval_step = algo.make_eval_step()
    val = generate(env, 64, 1)
    before = eval_step(val)["reward"].item()
    algo.reseed(3)
    for _ in range(60):
        algo.train_step(64)
    after = eval_step(val)["reward"].item()
    assert after > before + 0.05, (before, after)


def test_rollout_baseline_ttest_updates():
    algo, cfg = tiny_setup(baseline="rollout")
    host = {"eval_instances": generate(algo.env, 32, 1)}
    host["eval_rewards"] = algo.greedy_reward_fn()(
        algo.policy, host["eval_instances"]).numpy() - 100.0  # a terrible incumbent
    incumbent = algo.baseline_state.bl_policy
    host2 = algo.epoch_end(host)
    assert (host2["eval_rewards"] > -50).all()  # the challenge succeeded
    assert algo.baseline_state.bl_policy is not incumbent
    assert algo.baseline_state.epoch == 1


def test_held_out_set_is_min_of_val_size_and_2048_for_rollout_baselines_only():
    seen = {}

    class Spy(Trainer):
        def _validate(self, eval_step, val_instances):
            seen["val"] = next(iter(val_instances.values())).shape[0]
            return super()._validate(eval_step, val_instances)

    algo, cfg = tiny_setup(baseline="rollout")
    cfg.val_data_size = 10
    host_sizes = []
    end = algo.epoch_end
    algo.epoch_end = lambda host: (host_sizes.append(
        (host["eval_instances"]["locs"].shape[0], host["eval_rewards"].shape)), end(host))[1]
    Spy(algo, cfg, logger=lambda m: None).fit()
    assert seen["val"] == 10 and host_sizes == [(10, (10,))]

    algo, cfg = tiny_setup(baseline="mean")
    hosts = []
    end2 = algo.epoch_end
    algo.epoch_end = lambda host: (hosts.append(dict(host)), end2(host))[1]
    Trainer(algo, cfg, logger=lambda m: None).fit()
    assert hosts == [{}]


def test_named_val_datasets_and_ragged_tail():
    """Several named val sets during fit, and every instance counted even
    when the set's size is no multiple of the batch."""
    env = get_env("tsp", num_loc=6)
    # instance norm: an instance's result does not depend on its batch, so
    # the weighted batch mean must equal the full-set mean
    algo = REINFORCE(env, tiny_policy(normalization="instance"), baseline="mean",
                     train_spec=SPEC)
    cfg = TrainerConfig(epochs=1, batch_size=4, train_data_size=12,
                        val_data_size=8, val_batch_size=3, seed=0)
    trainer = Trainer(algo, cfg, logger=lambda m: None)
    sets = {"a": generate(env, 8, 10), "b": generate(env, 5, 11)}
    trainer.fit(val_datasets=sets)
    rec = trainer.history[-1]
    assert "val/a/reward" in rec and "val/b/reward" in rec and "val/reward" not in rec
    eval_step = algo.make_eval_step()
    exact = eval_step(sets["a"])["reward"].item()
    weighted = trainer._validate(eval_step, sets["a"])["reward"]
    np.testing.assert_allclose(weighted, exact, rtol=1e-5)
    assert rec["val/a/reward"] == pytest.approx(exact, rel=1e-5)  # the primary set


def test_checkpoint_resume_reproduces_uninterrupted_run(tmp_path):
    """Kill-and-resume: 2+2 epochs with a restart must match 4 straight epochs."""
    def make(ckpt_dir):
        algo, cfg = tiny_setup(baseline="rollout")
        cfg.epochs = 4
        cfg.ckpt_dir = ckpt_dir
        return algo, Trainer(algo, cfg, logger=lambda m: None)

    algo_full, tr_full = make(None)
    tr_full.fit()
    curve_full = [r["val/reward"] for r in tr_full.history if "val/reward" in r]

    ck = tmp_path / "ck"
    _, tr_a = make(str(ck))
    tr_a.config.epochs = 2
    tr_a.fit()
    algo_b, tr_b = make(str(ck))
    state_b = tr_b.fit(resume_from=str(ck / "last.pt"))
    curve_b = [r["val/reward"] for r in tr_b.history if "val/reward" in r]

    assert state_b.step == algo_full.step == 12
    assert [r["epoch"] for r in tr_b.history] == [2, 3]
    np.testing.assert_allclose(curve_b, curve_full[2:], rtol=1e-5)
    for (name, a), (_, b) in zip(algo_full.policy.named_parameters(),
                                 algo_b.policy.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   err_msg=name)
    for a, b in zip(algo_full.baseline_state.bl_policy.parameters(),
                    algo_b.baseline_state.bl_policy.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert algo_b.baseline_state.epoch == algo_full.baseline_state.epoch == 4
    # the best checkpoint exists alongside the last one
    assert (ck / "best.pt").exists() and not (ck / "last.pt.tmp").exists()
    last = restore_checkpoint(str(ck / "last.pt"), map_location="cpu")
    assert last["epoch"] == 4 and last["state"]["step"] == 12
    assert last["best_monitor"] == pytest.approx(max(curve_full))
    assert set(last["state"]) == {"policy", "optimizer", "baseline", "step"}
    assert last["eval_rewards"].shape == (8,)


def test_trainer_test_phase_named_datasets():
    algo, cfg = tiny_setup(baseline="mean")
    trainer = Trainer(algo, cfg, logger=lambda m: None)
    trainer.fit()
    env = algo.env
    datasets = {"uniform": generate(env, 8, 7),
                "uniform2": {"locs": generate(env, 8, 8)["locs"].numpy()}}  # numpy too
    record = trainer.test(datasets)
    assert {"test/uniform/reward", "test/uniform2/reward"} <= set(record)
    assert all(np.isfinite(v) for v in record.values())
    assert trainer.history[-1] is record
    # default: generated test set
    record2 = trainer.test()
    assert np.isfinite(record2["test/test/reward"])


def test_scheduled_sgd_trains_and_logs_only_every_log_every_steps():
    sched = get_lr_schedule("multistep", 1e-3, milestones=(2, 4), gamma=0.1,
                            steps_per_epoch=10)
    algo, cfg = tiny_setup(baseline="mean", optimizer="sgd", lr_schedule=sched)
    cfg.log_every = 2
    records = []
    trainer = Trainer(algo, cfg, logger=records.append)
    trainer.fit()
    assert np.isfinite(trainer.history[-1]["val/reward"])
    its = [r["it"] for r in records if "it" in r]
    assert its == [0, 2]
    logged = next(r for r in records if "it" in r)
    assert {"loss", "reinforce_loss", "bl_loss", "reward", "bl_val", "entropy"} <= set(logged)
    assert all(isinstance(logged[k], float) for k in ("loss", "reward"))
    assert records[0]["model/params_total"] == sum(
        p.numel() for p in algo.policy.parameters())


def test_max_hours_stops_after_the_epoch_and_writes_last(tmp_path):
    algo, cfg = tiny_setup(baseline="mean")
    cfg.epochs, cfg.max_hours, cfg.ckpt_dir, cfg.ckpt_every = 5, 0.0, str(tmp_path), 10
    records = []
    Trainer(algo, cfg, logger=records.append).fit()
    assert algo.step == 3  # one epoch only
    assert any(r.get("stopped") == "max_hours" for r in records)
    assert restore_checkpoint(str(tmp_path / "last.pt"), map_location="cpu")["epoch"] == 1


def test_the_default_device_still_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    env = get_env("tsp", num_loc=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AttentionModel(env)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AttentionModel(env, policy_kwargs=TINY)
