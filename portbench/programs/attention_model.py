"""The system under test for configurations of the Attention Model family:
the port's policy, env, evaluation entry and REINFORCE, built from a
configuration file. The only module of the benchmark that imports the port.
"""

from __future__ import annotations

import contextlib

import torch


def make_env(cfg: dict):
    if cfg["env"] == "tsp":
        from rl4co_tpu_torch.envs.routing.tsp import TSP

        return TSP(num_loc=cfg["num_loc"])
    from rl4co_tpu_torch.envs.routing.cvrp import CVRP

    return CVRP(num_loc=cfg["num_loc"], min_demand=cfg["min_demand"],
                max_demand=cfg["max_demand"], capacity=cfg["capacity"])


def make_policy(cfg: dict, weights: dict, device):
    """The port's policy as the configuration states it (POMO through
    `make_pomo_policy`), holding a copy of ``weights``."""
    widths = dict(embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
                  feedforward_hidden=cfg["feedforward_hidden"],
                  num_encoder_layers=cfg["num_encoder_layers"], device=device)
    if cfg["model"] == "pomo":
        from rl4co_tpu_torch.models.zoo.pomo import make_pomo_policy

        policy = make_pomo_policy(cfg["env"], **widths)
    else:
        from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy

        policy = AttentionModelPolicy(
            env_name=cfg["env"], normalization=cfg["normalization"], use_graph_context=cfg["use_graph_context"],
            **widths)
    built = dict(normalization=policy.normalization, use_graph_context=policy.use_graph_context)
    wanted = {k: cfg[k] for k in built}
    if built != wanted:
        raise ValueError(f"the port built {built} where the configuration states {wanted}")
    policy.load_state_dict(weights, strict=True)
    return policy


def serve(cfg: dict, env, policy, instances: dict, method: str, batch: int, device):
    """One dispatch through `evaluate_policy`: ``(rewards [n], actions [n, T])``
    as numpy arrays, the best tour of each instance."""
    from rl4co_tpu_torch.tasks.eval import evaluate_policy

    res = evaluate_policy(env, policy, instances, method=method, batch_size=batch,
                          tanh_clipping=cfg["tanh_clipping"], return_actions=True,
                          warmup=False, device=device)
    return res["rewards"], res["actions"]


def make_algorithm(cfg: dict, policy, env, generator, params: dict):
    """REINFORCE with the greedy rollout baseline past its warm-up epoch,
    Adam and clipping by global norm; its draws come from ``generator``."""
    from rl4co_tpu_torch.decoding import DecodeSpec
    from rl4co_tpu_torch.rl.baselines import get_reinforce_baseline
    from rl4co_tpu_torch.rl.reinforce import REINFORCE

    algo = REINFORCE(env, policy, baseline=get_reinforce_baseline("rollout", warmup=False),
                     train_spec=DecodeSpec(kind="sampling", tanh_clipping=cfg["tanh_clipping"]),
                     lr=params["lr"], grad_clip=params["grad_clip"], optimizer="adam")
    algo.generator = generator
    return algo


@contextlib.contextmanager
def recording(algo):
    """While inside, every update of ``algo`` keeps its sampled tours and its
    baseline's values: yields ``{"actions": [[B, T]], "baseline": [[B]]}``,
    one entry per update. The object is as it was once outside."""
    rec = {"actions": [], "baseline": []}
    inner_rollout, inner_baseline = algo.train_rollout, algo.baseline

    def train_rollout(instances, replay_actions=None):
        out = inner_rollout(instances, replay_actions)
        rec["actions"].append(out.actions.detach().clone())
        return out

    class Recording:
        def __getattr__(self, name):
            return getattr(inner_baseline, name)

        def eval(self, state, instances, reward, rollout_fn):
            value, loss = inner_baseline.eval(state, instances, reward, rollout_fn)
            rec["baseline"].append(value.detach().clone())
            return value, loss

    algo.train_rollout, algo.baseline = train_rollout, Recording()
    try:
        yield rec
    finally:
        del algo.train_rollout
        algo.baseline = inner_baseline


def optimizer_state(algo) -> tuple:
    """Copies of the weights and of Adam's two moments, by name (zeros where
    the optimiser holds no state for a weight, as before a first step)."""
    state = algo.optimizer.inner.state

    def moment(p, key):
        st = state.get(p, {})
        return st[key].clone() if key in st else torch.zeros_like(p)

    named = list(algo.policy.named_parameters())
    return ({n: p.detach().clone() for n, p in named},
            {n: moment(p, "exp_avg") for n, p in named},
            {n: moment(p, "exp_avg_sq") for n, p in named})


def adam_beta1(algo) -> float:
    return float(algo.optimizer.inner.param_groups[0]["betas"][0])


def kernel_launches() -> dict:
    """Launches of the pointer kernels so far, by kernel."""
    from rl4co_tpu_torch.ops.pointer_kernel import LAUNCHES

    return dict(LAUNCHES)
