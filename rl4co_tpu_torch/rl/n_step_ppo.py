"""n-step PPO for the improvement models DACT, N2S and NeuOpt (counterpart
of `rl4co_tpu/rl/n_step_ppo.py`).

A *segment* rolls ``n_step`` improvement moves (states, actions,
log-probabilities and rewards kept, no graph), bootstraps the returns from
the critic at its end, then takes ``ppo_epochs`` clipped-PPO updates with
value clipping from the second epoch on. One clipping by global norm
(``max_grad_norm``) spans the policy and the critic; then Adam updates each
at its own learning rate (two parameter groups, as the JAX package's
``optax.multi_transform``). The stored states are re-evaluated as one batch
of ``n_step × B`` rows, which the policies' per-instance layer norm allows.

As in the JAX package, the rollout masks the previous action and the
re-evaluation does not, and the old values are the epoch-0 values (the
parameters before the first update). A curriculum warm-up (CL) rolls
``cl_num`` moves without a graph before the segments of a batch; through the
`Trainer`, ``cl_num = ceil(CL_scalar × epoch)`` with ``epoch = calls //
steps_per_epoch_hint`` when the hint is set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from rl4co_tpu_torch.decoding import DecodeSpec
from rl4co_tpu_torch.models.zoo.dact import ImprovementCritic, dact_act
from rl4co_tpu_torch.rl.reinforce import seeded_generator
from rl4co_tpu_torch.utils.optim import Optimizer


def cat_states(states: list):
    """One state of ``len(states) × B`` rows from states of B rows."""
    return type(states[0])(**{f.name: torch.cat([getattr(s, f.name) for s in states])
                              for f in dataclasses.fields(states[0])})


class NStepPPO:
    def __init__(
        self,
        env: Any,
        policy: torch.nn.Module,
        critic: Optional[torch.nn.Module] = None,
        act_fn=dact_act,          # (policy, state, spec, generator, prev, replay)
        clip_range: float = 0.1,
        ppo_epochs: int = 3,
        vf_lambda: float = 1.0,
        max_grad_norm: float = 0.05,
        gamma: float = 0.999,
        n_step: int = 5,
        T_train: int = 250,
        T_test: int = 1000,
        lr_policy: float = 8e-5,
        lr_critic: float = 2e-5,
        CL_scalar: float = 2.0,
        CL_best: bool = False,
        action_dim: int = 2,      # packed action width: DACT 2, N2S 3, NeuOpt 3 k_max
        train_spec: DecodeSpec = DecodeSpec(kind="sampling", tanh_clipping=6.0),
        steps_per_epoch_hint: int = 0,
        eval_t_max: int = 0,      # 0: T_test
    ):
        self.env, self.policy, self.act_fn = env, policy, act_fn
        self.device = next(policy.parameters()).device
        self.critic = critic if critic is not None else ImprovementCritic(
            2 * policy.embed_dim, device=self.device)
        self.clip_range, self.ppo_epochs, self.vf_lambda = clip_range, ppo_epochs, vf_lambda
        self.gamma, self.n_step, self.T_train, self.T_test = gamma, n_step, T_train, T_test
        self.CL_scalar, self.CL_best, self.action_dim = CL_scalar, CL_best, action_dim
        self.train_spec = train_spec
        self.steps_per_epoch_hint, self.eval_t_max = steps_per_epoch_hint, eval_t_max
        self.optimizer = Optimizer(torch.optim.Adam([
            {"params": list(policy.parameters()), "lr": lr_policy},
            {"params": list(self.critic.parameters()), "lr": lr_critic}]),
            schedule=None, grad_clip=max_grad_norm)
        self.step = 0       # segments taken
        self.calls = 0      # trainer steps taken: the curriculum's clock
        self.generator = seeded_generator(self.device, 0)

    def reseed(self, *words: int) -> None:
        self.generator = seeded_generator(self.device, *words)

    def _act(self, state, prev_action, replay_action=None):
        spec = self.train_spec
        if replay_action is not None:
            spec = dataclasses.replace(spec, kind="evaluate")
        return self.act_fn(self.policy, state, spec, self.generator, prev_action, replay_action)

    @torch.no_grad()
    def rollout_segment(self, env_state, prev_action, replay_actions=None):
        """``n_step`` moves; returns the last state and action, and the
        states, actions ``[n, B, A]``, log-probabilities and rewards ``[n, B]``.
        ``replay_actions [n, B, A]`` replays given moves under the same masks."""
        states, actions, logps, rewards = [], [], [], []
        for t in range(self.n_step):
            action, logp, _ = self._act(env_state, prev_action,
                                        None if replay_actions is None else replay_actions[t])
            states.append(env_state)
            env_state, reward = self.env.step(env_state, action)
            actions.append(action)
            logps.append(logp)
            rewards.append(reward)
            prev_action = action
        return env_state, prev_action, (states, torch.stack(actions), torch.stack(logps),
                                        torch.stack(rewards))

    def evaluate_memory(self, states: list, actions: torch.Tensor):
        """Log-probabilities and values ``[n, B]`` of the stored moves, without
        the previous-action mask, as one batch."""
        spec = dataclasses.replace(self.train_spec, kind="evaluate")
        n, b = actions.shape[:2]
        _, ll, embeds = self.act_fn(self.policy, cat_states(states), spec, None, None,
                                    actions.reshape(n * b, -1))
        return ll.reshape(n, b), self.critic(embeds).reshape(n, b)

    def segment(self, env_state, prev_action, replay_actions=None, trace=None):
        """One segment: rollout, returns, ``ppo_epochs`` updates. ``trace``, a
        dict, receives each epoch's losses, the first epoch's gradients and
        the rollout (what the tests hold against the JAX package's)."""
        env_state, prev_action, (states, actions, old_ll, rewards) = self.rollout_segment(
            env_state, prev_action, replay_actions)
        with torch.no_grad():
            r = self.critic(self.policy.embeds(env_state))
            returns = []
            for t in reversed(range(self.n_step)):
                r = r * self.gamma + rewards[t]
                returns.append(r)
            returns = torch.stack(returns[::-1])
        c = self.clip_range
        old_value = None
        for k in range(self.ppo_epochs):
            ll, value = self.evaluate_memory(states, actions)
            ratio = torch.exp(ll - old_ll)
            adv = returns - value.detach()
            surrogate = -torch.minimum(ratio * adv, ratio.clamp(1 - c, 1 + c) * adv).mean()
            if old_value is None:
                value_loss = (value - returns).square().mean()
            else:
                clipped = (value - old_value).clamp(-c, c) + old_value
                value_loss = torch.maximum((value - returns).square(),
                                           (clipped - returns).square()).mean()
            loss = surrogate + self.vf_lambda * value_loss
            self.optimizer.zero_grad()
            loss.backward()
            if k == 0:
                old_value = value.detach()
            metrics = {"loss": loss.detach(), "surrogate_loss": surrogate.detach(),
                       "value_loss": value_loss.detach(), "value": value.detach().mean()}
            if trace is not None:
                trace.setdefault("epochs", []).append({m: v.item() for m, v in metrics.items()})
                if k == 0:
                    trace["grads"] = {
                        **{f"policy.{n}": p.grad.clone() for n, p in
                           self.policy.named_parameters() if p.grad is not None},
                        **{f"critic.{n}": p.grad.clone() for n, p in
                           self.critic.named_parameters() if p.grad is not None}}
            self.optimizer.step()
        if trace is not None:
            trace.update(actions=actions, old_ll=old_ll, rewards=rewards, returns=returns)
        self.step += 1
        return env_state, prev_action, {**metrics, "reward": rewards.sum(0).mean(),
                                        "cost_bsf": env_state.cost_bsf.mean()}

    @torch.no_grad()
    def warmup(self, env_state, cl_num: int):
        """The curriculum's ``cl_num`` moves without a graph; the previous
        action starts at zeros, as in the JAX package."""
        prev = torch.zeros(env_state.cost_bsf.shape[0], self.action_dim, dtype=torch.long,
                           device=self.device)
        for _ in range(cl_num):
            prev, _, _ = self._act(env_state, prev)
            env_state, _ = self.env.step(env_state, prev)
        return env_state, prev

    def train_on_batch(self, instances, cl_num: int = 0):
        """Reset, warm up, then ``T_train // n_step`` segments."""
        env_state = self.env.reset(instances, self.generator)
        env_state, prev_action = self.warmup(env_state, cl_num)
        if self.CL_best:
            env_state, _ = self.env.step_to_solution(env_state, env_state.rec_best)
        metrics = {}
        for _ in range(self.T_train // self.n_step):
            env_state, prev_action, metrics = self.segment(env_state, prev_action)
        return env_state, metrics

    def train_step(self, batch_size: int) -> dict:
        """One trainer step: a fresh batch improved for ``T_train`` moves."""
        cl_num = 0
        if self.steps_per_epoch_hint > 0:
            cl_num = int(math.ceil(self.calls // self.steps_per_epoch_hint * self.CL_scalar))
        self.calls += 1
        instances = self.env.generate(batch_size, self.generator, self.device)
        _, metrics = self.train_on_batch(instances, cl_num)
        metrics = dict(metrics)
        metrics["reward"] = -metrics.pop("cost_bsf")
        return metrics

    @torch.no_grad()
    def evaluate(self, instances, t_max: Optional[int] = None, generator=None) -> dict:
        """``t_max`` (default ``T_test``) sampled moves from a random tour;
        the mean initial and best costs."""
        generator = generator or self.generator
        env_state = self.env.reset(instances, generator)
        cost_init = env_state.cost_current
        prev = torch.zeros(cost_init.shape[0], self.action_dim, dtype=torch.long,
                           device=self.device)
        for _ in range(t_max or self.T_test):
            prev, _, _ = self.act_fn(self.policy, env_state, self.train_spec, generator, prev)
            env_state, _ = self.env.step(env_state, prev)
        return {"cost_init": cost_init.mean(), "cost_bsf": env_state.cost_bsf.mean()}

    def make_eval_step(self, spec=None):
        t_max = self.eval_t_max or self.T_test

        def eval_step(instances) -> dict:
            m = self.evaluate(instances, t_max)
            return {"reward": -m["cost_bsf"], "cost_init": m["cost_init"]}

        return eval_step

    def epoch_end(self, host: dict) -> dict:
        return host

    def state_dict(self) -> dict:
        return {"policy": self.policy.state_dict(), "critic": self.critic.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step,
                "calls": self.calls}

    def load_state_dict(self, state: dict) -> None:
        self.policy.load_state_dict(state["policy"])
        self.critic.load_state_dict(state["critic"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.calls = int(state["step"]), int(state["calls"])
