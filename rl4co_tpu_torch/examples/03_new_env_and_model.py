"""Creating a new environment and wiring a model to it.

The port's counterpart of `examples/03_new_env_and_model.py`: a **k-center**
problem (choose k facilities minimising the largest distance of any point to
its nearest facility, the minimax sibling of the built-in FLP), registered
with its init and context embeddings, and AttentionModel trained on it end
to end (the decoder's single-query pointer kernel at every step).

The recipe for any new env:
1. a dataclass state of batched tensors,
2. a frozen `Env` dataclass with batched `generate/reset/step/action_mask/
   reward` (+ `num_actions`/`max_steps`),
3. `register_env(name, cls)`,
4. an init embedding and a context embedding in the registries (the AM
   decoder's query is built from these).

Run: python3 rl4co_tpu_torch/examples/03_new_env_and_model.py [--device cpu]
"""

import argparse
import dataclasses
import math
import os
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from rl4co_tpu_torch.envs import get_env, register_env  # noqa: E402
from rl4co_tpu_torch.envs.base import Env, Instance  # noqa: E402
from rl4co_tpu_torch.models import AttentionModelPolicy  # noqa: E402
from rl4co_tpu_torch.models.nn.env_embeddings.context import (  # noqa: E402
    CONTEXT_EMBEDDING_REGISTRY,
    gather_rows,
)
from rl4co_tpu_torch.models.nn.env_embeddings.init import INIT_EMBEDDING_REGISTRY  # noqa: E402
from rl4co_tpu_torch.rl.reinforce import REINFORCE  # noqa: E402
from rl4co_tpu_torch.trainer import Trainer, TrainerConfig  # noqa: E402
from rl4co_tpu_torch.utils.device import resolve_device  # noqa: E402
from rl4co_tpu_torch.utils.ops import get_distance_matrix  # noqa: E402


# ---- 1+2: state + env -------------------------------------------------------

@dataclasses.dataclass
class KCenterState:
    locs: torch.Tensor            # [B, N, 2]
    orig_distances: torch.Tensor  # [B, N, N]
    distances: torch.Tensor       # [B, N] running min distance to the chosen set
    chosen: torch.Tensor          # bool [B, N]
    i: torch.Tensor               # int64 [B]
    done: torch.Tensor            # bool [B]


@dataclasses.dataclass(frozen=True)
class KCenter(Env):
    name = "kcenter"
    num_loc: int = 20
    k: int = 4

    def generate(self, batch_size: int, generator: Optional[torch.Generator] = None,
                 device="cuda") -> Instance:
        return {"locs": torch.rand((batch_size, self.num_loc, 2), generator=generator,
                                   device=resolve_device(device))}

    def reset(self, instances: Instance) -> KCenterState:
        locs = instances["locs"]
        b, dev = locs.shape[0], locs.device
        return KCenterState(
            locs=locs,
            orig_distances=get_distance_matrix(locs),
            distances=torch.full((b, self.num_loc), math.sqrt(2.0), device=dev),
            chosen=torch.zeros((b, self.num_loc), dtype=torch.bool, device=dev),
            i=torch.zeros((b,), dtype=torch.long, device=dev),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
        )

    def step(self, state: KCenterState, action: torch.Tensor) -> KCenterState:
        action = action.long()
        row = torch.gather(state.orig_distances, 1,
                           action[:, None, None].expand(-1, 1, self.num_loc))[:, 0]
        # absorbing once done (padded steps must not change anything)
        frozen = state.done
        return KCenterState(
            locs=state.locs,
            orig_distances=state.orig_distances,
            distances=torch.where(frozen[:, None], state.distances,
                                  torch.minimum(state.distances, row)),
            chosen=torch.where(frozen[:, None], state.chosen,
                               state.chosen.scatter(1, action[:, None], True)),
            i=torch.where(frozen, state.i, state.i + 1),
            done=torch.where(frozen, state.done, state.i >= self.k - 1),
        )

    def action_mask(self, state: KCenterState) -> torch.Tensor:
        pad = torch.zeros_like(state.chosen)
        pad[:, 0] = True
        return torch.where(state.done[:, None], pad, ~state.chosen)

    def reward(self, state: KCenterState, actions: torch.Tensor) -> torch.Tensor:
        return -state.distances.max(dim=-1).values   # minimax objective

    @property
    def num_actions(self) -> int:
        return self.num_loc

    @property
    def max_steps(self) -> int:
        return self.k

    def check_solution_validity(self, instance, actions) -> None:
        if isinstance(actions, torch.Tensor):
            actions = actions.detach().cpu().numpy()
        for a in np.atleast_2d(np.asarray(actions))[:, : self.k]:
            assert len(np.unique(a)) == self.k, "duplicate facilities"


# ---- 4: embeddings -----------------------------------------------------------

class KCenterInitEmbedding(nn.Module):
    """Node features -> d-dim tokens for the encoder."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.init_embed = nn.Linear(2, embed_dim)

    def forward(self, instances) -> torch.Tensor:
        return self.init_embed(instances["locs"])


class KCenterContext(nn.Module):
    """Decoder query: embedding of the current worst-covered point."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.project_context = nn.Linear(embed_dim, embed_dim, bias=False)

    def forward(self, embeddings: torch.Tensor, state) -> torch.Tensor:
        worst = state.distances.argmax(dim=-1)                   # [B']
        return self.project_context(gather_rows(embeddings, worst))


def register():
    """Put the env and its embeddings into the port's registries."""
    register_env("kcenter", KCenter)
    INIT_EMBEDDING_REGISTRY["kcenter"] = KCenterInitEmbedding
    CONTEXT_EMBEDDING_REGISTRY["kcenter"] = KCenterContext


# ---- 3: registration + training ---------------------------------------------

def main(num_loc=20, k=4, epochs=2, batch_size=64, train_data_size=2_048, val_data_size=128,
         device="cuda"):
    device = resolve_device(device)
    register()
    torch.manual_seed(0)
    env = get_env("kcenter", num_loc=num_loc, k=k)
    policy = AttentionModelPolicy(env_name="kcenter", embed_dim=64, num_encoder_layers=2,
                                  use_graph_context=False, device=device)
    algo = REINFORCE(env=env, policy=policy, baseline="exponential", lr=1e-4)
    trainer = Trainer(algo, TrainerConfig(
        epochs=epochs, batch_size=batch_size, train_data_size=train_data_size,
        val_data_size=val_data_size, val_batch_size=val_data_size,
    ))
    trainer.fit()
    last_val = [r for r in trainer.history if "val/reward" in r][-1]
    cost = -float(last_val["val/reward"])
    print(f"k-center val max-distance after training: {cost:.4f} "
          f"(random k points ~0.35-0.45)")
    return {"val_max_distance": cost}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
