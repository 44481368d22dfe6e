"""MatNet on FFSP (counterpart of `rl4co_tpu/models/zoo/matnet_ffsp.py`).

Each stage's job x machine run-time matrix is encoded by MatNet's row and
column blocks (jobs are rows, machines columns). A learned no-job row is
appended to the job embeddings for the wait action. At each decode step
the query is ``project_context`` of the current machine's embedding and its
stage's learned embedding; the pointer (with an output bias, so it computes
through `pointer_logits`, as the JAX package's XLA path does) scores the
jobs of the current stage.

The JAX policy rolls the env's mask and the logits by one place on the
assumption that the wait action comes first, while the env puts it last
(`envs/scheduling/ffsp.py`); the port computes exactly the same rolls, so
its schedules are JAX's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import PointerAttention
from rl4co_tpu_torch.models.policies.constructive import ConstructivePolicy
from rl4co_tpu_torch.models.zoo.matnet import MatNetLayer
from rl4co_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class FFSPCache:
    job_embs: torch.Tensor   # [B, S, J+1, D] (the no-job row last)
    ma_embs: torch.Tensor    # [B, S, M, D]
    glimpse_k: torch.Tensor  # [B, S, J+1, D]
    glimpse_v: torch.Tensor
    logit_k: torch.Tensor


class MatNetFFSPPolicy(ConstructivePolicy):
    """Defaults are the JAX module's (64 wide, 4 heads, 2 layers, FFN 128,
    instance norm); the MatNet paper's FFSP runs use 256 / 16 heads / 3
    layers / 512."""

    def __init__(self, env_name: str = "ffsp", num_stage: int = 2, num_machine: int = 3,
                 embed_dim: int = 64, num_heads: int = 4, num_encoder_layers: int = 2,
                 feedforward_hidden: int = 128, normalization: str = "instance",
                 scaling_factor: float = 10.0, mask_inner: bool = True, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.env_name = env_name
        self.num_stage, self.num_machine = num_stage, num_machine
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_encoder_layers = num_encoder_layers
        self.scaling_factor = scaling_factor
        for i in range(num_encoder_layers):
            self.add_module(f"matnet_layer_{i}", MatNetLayer(
                embed_dim, num_heads, feedforward_hidden=feedforward_hidden,
                normalization=normalization))
        self.no_job_emb = nn.Parameter(torch.rand(embed_dim))
        self.stage_emb = nn.Parameter(torch.rand(num_stage, embed_dim))
        self.project_node_embeddings = nn.Linear(embed_dim, 3 * embed_dim, bias=False)
        self.project_context = nn.Linear(2 * embed_dim, embed_dim, bias=False)
        self.pointer = PointerAttention(embed_dim, num_heads, impl="plain",
                                        mask_inner=mask_inner, out_bias=True)
        self.to(device)

    def encode(self, instances):
        run_time = instances["run_time"].float()        # [B, J, M_total]
        b, j, _ = run_time.shape
        s, m, d = self.num_stage, self.num_machine, self.embed_dim
        dmat = run_time.reshape(b, j, s, m).permute(0, 2, 1, 3).reshape(b * s, j, m)
        dmat = dmat / self.scaling_factor
        row = dmat.new_zeros((b * s, j, d))
        col = torch.eye(m, d, device=dmat.device)[None].expand(b * s, -1, -1)
        for i in range(self.num_encoder_layers):
            row, col = getattr(self, f"matnet_layer_{i}")(row, col, dmat)
        no_job = self.no_job_emb[None, None, None, :].expand(b, s, 1, d)
        job_embs = torch.cat([row.reshape(b, s, j, d), no_job], dim=2)
        return job_embs, col.reshape(b, s, m, d)

    def precompute(self, embeddings) -> FFSPCache:
        job_embs, ma_embs = embeddings
        gk, gv, lk = self.project_node_embeddings(job_embs).chunk(3, dim=-1)
        return FFSPCache(job_embs=job_embs, ma_embs=ma_embs, glimpse_k=gk, glimpse_v=gv,
                         logit_k=lk)

    def decode_step(self, cache: FFSPCache, state, mask, num_repeats: int = 1):
        if num_repeats != 1:
            raise ValueError("MatNet-FFSP decodes one query per instance (as in JAX)")
        bidx = torch.arange(mask.shape[0], device=mask.device)
        stage, ma = state.stage_idx, state.stage_machine_idx
        gk, gv, lk = (t[bidx, stage] for t in (cache.glimpse_k, cache.glimpse_v,
                                               cache.logit_k))      # [B, J+1, D]
        query = self.project_context(torch.cat([cache.ma_embs[bidx, stage, ma],
                                                self.stage_emb[stage]], dim=-1))
        pointer_mask = torch.cat([mask[:, 1:], mask[:, :1]], dim=-1)
        logits = self.pointer(query, gk, gv, lk, pointer_mask)
        return torch.cat([logits[:, -1:], logits[:, :-1]], dim=-1)
