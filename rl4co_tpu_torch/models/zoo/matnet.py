"""MatNet (Kwon et al. 2021): the matrix-encoding attention model for ATSP
(counterpart of `rl4co_tpu/models/zoo/matnet.py`).

- The encoder keeps row and column embeddings of the cost matrix and updates
  each from the other by cross-attention whose scores are mixed with the
  matrix entries through a small per-head MLP (`MixedScoresAttention`).
- The decoder is AM's: K, V and logit keys from the column embeddings,
  queries from the row embeddings (`TSPContext`), the pointer step through
  the fused kernel. Multistart decoding (POMO) hands the grouped kernel
  every start as a query of its instance.

The mixer's parameters are stored as the JAX package stores them, as the
uniform draw in ``[0, 2·init)``, and shifted by ``init`` in the forward: in
f32, or under a bf16 compute dtype as JAX computes ``bf16(p) - init`` (both
operands and the result rounded to bf16).
The columns start from the deterministic one-hot ``eye(N, D)``, as in the
JAX package (the reference shuffles the slots).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rl4co_tpu_torch.models.nn.attention import _merge_heads, _split_heads
from rl4co_tpu_torch.models.nn.env_embeddings.context import TSPContext
from rl4co_tpu_torch.models.nn.ops import Normalization
from rl4co_tpu_torch.models.policies.constructive import PrecomputedCache
from rl4co_tpu_torch.models.zoo.am import AttentionModelPolicy
from rl4co_tpu_torch.utils.dtype import compute_dtype_in_force

MIX1_INIT = 0.5 ** 0.5
MIX2_INIT = (1 / 16) ** 0.5


def shifted(p: torch.Tensor, init: float) -> torch.Tensor:
    """``p - init`` in the compute dtype in force (f32 without one), back in
    ``p``'s dtype; differentiable."""
    dtype = compute_dtype_in_force()
    if dtype is None:
        return p - init
    return (p.to(dtype) - torch.tensor(init, dtype=dtype, device=p.device)).to(p.dtype)


class MixedScoresAttention(nn.Module):
    """Cross-attention of ``q_input [B, M, D]`` over ``kv_input [B, N, D]``
    whose scores are mixed with ``dmat [B, M, N]``: per head, an MLP of
    (score, entry) -> hidden (ReLU) -> 1 gives the logits of the softmax."""

    def __init__(self, embed_dim: int, num_heads: int = 16, mixer_hidden_dim: int = 16,
                 num_scores: int = 1):
        super().__init__()
        self.num_heads = num_heads
        h, k = num_heads, mixer_hidden_dim
        self.Wq = nn.Linear(embed_dim, embed_dim, bias=False)
        self.Wkv = nn.Linear(embed_dim, 2 * embed_dim, bias=False)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=False)
        # stored as the uniform draw in [0, 2·init); used as param - init
        self.mix_W1 = nn.Parameter(torch.rand(h, num_scores + 1, k) * 2 * MIX1_INIT)
        self.mix_b1 = nn.Parameter(torch.rand(h, k) * 2 * MIX1_INIT)
        self.mix_W2 = nn.Parameter(torch.rand(h, k, 1) * 2 * MIX2_INIT)
        self.mix_b2 = nn.Parameter(torch.rand(h, 1) * 2 * MIX2_INIT)

    def forward(self, q_input, kv_input, dmat):
        h = self.num_heads
        q = _split_heads(self.Wq(q_input), h)                 # [B, H, M, hd]
        k, v = (_split_heads(t, h) for t in self.Wkv(kv_input).chunk(2, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])  # [B, H, M, N]
        feats = torch.stack([scores, dmat[:, None].expand_as(scores)], dim=-1)  # [..., 2]
        w1, b1 = shifted(self.mix_W1, MIX1_INIT), shifted(self.mix_b1, MIX1_INIT)
        w2, b2 = shifted(self.mix_W2, MIX2_INIT), shifted(self.mix_b2, MIX2_INIT)
        hmix = torch.relu(torch.einsum("bhmns,hsk->bhmnk", feats, w1)
                          + b1[None, :, None, None, :])
        mixed = (torch.einsum("bhmnk,hko->bhmno", hmix, w2) + b2[None, :, None, None, :])[..., 0]
        out = torch.matmul(torch.softmax(mixed, dim=-1), v)   # [B, H, M, hd]
        return self.out_proj(_merge_heads(out))


class MatNetLayer(nn.Module):
    """One row/column update: ``row_block`` (rows attend to columns over
    ``dmat``), ``col_block`` (columns to rows over its transpose), then per
    side ``Norm(x_new + x_old)``, a ReLU feed-forward and ``Norm`` again
    (``F_a_*`` for rows, ``F_b_*`` for columns)."""

    def __init__(self, embed_dim: int, num_heads: int = 16, feedforward_hidden: int = 512,
                 normalization: str = "instance"):
        super().__init__()
        self.row_block = MixedScoresAttention(embed_dim, num_heads)
        self.col_block = MixedScoresAttention(embed_dim, num_heads)
        for side in ("F_a", "F_b"):
            self.add_module(f"{side}_norm1", Normalization(embed_dim, normalization))
            self.add_module(f"{side}_ff1", nn.Linear(embed_dim, feedforward_hidden))
            self.add_module(f"{side}_ff2", nn.Linear(feedforward_hidden, embed_dim))
            self.add_module(f"{side}_norm2", Normalization(embed_dim, normalization))

    def _ffn(self, side, x_new, x_old):
        h = getattr(self, f"{side}_norm1")(x_new + x_old)
        f = getattr(self, f"{side}_ff2")(torch.relu(getattr(self, f"{side}_ff1")(h)))
        return getattr(self, f"{side}_norm2")(h + f)

    def forward(self, row_emb, col_emb, dmat):
        row_out = self.row_block(row_emb, col_emb, dmat)
        col_out = self.col_block(col_emb, row_emb, dmat.transpose(-2, -1))
        return self._ffn("F_a", row_out, row_emb), self._ffn("F_b", col_out, col_emb)


class MatNetPolicy(AttentionModelPolicy):
    """MatNet on ATSP at its published widths: embed 256, 16 heads, 5
    layers, feed-forward 512, instance norm, no graph context. AM's decoder
    (`decode_step`) with `TSPContext` and the pointer kernel; no init
    embedding (the encoder starts from zero rows and one-hot columns)."""

    def __init__(self, env_name: str = "atsp", embed_dim: int = 256, num_heads: int = 16,
                 num_encoder_layers: int = 5, feedforward_hidden: int = 512,
                 normalization: str = "instance", use_graph_context: bool = False,
                 pointer_impl: str = "kernel", device="cuda"):
        super().__init__(env_name=env_name, embed_dim=embed_dim,
                         num_encoder_layers=num_encoder_layers, num_heads=num_heads,
                         feedforward_hidden=feedforward_hidden, normalization=normalization,
                         use_graph_context=use_graph_context, pointer_impl=pointer_impl,
                         device=device)

    def _add_embedding(self, name: str, make, kwargs) -> None:
        if name == "context_embedding":  # the JAX policy builds TSP's context directly
            self.context_embedding = TSPContext(self.embed_dim)

    def _make_encoder(self) -> None:
        for i in range(self.num_encoder_layers):
            self.add_module(f"matnet_layer_{i}", MatNetLayer(
                self.embed_dim, self.num_heads, feedforward_hidden=self.feedforward_hidden,
                normalization=self.normalization))
        return None

    def init_embed(self, instances):
        dmat = instances["cost_matrix"]
        b, n, _ = dmat.shape
        row_emb = dmat.new_zeros((b, n, self.embed_dim))
        col_emb = torch.eye(n, self.embed_dim, device=dmat.device, dtype=dmat.dtype)[None].expand(
            b, -1, -1)
        return row_emb, col_emb

    def encode(self, instances):
        dmat = instances["cost_matrix"]
        row_emb, col_emb = self.init_embed(instances)
        for i in range(self.num_encoder_layers):
            row_emb, col_emb = getattr(self, f"matnet_layer_{i}")(row_emb, col_emb, dmat)
        return row_emb, col_emb

    def precompute(self, embeddings) -> PrecomputedCache:
        row_emb, col_emb = embeddings
        glimpse_k, glimpse_v, logit_k = (
            t.contiguous() for t in self.project_node_embeddings(col_emb).chunk(3, dim=-1))
        graph_context = (self.project_fixed_context(col_emb.mean(dim=-2))
                         if self.use_graph_context else 0.0)
        return PrecomputedCache(node_embeddings=row_emb, graph_context=graph_context,
                                glimpse_key=glimpse_k, glimpse_val=glimpse_v,
                                logit_key=logit_k)


def MatNet(env, policy: MatNetPolicy | None = None, policy_kwargs: dict | None = None,
           **kwargs):
    """MatNet: `MatNetPolicy` trained as POMO (multistart over every node,
    shared baseline), without augmentation. Returns a `POMO` algorithm on
    the policy's device (``"cuda"`` unless ``policy_kwargs["device"]`` says
    otherwise)."""
    from rl4co_tpu_torch.models.zoo.pomo import POMO

    if policy is None:
        policy = MatNetPolicy(env_name=env.name, **(policy_kwargs or {}))
    return POMO(env, policy=policy, num_augment=1, **kwargs)
