from rl4co_tpu_torch.models.nn.graph.attnnet import (  # noqa: F401
    GraphAttentionNetwork,
    MultiHeadAttentionLayer,
)
