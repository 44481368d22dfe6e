from rl4co_tpu_torch.models.nn.env_embeddings.init import env_init_embedding, INIT_EMBEDDING_REGISTRY  # noqa: F401
from rl4co_tpu_torch.models.nn.env_embeddings.context import env_context_embedding, CONTEXT_EMBEDDING_REGISTRY  # noqa: F401
from rl4co_tpu_torch.models.nn.env_embeddings.dynamic import env_dynamic_embedding, DYNAMIC_EMBEDDING_REGISTRY  # noqa: F401
