"""Data parallelism across processes (counterpart of `rl4co_tpu/parallel/`)."""

from rl4co_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
