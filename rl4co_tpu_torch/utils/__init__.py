from rl4co_tpu_torch.utils.ops import (  # noqa: F401
    gather_by_index,
    get_distance,
    get_distance_matrix,
    get_tour_length,
    unbatchify,
    batchify,
    calculate_entropy,
)
