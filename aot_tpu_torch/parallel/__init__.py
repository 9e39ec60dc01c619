"""Data parallelism over processes (counterpart of aot_tpu/parallel)."""

from aot_tpu_torch.parallel.dp import (average_gradients, dp_world_size,
                                       is_live, launch, local_batch,
                                       mean_across_ranks, rank, rank_devices,
                                       world_size)

__all__ = ["average_gradients", "dp_world_size", "is_live", "launch",
           "local_batch", "mean_across_ranks", "rank", "rank_devices",
           "world_size"]
