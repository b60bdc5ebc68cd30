from rla4mor_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    make_mesh,
    row_range,
)
from rla4mor_tpu_torch.parallel.launch import spawn
from rla4mor_tpu_torch.parallel.sharded_sketch import (
    flat_shard_rows,
    gaussian_block,
    gaussian_sketch_blocked,
    gaussian_sketch_sharded,
    srht_blocked,
    srht_sketch_sharded,
    srht_sketch_sharded_flat,
)
from rla4mor_tpu_torch.parallel.driver import (
    GreedyState,
    init_state,
    make_sharded_greedy_step,
    state_to_rom,
)
from rla4mor_tpu_torch.parallel.embeddings import (
    ShardedGaussianEmbedding,
    ShardedSrhtEmbedding,
)

__all__ = [
    "make_mesh", "axis_size", "axis_index", "axis_group", "row_range", "spawn",
    "flat_shard_rows", "gaussian_block", "gaussian_sketch_blocked",
    "gaussian_sketch_sharded", "srht_blocked", "srht_sketch_sharded",
    "srht_sketch_sharded_flat", "GreedyState", "init_state",
    "make_sharded_greedy_step", "state_to_rom",
    "ShardedGaussianEmbedding", "ShardedSrhtEmbedding",
]
