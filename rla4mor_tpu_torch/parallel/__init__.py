from rla4mor_tpu_torch.parallel.sharded_sketch import (
    flat_shard_rows,
    gaussian_block,
    gaussian_sketch_blocked,
    gaussian_sketch_sharded,
)
from rla4mor_tpu_torch.parallel.driver import (
    GreedyState,
    init_state,
    make_sharded_greedy_step,
    state_to_rom,
)

__all__ = [
    "flat_shard_rows", "gaussian_block", "gaussian_sketch_blocked",
    "gaussian_sketch_sharded", "GreedyState", "init_state",
    "make_sharded_greedy_step", "state_to_rom",
]
