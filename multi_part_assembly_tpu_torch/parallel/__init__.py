"""Data parallelism of the port (counterpart of
multi_part_assembly_tpu/parallel/)."""

from .dist import (all_reduce_, all_reduce_sum, average_gradients, barrier,
                   broadcast_module, destroy, init_distributed, rank,
                   rank_device, rank_seed, world)

__all__ = ['init_distributed', 'rank_device', 'rank', 'world', 'barrier',
           'rank_seed', 'broadcast_module', 'all_reduce_', 'all_reduce_sum',
           'average_gradients', 'destroy']
