"""Data parallelism: counterpart of ``pcp_tpu/parallel``."""
from .collective import (all_gather_objects, all_reduce_gradients, all_reduce_sum,
                         average_reduce_value, barrier, get_dist_info, merge_results_dist,
                         reduce_dict)
from .mesh import process_group, replicate_state, shard_batch
