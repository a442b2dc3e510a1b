from .mesh import (data_axis_name, data_parallel, init_process_group, make_mesh,
                   model_axis_name, replicate, shard_batch)
from .tp import apply_tp_sharding, tp_full_state_dict, tp_rules_for_lm

__all__ = ["data_axis_name", "data_parallel", "init_process_group", "make_mesh",
           "model_axis_name", "replicate", "shard_batch", "apply_tp_sharding",
           "tp_full_state_dict", "tp_rules_for_lm"]
