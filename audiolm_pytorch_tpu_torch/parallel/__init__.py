from .mesh import (data_axis_name, data_parallel, init_process_group, make_mesh, replicate,
                   shard_batch)

__all__ = ["data_axis_name", "data_parallel", "init_process_group", "make_mesh", "replicate",
           "shard_batch"]
