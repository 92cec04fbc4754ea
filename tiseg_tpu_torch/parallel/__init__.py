from .data import (all_reduce_sum, check_equal_rows, check_replicas, data_parallel, gather_rows, global_batch,
                   global_batch_from_local, local_batch_size, reduce_gradients, shard_batch)
from .mesh import (barrier, broadcast_object, default_backend, init_distributed, launcher_group, local_device,
                   same_on_every_rank)

__all__ = ['all_reduce_sum', 'barrier', 'broadcast_object', 'check_equal_rows', 'check_replicas', 'data_parallel',
           'default_backend', 'gather_rows', 'global_batch', 'global_batch_from_local', 'init_distributed',
           'launcher_group', 'local_batch_size', 'local_device', 'reduce_gradients', 'same_on_every_rank',
           'shard_batch']
