from .mesh import (Rank, SlotShard, all_gather_rows, all_reduce_sum_, barrier,
                   broadcast_object, current, destroy, init_from_env, init_process_group,
                   make_mesh)
