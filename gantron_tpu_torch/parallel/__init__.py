from gantron_tpu_torch.parallel.distributed import (barrier, is_chief,
                                                    process_count,
                                                    process_index)
from gantron_tpu_torch.parallel.mesh import (make_mesh, pad_batch_rows,
                                             shard_batch, shard_state)

__all__ = ["barrier", "is_chief", "make_mesh", "pad_batch_rows",
           "process_count", "process_index", "shard_batch", "shard_state"]
