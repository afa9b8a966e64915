from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    ResilientTrainer, StragglerMonitor)
from repro_torch.distributed.sharding import (host_submesh,  # noqa: F401
                                              stream_shard_placement)
