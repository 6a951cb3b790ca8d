from .mesh import (build_sharded_conditional_sampler,
                   build_sharded_train_step, data_parallel_mesh, make_mesh,
                   shard_samples)
from .multihost import (destroy_process_group, host_parallel_enabled,
                        init_process_group, train_chunked)
from .scheduler import ParallelNFiSAM, wavefronts
