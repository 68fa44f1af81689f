from spinglass_tpu_torch.distributed import pt_sharded, rl_sharded
from spinglass_tpu_torch.distributed import model_sharded  # noqa: F401
from spinglass_tpu_torch.distributed.coordinator import JobCoordinator, Job, JobStatus
from spinglass_tpu_torch.distributed.workpool import WorkStealingQueue, WorkerPool
from spinglass_tpu_torch.distributed.edge import EdgeNode, EdgeOrchestrator
from spinglass_tpu_torch.distributed.multihost import (initialize as multihost_initialize, replica_mesh, hybrid_mesh)
