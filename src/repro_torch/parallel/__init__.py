"""Distribution substrate of the port, over ``torch.distributed`` DeviceMesh
and DTensor: the parallel context, sharding rules, gradient compression and
pipeline parallelism. Counterpart of ``repro/parallel``."""
from repro_torch.parallel.ctx import ParallelCtx  # noqa: F401
