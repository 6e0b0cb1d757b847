"""Data parallelism over processes: host comm, the data-axis rule, the
step's batch shard and the process launcher (the port's counterpart of
``vision_instance_seg_tpu/parallel/``)."""

from vision_instance_seg_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_size, shard_batch)
