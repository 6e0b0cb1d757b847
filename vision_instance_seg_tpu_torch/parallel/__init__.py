"""Data and tensor parallelism over processes: host comm, the mesh rules
(the (data, model) shape, the parameters the 'model' axis splits), the
step's batch shard, the tensor-parallel layers and the process launcher
(the port's counterpart of ``vision_instance_seg_tpu/parallel/``)."""

from vision_instance_seg_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_size, mesh_shape, param_shardings, shard_batch)
