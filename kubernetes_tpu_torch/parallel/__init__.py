"""The device mesh, node-axis sharded scheduling kernels and device-loss
classification (PyTorch port of ``kubernetes_tpu/parallel``)."""

from .mesh import make_mesh, snapshot_shardings, replicated  # noqa: F401
from .sharded import make_sharded_schedule_batch, shard_snapshot  # noqa: F401
