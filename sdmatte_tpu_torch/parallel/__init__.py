"""Training, video and multi-device (sdmatte_tpu/parallel/)."""

from .mesh import (make_mesh, make_hybrid_mesh, distributed_init,  # noqa: F401
                   shard_batch, replicate, data_spec)
from .train import train_step, init_train_state  # noqa: F401
