"""Device mesh and Megatron tensor parallelism over torch.distributed
(one process a rank). Importing it makes no process group."""
from .comm import Comm  # noqa: F401
from .distributed import init_distributed  # noqa: F401
from .mesh import DP_AXIS, TP_AXIS, Mesh, make_mesh, mesh_dims  # noqa: F401
from .sharding import local_config, param_splits, validate_tp  # noqa: F401
