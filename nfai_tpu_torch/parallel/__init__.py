"""Device mesh, Megatron tensor parallelism, sequence and expert parallelism
and the pipeline stage split over torch.distributed (one process a rank).
Importing it makes no process group."""
from .comm import Comm  # noqa: F401
from .distributed import init_distributed  # noqa: F401
from .expert_parallel import expert_split, moe_ffn_ep  # noqa: F401
from .mesh import DP_AXIS, SP_AXIS, TP_AXIS, Mesh, make_mesh, mesh_dims  # noqa: F401
from .pipeline_parallel import pp_forward, split_cache, split_stages, stage_config  # noqa: F401
from .seq_parallel import (  # noqa: F401
    local_flash, merge, sp_decode_attention, sp_decode_attention_merged, sp_decode_attention_ring,
)
from .sharding import local_config, param_splits, validate_tp  # noqa: F401
