"""Sharded serving: rank meshes, sharding rules and per-shard bodies, the
layer pipeline, the process group and the controller/follower event bus
(PyTorch port of tpuserve/parallel/)."""

from tpuserve_torch.parallel.mesh import make_mesh  # noqa: F401
from tpuserve_torch.parallel.sharding import (  # noqa: F401
    cache_pspec,
    llama_param_pspecs,
    shard_llama_params,
)
