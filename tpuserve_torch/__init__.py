"""tpuserve_torch — the PyTorch + CUDA port of tpuserve for NVIDIA Hopper.

The JAX package `tpuserve/` stays the reference: every module here keeps
the path and names of its JAX counterpart, and the tests hold each against
it. Plain tensor code is PyTorch; every Pallas kernel on the ported path is
a hand-written CUDA kernel under `csrc/` (built with nvcc for sm_90a at
first use, see `kernels.py`), with a plain PyTorch version beside it that
runs only for tensors on the CPU.

Ported so far: the quantized Llama serving path — InferenceManager ->
LLMBackend -> GenerationEngine -> models.llama -> {quant-matmul, flat-cache
decode attention} kernels -> sampling — plus the device smoke kernel.
Importing this package imports neither JAX nor `tpuserve`.
"""

__version__ = "0.1.0"

from tpuserve_torch.utils.dtypes import DataType  # noqa: F401
from tpuserve_torch.utils.tensor import Tensor  # noqa: F401
from tpuserve_torch.repository.config import (  # noqa: F401
    GenerationConfig,
    ModelConfig,
    QuantizationConfig,
    ShardingConfig,
    TensorConfig,
)
from tpuserve_torch.repository.repo import ModelRepository, ModelType  # noqa: F401
