from tpuserve_torch.repository.config import (  # noqa: F401
    GenerationConfig,
    ModelConfig,
    QuantizationConfig,
    ShardingConfig,
    TensorConfig,
)
from tpuserve_torch.repository.repo import ModelRepository, ModelType  # noqa: F401
