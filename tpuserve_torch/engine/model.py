"""Model: a loaded, servable model instance.

PyTorch port of tpuserve/engine/model.py. Reference counterpart:
`Model`/`ModelImpl` (model.cpp:448-1525, model.h:129-180) — backend
dispatch, input validation (model.cpp:734-794), per-model stats updated
around each Infer (:607-610), and load-time measurement (:505-545).
Inference goes through the dynamic micro-batcher (engine/batcher.py),
which coalesces concurrent requests to the graph backends (`platform` jax
and onnx) when the config sets `dynamic_batching`, and caps forwards in
flight at `instance_count`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from tpuserve_torch.engine.backend import Backend, create_backend
from tpuserve_torch.engine.batcher import MicroBatcher
from tpuserve_torch.engine.stats import ModelStats
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.repository.repo import ModelType
from tpuserve_torch.utils.errors import BackendError, ValidationError
from tpuserve_torch.utils.tensor import Tensor


@dataclasses.dataclass
class ModelMetadata:
    """≙ ModelMetadata (model.h:81-90)."""

    name: str
    version: str
    type: str
    inputs: List[Dict]
    outputs: List[Dict]
    description: str = ""
    load_time_ns: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class Model:
    def __init__(self, model_dir: str, model_type: ModelType, config: ModelConfig,
                 device="cuda"):
        self.model_dir = model_dir
        self.model_type = model_type
        self.config = config
        self.device = device
        self.stats = ModelStats()
        self.backend: Backend = create_backend(model_type, model_dir, config, device)
        self._loaded = False
        self._last_error: Optional[str] = None

    # ------------------------------------------------------------------
    def load(self) -> None:
        """Load + warmup, measuring load time (≙ model.cpp:503-545)."""
        t0 = time.perf_counter_ns()
        try:
            self.backend.load()
            self.backend.warmup()
        except Exception as e:
            self._last_error = str(e)
            raise
        self.stats.set_load_time(time.perf_counter_ns() - t0)
        self.stats.set_memory_usage(self.backend.memory_usage_bytes())
        # dynamic micro-batching + instance cap for graph models (makes the
        # reference's dead config flags real — engine/batcher.py)
        batchable = [t.name for t in self.config.inputs if t.shape and t.shape[0] == -1]
        self._batcher = MicroBatcher(
            self.backend.infer,
            batch_axis_inputs=batchable,
            max_batch=self.config.max_batch_size,
            instance_count=self.config.instance_count,
            enabled=bool(self.config.dynamic_batching)
            and self.model_type in (ModelType.JAX, ModelType.ONNX),
        )
        self._loaded = True

    def unload(self) -> None:
        self.backend.unload()
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    @property
    def last_error(self) -> Optional[str]:
        return self._last_error

    # ------------------------------------------------------------------
    def validate_inputs(self, inputs: List[Tensor]) -> None:
        """Count/name/dtype/shape checks with -1 dynamic dims
        (≙ ModelImpl::ValidateInputs, model.cpp:734-794)."""
        declared = self.config.inputs
        if not declared:
            return  # config declares nothing; accept as-is
        if len(inputs) != len(declared):
            raise ValidationError(
                f"expected {len(declared)} inputs, got {len(inputs)}"
            )
        by_name = {t.name: t for t in inputs}
        for decl in declared:
            t = by_name.get(decl.name)
            if t is None:
                raise ValidationError(f"missing required input '{decl.name}'")
            if decl.data_type != t.dtype:
                raise ValidationError(
                    f"input '{decl.name}': expected dtype {decl.data_type.value}, got {t.dtype.value}"
                )
            if not t.validate_against(decl.shape):
                raise ValidationError(
                    f"input '{decl.name}': shape {list(t.shape)} incompatible with {decl.shape}"
                )

    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        """Validate, run, record stats (≙ ModelImpl::Infer, model.cpp:557-610)."""
        if not self._loaded:
            raise BackendError(f"model '{self.config.name}' is not loaded")
        try:
            self.validate_inputs(inputs)
        except ValidationError:
            self.stats.record_error()
            raise
        t0 = time.perf_counter_ns()
        try:
            outputs = self._batcher.infer(inputs)
        except ValidationError:
            self.stats.record_error()
            raise
        except Exception as e:
            self.stats.record_error()
            self._last_error = str(e)
            raise
        self.stats.record_inference(time.perf_counter_ns() - t0)
        return outputs

    # ------------------------------------------------------------------
    def metadata(self) -> ModelMetadata:
        return ModelMetadata(
            name=self.config.name,
            version=self.config.version,
            type=self.model_type.value,
            inputs=[t.to_dict() for t in self.config.inputs],
            outputs=[t.to_dict() for t in self.config.outputs],
            description=f"{self.config.architecture or self.model_type.value} model",
            load_time_ns=self.stats.load_time_ns,
        )

    def get_stats(self) -> Dict:
        snap = self.stats.snapshot()
        snap["tokens_per_second"] = round(self.stats.tokens_per_second(), 2)
        b = getattr(self, "_batcher", None)
        if b is not None and b.batches:
            snap["dynamic_batches"] = b.batches
            snap["dynamic_batched_requests"] = b.batched_requests
        return snap
