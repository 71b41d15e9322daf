"""Quantized-LLM backend: continuous batching over the flat KV cache
(PyTorch port of tpuserve/engine/llm_backend.py)."""

from __future__ import annotations

from typing import List

from tpuserve_torch.engine.backend import Backend, register_backend
from tpuserve_torch.repository.repo import ModelType
from tpuserve_torch.utils.errors import BackendError
from tpuserve_torch.utils.tensor import Tensor


@register_backend(ModelType.LLM)
class LLMBackend(Backend):
    def __init__(self, model_dir: str, config, device="cuda"):
        super().__init__(model_dir, config, device)
        self._engine = None

    def load(self) -> None:
        from tpuserve_torch.serving.engine import GenerationEngine

        self._engine = GenerationEngine(self.model_dir, self.config, device=self.device)
        self._engine.start()

    def unload(self) -> None:
        if self._engine is not None:
            self._engine.stop()
            self._engine = None

    def memory_usage_bytes(self) -> int:
        return self._engine.memory_usage_bytes() if self._engine else 0

    @property
    def engine(self):
        if self._engine is None:
            raise BackendError("model not loaded")
        return self._engine

    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        """Tensor-style entry: 'input_ids' int32 [1, L] (+ optional
        'max_new_tokens' int32 [1]) -> 'output_ids' int32 [1, L']."""
        return self.engine.infer_tensors(inputs)

    def generate(self, prompt_ids, **kw):
        return self.engine.generate(prompt_ids, **kw)
