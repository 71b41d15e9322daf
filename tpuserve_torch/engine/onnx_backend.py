"""ONNX-format backend: model.onnx served on the card (port of
tpuserve/engine/onnx_backend.py).

Reference counterpart: the ONNX Runtime backend — the reference's only
real execution path (model.cpp:825-1035 load/session, :1158-1328 infer
with dynamic-batch handling). The graph is imported once at load
(tpuserve_torch/onnx/importer.py), its initializers moved to the device,
and each request runs the graph's nodes there as PyTorch ops; a dynamic
batch dim is bucketed to a power of two as the zoo backend does.

The reference's own fixture (`create_onnx_test_model`) loads and serves
unmodified.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from tpuserve_torch.engine.backend import Backend, register_backend
from tpuserve_torch.engine.jax_backend import (output_tensors, param_bytes, prepare_inputs,
                                               warmup_inputs)
from tpuserve_torch.repository.repo import ModelType
from tpuserve_torch.utils.device import resolve_device
from tpuserve_torch.utils.errors import BackendError, ValidationError
from tpuserve_torch.utils.tensor import Tensor


@register_backend(ModelType.ONNX)
class OnnxBackend(Backend):
    def __init__(self, model_dir: str, config, device="cuda"):
        super().__init__(model_dir, config, device)
        self.params = None
        self._apply = None
        self._device = None
        self._input_names: List[str] = []
        self._output_names: List[str] = []
        self._param_bytes = 0

    def load(self) -> None:
        from tpuserve_torch.onnx import build, load_model

        self._device = resolve_device(self.device)
        path = os.path.join(self.model_dir, "model.onnx")
        if not os.path.exists(path):
            raise BackendError(f"no model.onnx in {self.model_dir}")
        params, self._apply, self._input_names, self._output_names = build(load_model(path))
        self.params = {k: torch.from_numpy(np.array(v)).to(self._device)
                       for k, v in params.items()}
        self._param_bytes = param_bytes(self.params)

    def warmup(self) -> None:
        if self._apply is None or not self.config.inputs:
            return
        with torch.inference_mode():
            self._apply(self.params, warmup_inputs(self.config, self._device))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def unload(self) -> None:
        self.params = None
        self._apply = None

    def memory_usage_bytes(self) -> int:
        return self._param_bytes

    def metadata_extras(self) -> Dict:
        return {"format": "onnx", "graph_inputs": self._input_names,
                "graph_outputs": self._output_names}

    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        if self._apply is None:
            raise BackendError("model not loaded")
        batch, orig_batch = prepare_inputs(self.config, inputs, self._device)
        missing = [n for n in self._input_names if n not in batch]
        if missing:
            raise ValidationError(f"missing graph inputs: {missing}")
        with torch.inference_mode():
            outputs = self._apply(self.params, batch)
        return output_tensors(self.config, outputs, self._output_names, orig_batch)
