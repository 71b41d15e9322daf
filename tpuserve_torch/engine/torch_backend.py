"""PyTorch backend: TorchScript `model.pt` archives (port of
tpuserve/engine/torch_backend.py).

The reference declares a PyTorch backend but stubs it out with "not
implemented" (model.cpp:1130-1149). The JAX package runs the archive on
the host CPU (`map_location="cpu"`); the port loads it onto its device and
moves each request's inputs there and the outputs back, so a TorchScript
model runs on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from tpuserve_torch.engine.backend import Backend, register_backend
from tpuserve_torch.repository.repo import ModelType
from tpuserve_torch.utils.device import resolve_device
from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import BackendError
from tpuserve_torch.utils.tensor import Tensor


@register_backend(ModelType.PYTORCH)
class TorchBackend(Backend):
    def __init__(self, model_dir: str, config, device="cuda"):
        super().__init__(model_dir, config, device)
        self._module = None
        self._device = None

    def load(self) -> None:
        self._device = resolve_device(self.device)
        path = os.path.join(self.model_dir, "model.pt")
        if not os.path.exists(path):
            raise BackendError(f"model.pt not found in {self.model_dir}")
        try:
            self._module = torch.jit.load(path, map_location=self._device)
        except (RuntimeError, ValueError) as e:
            raise BackendError(f"failed to load TorchScript model: {e}")
        self._module.eval()

    def unload(self) -> None:
        self._module = None

    def memory_usage_bytes(self) -> int:
        if self._module is None:
            return 0
        return sum(p.numel() * p.element_size() for p in self._module.parameters())

    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        if self._module is None:
            raise BackendError("model not loaded")
        # positional order follows the config's declared inputs
        order = [t.name for t in self.config.inputs] or [t.name for t in inputs]
        by_name = {t.name: t for t in inputs}
        args = [torch.from_numpy(np.require(by_name[n].numpy(), requirements=["C", "W"]))
                .to(self._device) for n in order]
        with torch.inference_mode():
            out = self._module(*args)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        names = [t.name for t in self.config.outputs]
        result = []
        for i, o in enumerate(outs):
            arr = o.detach().cpu().numpy()
            name = names[i] if i < len(names) else f"output_{i}"
            result.append(Tensor(name=name, dtype=DataType.from_np(arr.dtype), shape=arr.shape,
                                 data=arr))
        return result
