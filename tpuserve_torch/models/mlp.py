"""MLP architecture — the test_model family (PyTorch port of
tpuserve/models/mlp.py).

Capability parity with the reference's fixture (scripts/create-test-model.py:
3→5(ReLU)→2 MatMul/Add/Relu graph). `features` and `activation` come from
config.model_params; layer i uses params "dense{i+1}/kernel|bias".
"""

from __future__ import annotations

from typing import Dict

import torch

from tpuserve_torch.models.layers import activation, linear
from tpuserve_torch.models.registry import Architecture, register_architecture


@register_architecture("mlp")
class MLP(Architecture):
    def _features(self):
        return [int(f) for f in self.params_cfg.get("features", [5, 2])]

    def _in_features(self) -> int:
        if self.config.inputs:
            return int(self.config.inputs[0].shape[-1])
        return int(self.params_cfg.get("in_features", 3))

    def _io_names(self):
        in_name = self.config.inputs[0].name if self.config.inputs else "input"
        out_name = self.config.outputs[0].name if self.config.outputs else "output"
        return in_name, out_name

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        params: Dict[str, torch.Tensor] = {}
        dims = [self._in_features()] + self._features()
        for i in range(len(dims) - 1):
            params[f"dense{i+1}/kernel"] = self._normal(generator, (dims[i], dims[i + 1]), 1.0,
                                                        torch.float32)
            params[f"dense{i+1}/bias"] = self._normal(generator, (dims[i + 1],), 1.0,
                                                      torch.float32)
        return params

    def apply(self, params: Dict, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        in_name, out_name = self._io_names()
        x = inputs[in_name]
        act = activation(self.params_cfg.get("activation", "relu"))
        n_layers = len(self._features())
        for i in range(n_layers):
            x = linear(params, f"dense{i+1}", x)
            if i < n_layers - 1:
                x = act(x)
        return {out_name: x}
