"""DenseNet family (DenseNet-121 default; PyTorch port of
tpuserve/models/densenet.py) — the counterpart of the reference
repository's densenet_onnx entry (input data_0 [1,3,224,224] -> fc6_1
[1,1000,1,1] with ImageNet labels), INT8 weight-only.

Dense blocks with bottleneck (BN-ReLU-Conv1x1 -> BN-ReLU-Conv3x3, growth
k=32), transition layers with 0.5 compression. Conv kernels stored flat
[h*w*cin, cout] for the INT8 quantizer. Accepts NHWC or the reference's
NCHW layout (transposed to NHWC, which runs as channels_last); computes in
bf16; output shape follows the config (e.g. [B,1000,1,1] reference compat
or [B,1000]).
"""

from __future__ import annotations

from typing import Dict

import torch

from tpuserve_torch.models.layers import avg_pool, batch_norm_inference, conv2d, linear, max_pool
from tpuserve_torch.models.registry import Architecture, register_architecture

_LAYOUTS = {
    "densenet121": [6, 12, 24, 16],
    "densenet169": [6, 12, 32, 32],
}


def image_input(x, device) -> torch.Tensor:
    """A 4-D image batch in NHWC bf16 on `device`; NCHW input (the
    reference's layout: channel dim 3 first, not last) is transposed."""
    x = torch.as_tensor(x).to(device)
    if x.dim() != 4:
        raise ValueError(f"image input must be 4-D, got {tuple(x.shape)}")
    if x.shape[1] == 3 and x.shape[-1] != 3:
        x = x.permute(0, 2, 3, 1)
    return x.to(torch.bfloat16)


def bn_params(params: Dict, prefix: str, c: int, device) -> None:
    """Identity inference BN stats in bf16, as the JAX package inits them."""
    for k, fill in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
        params[f"{prefix}/{k}"] = torch.full((c,), fill, dtype=torch.bfloat16, device=device)


class _DenseNetBase(Architecture):
    blocks = _LAYOUTS["densenet121"]
    growth = 32

    def _num_classes(self) -> int:
        if self.config.outputs:
            shape = self.config.outputs[0].shape
            return int(max(shape[1:]) if len(shape) > 1 else shape[-1])
        return int(self.params_cfg.get("num_classes", 1000))

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        params: Dict[str, torch.Tensor] = {}

        def conv(prefix, kh, kw, cin, cout):
            fan_in = kh * kw * cin
            params[f"{prefix}/kernel"] = self._normal(generator, (kh * kw * cin, cout),
                                                      (2.0 / fan_in) ** 0.5)

        def bn(prefix, c):
            bn_params(params, prefix, c, self.device)

        conv("stem/conv", 7, 7, 3, 64)
        bn("stem/bn", 64)
        c = 64
        for bi, n_layers in enumerate(self.blocks):
            for li in range(n_layers):
                pre = f"block{bi}/layer{li}"
                bn(f"{pre}/bn1", c)
                conv(f"{pre}/conv1", 1, 1, c, 4 * self.growth)
                bn(f"{pre}/bn2", 4 * self.growth)
                conv(f"{pre}/conv2", 3, 3, 4 * self.growth, self.growth)
                c += self.growth
            if bi < len(self.blocks) - 1:
                bn(f"trans{bi}/bn", c)
                conv(f"trans{bi}/conv", 1, 1, c, c // 2)
                c = c // 2
        bn("final/bn", c)
        n = self._num_classes()
        params["head/kernel"] = self._normal(generator, (c, n), 0.01)
        params["head/bias"] = torch.zeros((n,), dtype=torch.bfloat16, device=self.device)
        return params

    def apply(self, params: Dict, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        in_name = self.config.inputs[0].name if self.config.inputs else "data_0"
        out_cfg = self.config.outputs[0] if self.config.outputs else None
        out_name = out_cfg.name if out_cfg else "logits"
        x = image_input(inputs[in_name], self.device)

        x = conv2d(params, "stem/conv", x, kernel_hw=(7, 7), stride=2)
        x = torch.relu(batch_norm_inference(params, "stem/bn", x))
        x = max_pool(x, 3, 2)

        for bi, n_layers in enumerate(self.blocks):
            for li in range(n_layers):
                pre = f"block{bi}/layer{li}"
                y = torch.relu(batch_norm_inference(params, f"{pre}/bn1", x))
                y = conv2d(params, f"{pre}/conv1", y, kernel_hw=(1, 1))
                y = torch.relu(batch_norm_inference(params, f"{pre}/bn2", y))
                y = conv2d(params, f"{pre}/conv2", y, kernel_hw=(3, 3))
                x = torch.cat([x, y], dim=-1)
            if bi < len(self.blocks) - 1:
                x = torch.relu(batch_norm_inference(params, f"trans{bi}/bn", x))
                x = conv2d(params, f"trans{bi}/conv", x, kernel_hw=(1, 1))
                x = avg_pool(x, 2, 2)

        x = torch.relu(batch_norm_inference(params, "final/bn", x))
        x = x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)
        logits = linear(params, "head", x).to(torch.float32)
        if out_cfg and len(out_cfg.shape) == 4:  # reference fc6_1 [B,1000,1,1]
            logits = logits[:, :, None, None]
        return {out_name: logits}


@register_architecture("densenet121")
class DenseNet121(_DenseNetBase):
    blocks = _LAYOUTS["densenet121"]


@register_architecture("densenet169")
class DenseNet169(_DenseNetBase):
    blocks = _LAYOUTS["densenet169"]
