"""ResNet family (ResNet-50 default; PyTorch port of
tpuserve/models/resnet.py).

NHWC (run as channels_last), inference-mode BN, bottleneck blocks. Conv
kernels are stored flat ([h*w*cin, cout]) so the INT8 weight-only
quantizer covers them; `conv2d` dequantizes per call. Inputs accept NHWC
[B,224,224,3] or NCHW [B,3,224,224] (transposed).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from tpuserve_torch.models.densenet import bn_params, image_input
from tpuserve_torch.models.layers import batch_norm_inference, conv2d, linear, max_pool
from tpuserve_torch.models.registry import Architecture, register_architecture

_STAGES = {  # resnet50/101 bottleneck layout
    "resnet50": [3, 4, 6, 3],
    "resnet101": [3, 4, 23, 3],
}


class _ResNetBase(Architecture):
    stages: List[int] = [3, 4, 6, 3]

    def _num_classes(self) -> int:
        if self.config.outputs:
            return int(self.config.outputs[0].shape[-1])
        return int(self.params_cfg.get("num_classes", 1000))

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        params: Dict[str, torch.Tensor] = {}

        def conv(name, kh, kw, cin, cout):
            params[name] = self._normal(generator, (kh * kw * cin, cout),
                                        (2.0 / (kh * kw * cin)) ** 0.5)

        conv("stem/conv/kernel", 7, 7, 3, 64)
        bn_params(params, "stem/bn", 64, self.device)
        cin = 64
        for si, blocks in enumerate(self.stages):
            width = 64 * (2 ** si)
            out_c = width * 4
            for bi in range(blocks):
                pre = f"stage{si}/block{bi}"
                conv(f"{pre}/conv1/kernel", 1, 1, cin, width)
                bn_params(params, f"{pre}/bn1", width, self.device)
                conv(f"{pre}/conv2/kernel", 3, 3, width, width)
                bn_params(params, f"{pre}/bn2", width, self.device)
                conv(f"{pre}/conv3/kernel", 1, 1, width, out_c)
                bn_params(params, f"{pre}/bn3", out_c, self.device)
                if bi == 0:
                    conv(f"{pre}/proj/kernel", 1, 1, cin, out_c)
                    bn_params(params, f"{pre}/proj_bn", out_c, self.device)
                cin = out_c
        n = self._num_classes()
        params["head/kernel"] = self._normal(generator, (cin, n), 0.01)
        params["head/bias"] = torch.zeros((n,), dtype=torch.bfloat16, device=self.device)
        return params

    def apply(self, params: Dict, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        in_name = self.config.inputs[0].name if self.config.inputs else "input"
        out_name = self.config.outputs[0].name if self.config.outputs else "logits"
        x = image_input(inputs[in_name], self.device)

        x = conv2d(params, "stem/conv", x, kernel_hw=(7, 7), stride=2)
        x = torch.relu(batch_norm_inference(params, "stem/bn", x))
        x = max_pool(x, 3, 2)

        for si, blocks in enumerate(self.stages):
            for bi in range(blocks):
                pre = f"stage{si}/block{bi}"
                stride = 2 if (si > 0 and bi == 0) else 1
                shortcut = x
                y = conv2d(params, f"{pre}/conv1", x, kernel_hw=(1, 1))
                y = torch.relu(batch_norm_inference(params, f"{pre}/bn1", y))
                y = conv2d(params, f"{pre}/conv2", y, kernel_hw=(3, 3), stride=stride)
                y = torch.relu(batch_norm_inference(params, f"{pre}/bn2", y))
                y = conv2d(params, f"{pre}/conv3", y, kernel_hw=(1, 1))
                y = batch_norm_inference(params, f"{pre}/bn3", y)
                if bi == 0:
                    shortcut = conv2d(params, f"{pre}/proj", x, kernel_hw=(1, 1), stride=stride)
                    shortcut = batch_norm_inference(params, f"{pre}/proj_bn", shortcut)
                x = torch.relu(y + shortcut)

        x = x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)  # global avg pool
        logits = linear(params, "head", x).to(torch.float32)
        return {out_name: logits}


@register_architecture("resnet50")
class ResNet50(_ResNetBase):
    stages = _STAGES["resnet50"]


@register_architecture("resnet101")
class ResNet101(_ResNetBase):
    stages = _STAGES["resnet101"]
