"""Shared functional layers (PyTorch port of tpuserve/models/layers.py).

Only `rms_norm` is ported so far; the model-zoo layers wait for the zoo.
"""

from __future__ import annotations

from typing import Dict

import torch


def rms_norm(params: Dict, prefix: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # compute in f32 for stability, cast back (standard Llama practice)
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    scale = params[f"{prefix}/scale"]
    return (y * scale.to(torch.float32)).to(x.dtype)
