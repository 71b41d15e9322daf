"""Shared functional layers for the model zoo (PyTorch port of
tpuserve/models/layers.py).

Models are pure functions over flat param dicts ({"block/name": tensor}).
Linear layers accept quantized weights: a `QTensor` kernel runs through
`qmatmul`, the Hopper quant-matmul on the card.

Layout: the zoo is NHWC, with conv kernels stored flat as HWIO
[kh*kw*cin, cout], as in the JAX package. `conv2d` and the pools take and
return NHWC tensors; inside, an NHWC tensor permuted to NCHW is a
`channels_last` view of the same memory, which is what they hand to
torch's convolution and pooling, so no activation is copied into NCHW.
XLA's "SAME" padding puts the odd row or column after the data, not before
(stride 2, even total): the split is computed here and padded explicitly.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from tpuserve_torch.quant.core import QTensor, dequantize, qmatmul

Padding = Union[str, Sequence[Tuple[int, int]]]


def linear(params: Dict, prefix: str, x: torch.Tensor, *, bias: bool = True) -> torch.Tensor:
    w = params[f"{prefix}/kernel"]
    if isinstance(w, QTensor):
        y = qmatmul(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if bias:
        b = params.get(f"{prefix}/bias")
        if b is not None:
            y = y + b.to(y.dtype)
    return y


def layer_norm(params: Dict, prefix: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)  # jnp.var: population variance
    y = (x - mean) * torch.rsqrt(var + eps)
    scale = params.get(f"{prefix}/scale")
    offset = params.get(f"{prefix}/bias")
    if scale is not None:
        y = y * scale.to(y.dtype)
    if offset is not None:
        y = y + offset.to(y.dtype)
    return y


def rms_norm(params: Dict, prefix: str, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # compute in f32 for stability, cast back (standard Llama practice)
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    scale = params[f"{prefix}/scale"]
    return (y * scale.to(torch.float32)).to(x.dtype)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" split of one spatial dim: ceil(n/s) outputs, the total
    padding halved with the odd one after."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(padding: Padding, hw, window, strides):
    """((top, bottom), (left, right)) for "SAME", "VALID" or explicit pairs."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if padding.upper() == "SAME":
            return tuple(same_pads(n, k, s) for n, k, s in zip(hw, window, strides))
        raise ValueError(f"unknown padding '{padding}'")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _pad_nhwc(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> an NCHW view in channels_last memory (no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv2d(
    params: Dict,
    prefix: str,
    x: torch.Tensor,
    *,
    kernel_hw,
    stride=1,
    padding: Padding = "SAME",
    bias: bool = False,
) -> torch.Tensor:
    """NHWC conv. The kernel may be a QTensor holding the [h*w*cin, cout]
    flattening of the weights (INT8 weight-only conv), dequantized per call
    as the JAX package does."""
    w = params[f"{prefix}/kernel"]
    kh, kw = kernel_hw
    if isinstance(w, QTensor):
        cin = w.orig_shape[0] // (kh * kw)
        w = dequantize(w, dtype=x.dtype).reshape(kh, kw, cin, w.orig_shape[1])
    else:
        w = w.to(x.dtype)
        if w.dim() == 2:  # flat [h*w*cin, cout] storage (quantizer-compatible)
            cin = w.shape[0] // (kh * kw)
            w = w.reshape(kh, kw, cin, w.shape[1])
    strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
    x = _pad_nhwc(x, _pads(padding, x.shape[1:3], (kh, kw), strides), 0.0)
    w = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)  # HWIO -> OIHW
    y = _nhwc(F.conv2d(_nchw(x), w, stride=strides))
    if bias:
        b = params.get(f"{prefix}/bias")
        if b is not None:
            y = y + b.to(y.dtype)
    return y


def batch_norm_inference(params: Dict, prefix: str, x: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN from stored (scale, bias, mean, var), in f32."""
    scale = params[f"{prefix}/scale"].to(torch.float32)
    bias = params[f"{prefix}/bias"].to(torch.float32)
    mean = params[f"{prefix}/mean"].to(torch.float32)
    var = params[f"{prefix}/var"].to(torch.float32)
    inv = scale * torch.rsqrt(var + eps)
    return (x.to(torch.float32) * inv + (bias - mean * inv)).to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int, padding: Padding = "SAME") -> torch.Tensor:
    pads = _pads(padding, x.shape[1:3], (window, window), (stride, stride))
    x = _pad_nhwc(x, pads, -math.inf)
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: Padding = "VALID") -> torch.Tensor:
    """Sum over the window in f32 over window * window (padding counts as
    zeros, as the JAX package's reduce_window sum does)."""
    pads = _pads(padding, x.shape[1:3], (window, window), (stride, stride))
    xf = _pad_nhwc(x.to(torch.float32), pads, 0.0)
    return _nhwc(F.avg_pool2d(_nchw(xf), window, stride)).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default approximate=True


_ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": _gelu_tanh,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def activation(name: str):
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown activation '{name}'")
