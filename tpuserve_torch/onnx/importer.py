"""ONNX graph -> a PyTorch function run on the device (port of
tpuserve/onnx/importer.py).

Reference counterpart: the ONNX Runtime backend (model.cpp:825-1035 session
construction, :1158-1328 Infer). The graph is evaluated node by node as
PyTorch ops on the tensors' device, in NCHW as ONNX defines it. Static
shapes only (a dynamic batch is bucketed by the backend).

Supported opset (the reference fixture + common CNN/MLP classifiers), the
JAX importer's: MatMul, Gemm, Add, Sub, Mul, Div, Relu, Sigmoid, Tanh, Erf,
Sqrt, Pow, Exp, Log, Neg, Softmax, LogSoftmax, Clip, LeakyRelu, Elu, Gelu,
Identity, Dropout (inference no-op), Flatten, Reshape, Transpose, Concat,
Squeeze, Unsqueeze, Shape, Gather, Constant, Cast, ReduceMean, Conv,
MaxPool, AveragePool, GlobalAveragePool, BatchNormalization.

`auto_pad` SAME_UPPER and SAME_LOWER both pad as XLA's "SAME" (the odd
row after), as the JAX importer does: for SAME_LOWER that is a fault of
the reference, carried so the two packages agree.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpuserve_torch.onnx.proto import _NP_FROM_ONNX, Graph, Node
from tpuserve_torch.utils.errors import UnsupportedError, ValidationError


def _attr_i(node: Node, name: str, default: int = 0) -> int:
    a = node.attrs.get(name)
    return default if a is None or a.i is None else int(a.i)


def _attr_f(node: Node, name: str, default: float = 0.0) -> float:
    a = node.attrs.get(name)
    return default if a is None or a.f is None else float(a.f)


def _attr_ints(node: Node, name: str, default=()) -> List[int]:
    a = node.attrs.get(name)
    return list(a.ints) if a is not None and a.ints else list(default)


def _attr_s(node: Node, name: str, default: str = "") -> str:
    a = node.attrs.get(name)
    return a.s.decode() if a is not None and a.s is not None else default


def _conv_pads(node: Node, spatial: int) -> Union[str, Sequence[Tuple[int, int]]]:
    auto = _attr_s(node, "auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        return "SAME"  # XLA's SAME: SAME_UPPER's split, for both (see above)
    pads = _attr_ints(node, "pads", [0] * (2 * spatial))
    return [(pads[i], pads[i + spatial]) for i in range(spatial)]


def _resolve_pads(pads, sizes, kernel, strides) -> List[Tuple[int, int]]:
    """(lo, hi) per spatial dim; "SAME" as XLA splits it: ceil(n/s)
    outputs, the odd padding after."""
    if pads != "SAME":
        return list(pads)
    out = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pad_spatial(x: torch.Tensor, pads: List[Tuple[int, int]], value: float) -> torch.Tensor:
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first
    return F.pad(x, flat, value=value)


def _pool(x: torch.Tensor, node: Node, avg: bool) -> torch.Tensor:
    # ONNX pools are NCHW; the window runs over the trailing spatial dims
    kshape = _attr_ints(node, "kernel_shape")
    spatial = len(kshape)
    strides = _attr_ints(node, "strides", [1] * spatial)
    pads = _resolve_pads(_conv_pads(node, spatial), x.shape[2:], kshape, strides)
    if avg:
        # sum over the window / count of real elements in it (padding not
        # counted), as the JAX importer divides by reduce_window over ones
        pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[spatial]
        area = float(np.prod(kshape))
        summed = pool(_pad_spatial(x, pads, 0.0), kshape, strides) * area
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        counts = pool(_pad_spatial(ones, pads, 0.0), kshape, strides) * area
        return summed / counts
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[spatial]
    return pool(_pad_spatial(x, pads, -math.inf), kshape, strides)


def _conv(node: Node, vals: List[torch.Tensor]) -> torch.Tensor:
    x, w = vals[0], vals[1]
    spatial = w.dim() - 2
    strides = _attr_ints(node, "strides", [1] * spatial)
    dil = _attr_ints(node, "dilations", [1] * spatial)
    eff_k = [(k - 1) * d + 1 for k, d in zip(w.shape[2:], dil)]
    pads = _resolve_pads(_conv_pads(node, spatial), x.shape[2:], eff_k, strides)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
    out = conv(_pad_spatial(x, pads, 0.0), w, stride=strides, dilation=dil,
               groups=_attr_i(node, "group", 1))  # OIHW weights: ONNX's convention
    if len(vals) > 2:  # bias [C]
        out = out + vals[2].reshape((1, -1) + (1,) * spatial)
    return out


def _axes(node: Node, vals: List[torch.Tensor]) -> List[int]:
    axes = _attr_ints(node, "axes")
    if not axes and len(vals) > 1 and vals[1] is not None:
        axes = [int(a) for a in vals[1].reshape(-1).tolist()]
    return axes


def _take(a: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.take: indices of any shape along `axis`, negative ones wrapped."""
    axis = axis % a.dim()
    idx = idx.to(device=a.device, dtype=torch.long)
    idx = torch.where(idx < 0, idx + a.shape[axis], idx)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def _eval_node(node: Node, vals: List[torch.Tensor]):
    op = node.op_type
    if op == "MatMul":
        return torch.matmul(vals[0], vals[1])
    if op == "Gemm":
        a, b = vals[0], vals[1]
        if _attr_i(node, "transA"):
            a = a.T
        if _attr_i(node, "transB"):
            b = b.T
        out = _attr_f(node, "alpha", 1.0) * torch.matmul(a, b)
        if len(vals) > 2:
            out = out + _attr_f(node, "beta", 1.0) * vals[2]
        return out
    if op == "Add":
        return vals[0] + vals[1]
    if op == "Sub":
        return vals[0] - vals[1]
    if op == "Mul":
        return vals[0] * vals[1]
    if op == "Div":
        return vals[0] / vals[1]
    if op == "Relu":
        return torch.relu(vals[0])
    if op == "Sigmoid":
        return torch.sigmoid(vals[0])
    if op == "Tanh":
        return torch.tanh(vals[0])
    if op == "Erf":
        return torch.erf(vals[0])
    if op == "Sqrt":
        return torch.sqrt(vals[0])
    if op == "Exp":
        return torch.exp(vals[0])
    if op == "Log":
        return torch.log(vals[0])
    if op == "Neg":
        return -vals[0]
    if op == "Pow":
        return vals[0] ** vals[1]
    if op == "Softmax":
        return torch.softmax(vals[0], dim=_attr_i(node, "axis", -1))
    if op == "LogSoftmax":
        return torch.log_softmax(vals[0], dim=_attr_i(node, "axis", -1))
    if op == "LeakyRelu":
        return F.leaky_relu(vals[0], _attr_f(node, "alpha", 0.01))
    if op == "Elu":
        return F.elu(vals[0], _attr_f(node, "alpha", 1.0))
    if op == "Gelu":
        tanh = _attr_s(node, "approximate", "none") == "tanh"
        return F.gelu(vals[0], approximate="tanh" if tanh else "none")
    if op == "Clip":
        x = vals[0]
        lo = vals[1] if len(vals) > 1 and vals[1] is not None else _attr_f(node, "min", -math.inf)
        hi = vals[2] if len(vals) > 2 and vals[2] is not None else _attr_f(node, "max", math.inf)
        lo, hi = (torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in (lo, hi))
        return torch.minimum(torch.maximum(x, lo), hi)
    if op in ("Identity", "Dropout"):
        return vals[0]
    if op == "Flatten":
        ax = _attr_i(node, "axis", 1)
        shape = vals[0].shape
        lead = int(np.prod(shape[:ax])) if ax > 0 else 1
        return vals[0].reshape(lead, -1)
    if op == "Reshape":
        target = [int(d) for d in vals[1].reshape(-1).tolist()]
        shape = [vals[0].shape[i] if d == 0 else d for i, d in enumerate(target)]
        return vals[0].reshape(shape)
    if op == "Transpose":
        perm = _attr_ints(node, "perm") or list(range(vals[0].dim()))[::-1]
        return vals[0].permute(perm)
    if op == "Concat":
        return torch.cat(vals, dim=_attr_i(node, "axis", 0))
    if op == "Squeeze":
        axes = _axes(node, vals)
        x = vals[0]
        return x.squeeze(tuple(a % x.dim() for a in axes)) if axes else x.squeeze()
    if op == "Unsqueeze":
        out = vals[0]
        for ax in sorted(_axes(node, vals)):
            out = out.unsqueeze(ax)
        return out
    if op == "ReduceMean":
        axes = _axes(node, vals)
        keep = bool(_attr_i(node, "keepdims", 1))
        x = vals[0]
        return x.mean(dim=tuple(axes) if axes else tuple(range(x.dim())), keepdim=keep)
    if op == "Conv":
        return _conv(node, vals)
    if op == "MaxPool":
        return _pool(vals[0], node, avg=False)
    if op == "AveragePool":
        return _pool(vals[0], node, avg=True)
    if op == "GlobalAveragePool":
        return vals[0].mean(dim=tuple(range(2, vals[0].dim())), keepdim=True)
    if op == "BatchNormalization":
        x, scale, bias, mean, var = vals[:5]
        eps = _attr_f(node, "epsilon", 1e-5)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = torch.rsqrt(var.reshape(shape) + eps)
        return (x - mean.reshape(shape)) * inv * scale.reshape(shape) + bias.reshape(shape)
    if op == "Constant":
        a = node.attrs.get("value")
        if a is not None and a.t is not None:
            return torch.from_numpy(np.array(a.t.array))
        raise UnsupportedError(f"Constant node '{node.name}' without tensor value")
    if op == "Shape":
        return torch.tensor(tuple(vals[0].shape), dtype=torch.int64, device=vals[0].device)
    if op == "Gather":
        return _take(vals[0], vals[1], _attr_i(node, "axis", 0))
    if op == "Cast":
        to = _NP_FROM_ONNX.get(_attr_i(node, "to"))
        if to is None:
            raise UnsupportedError(f"Cast to unsupported onnx dtype {_attr_i(node, 'to')}")
        return vals[0].to(torch.from_numpy(np.zeros(0, to)).dtype)
    raise UnsupportedError(
        f"ONNX op '{op}' is not supported by the importer "
        f"(node '{node.name}'); supported set in tpuserve_torch/onnx/importer.py"
    )


def build(graph: Graph) -> Tuple[Dict[str, np.ndarray], Callable, List[str], List[str]]:
    """Import once: returns (params, apply, input_names, output_names),
    where `apply(params, inputs: dict) -> dict` runs the graph on the
    device of the tensors it is given (params as torch tensors)."""
    init_names = set(graph.initializers)
    input_names = [vi.name for vi in graph.inputs if vi.name not in init_names]
    output_names = [vi.name for vi in graph.outputs]
    params = dict(graph.initializers)
    nodes = list(graph.nodes)

    def apply(params: Dict, inputs: Dict) -> Dict:
        env: Dict[str, torch.Tensor] = dict(params)
        for k in input_names:
            if k not in inputs:
                raise ValidationError(f"missing graph input '{k}'")
            env[k] = inputs[k]
        device = next((v.device for v in env.values()), None)
        remaining = nodes
        progress = True
        while remaining and progress:  # tolerate non-topological node order
            progress = False
            still = []
            for node in remaining:
                if all((not n) or n in env for n in node.inputs):
                    vals = [env[n] if n else None for n in node.inputs]
                    out = _eval_node(node, vals)
                    outs = out if isinstance(out, (tuple, list)) else (out,)
                    for name, val in zip(node.outputs, outs):
                        if name:
                            env[name] = val.to(device) if device is not None else val
                    progress = True
                else:
                    still.append(node)
            remaining = still
        if remaining:
            missing = {n for node in remaining for n in node.inputs if n and n not in env}
            raise ValidationError(f"unresolvable graph inputs: {sorted(missing)}")
        return {k: env[k] for k in output_names}

    return params, apply, input_names, output_names
