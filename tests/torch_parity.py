"""Shared helpers for the tests that hold tpuserve_torch against tpuserve.

Data crosses between the two packages as numpy arrays only: the JAX side is
taken to numpy here and handed to tpuserve_torch.interop.
"""

import numpy as np
import torch

from tpuserve.quant.core import QTensor as JQTensor
from tpuserve_torch import interop

# A config on the kernel path that stays fast on the CPU: head_dim 128 (the
# decode kernels' width) and (n_kv_heads*head_dim)/2 % 128 == 0 (packed int4).
SMALL = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=128, ffn_dim=512)


def jax_tree_to_numpy(params) -> dict:
    """JAX param dict (arrays and QTensors) -> the numpy form interop takes."""
    out = {}
    for name, v in params.items():
        if isinstance(v, JQTensor):
            out[name] = dict(q=np.asarray(v.q), scale=np.asarray(v.scale), bits=v.bits,
                             group_size=v.group_size, orig_shape=v.orig_shape,
                             act_bits=v.act_bits, act_fp8=v.act_fp8)
        else:
            out[name] = np.asarray(v)
    return out


def jax_to_torch_params(params, device="cpu") -> dict:
    return interop.params_from_numpy(jax_tree_to_numpy(params), device)


def jax_qt_to_torch(qt, device="cpu"):
    return jax_to_torch_params({"w": qt}, device)["w"]


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()
