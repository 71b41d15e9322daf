"""Bench-scale weight materialization (PyTorch port of
tpuserve/models/llama_bench.py).

Generates already-quantized random Llama weights directly on the target
device (QTensor codes + scales) from a seeded torch.Generator: a 7B bf16
init would cost 13.5 GB before quantization, and serving and timing only
need realistic shapes and types, not trained values.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpuserve_torch.models.llama import LlamaParams, _no_moe
from tpuserve_torch.quant.core import QTensor
from tpuserve_torch.utils.device import resolve_device


def init_quantized_params(p: LlamaParams, bits: int = 4, group_size: int = 128,
                          dtype=torch.bfloat16, device="cuda",
                          seed: int = 42) -> Dict[str, object]:
    _no_moe(p)
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    qd = p.n_heads * p.head_dim
    kvd = p.n_kv_heads * p.head_dim

    def qweight(k_dim: int, n_dim: int) -> QTensor:
        gs = group_size if 0 < group_size < k_dim else k_dim
        groups = k_dim // gs
        scale = torch.full((groups, n_dim), 0.02 / (7.0 if bits == 4 else 127.0),
                           dtype=torch.float32, device=dev)
        if bits == 4:
            q = torch.randint(0, 256, (k_dim // 2, n_dim), generator=generator,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        else:
            q = torch.randint(-127, 128, (k_dim, n_dim), generator=generator,
                              device=dev, dtype=torch.int32).to(torch.int8)
        return QTensor(q=q, scale=scale, bits=bits, group_size=gs if groups > 1 else 0,
                       orig_shape=(k_dim, n_dim))

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dtype)

    params: Dict[str, object] = {
        "embed/weight": normal(p.vocab_size, p.dim),
        "final_norm/scale": torch.ones((p.dim,), dtype=dtype, device=dev),
        "lm_head/kernel": qweight(p.dim, p.vocab_size),
    }
    for l in range(p.n_layers):
        pre = f"layers.{l}"
        params[f"{pre}/attn_norm/scale"] = torch.ones((p.dim,), dtype=dtype, device=dev)
        params[f"{pre}/mlp_norm/scale"] = torch.ones((p.dim,), dtype=dtype, device=dev)
        # fused projections (see llama._forward_block): fewer, wider kernels
        params[f"{pre}/wqkv/kernel"] = qweight(p.dim, qd + 2 * kvd)
        params[f"{pre}/wo/kernel"] = qweight(qd, p.dim)
        params[f"{pre}/w_gateup/kernel"] = qweight(p.dim, 2 * p.ffn_dim)
        params[f"{pre}/w_down/kernel"] = qweight(p.ffn_dim, p.dim)
    return params


def param_bytes(params: Dict) -> int:
    total = 0
    for v in params.values():
        if isinstance(v, QTensor):
            total += v.nbytes
        else:
            total += v.numel() * v.element_size()
    return total
