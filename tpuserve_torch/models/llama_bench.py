"""Bench-scale weight materialization (PyTorch port of
tpuserve/models/llama_bench.py).

Generates already-quantized random Llama weights directly on the target
device (QTensor codes + scales, QExperts stacks for a MoE model's experts)
from a seeded torch.Generator: a 7B bf16 init would cost 13.5 GB before
quantization (a Mixtral-8x7B one 93 GB, more than the card holds), and
serving and timing only need realistic shapes and types, not trained
values. Each stack is drawn in place on the device, one at a time.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpuserve_torch.models.llama import LlamaParams
from tpuserve_torch.quant.core import QExperts, QTensor
from tpuserve_torch.utils.device import resolve_device


def init_quantized_params(p: LlamaParams, bits: int = 4, group_size: int = 128,
                          dtype=torch.bfloat16, device="cuda",
                          seed: int = 42) -> Dict[str, object]:
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    qd = p.n_heads * p.head_dim
    kvd = p.n_kv_heads * p.head_dim

    def codes(*lead, k_dim: int, n_dim: int):
        """Random codes [*lead, K(/2), N] and constant scales [*lead, groups,
        N], the codes drawn straight into their dtype on the device."""
        gs = group_size if 0 < group_size < k_dim else k_dim
        groups = k_dim // gs
        scale = torch.full(lead + (groups, n_dim), 0.02 / (7.0 if bits == 4 else 127.0),
                           dtype=torch.float32, device=dev)
        if bits == 4:
            q = torch.empty(lead + (k_dim // 2, n_dim), dtype=torch.uint8, device=dev)
            q.random_(0, 256, generator=generator)
        else:
            q = torch.empty(lead + (k_dim, n_dim), dtype=torch.int8, device=dev)
            q.random_(-127, 128, generator=generator)
        return q, scale, gs if groups > 1 else 0

    def qweight(k_dim: int, n_dim: int) -> QTensor:
        q, scale, gs = codes(k_dim=k_dim, n_dim=n_dim)
        return QTensor(q=q, scale=scale, bits=bits, group_size=gs, orig_shape=(k_dim, n_dim))

    def qexperts(n_e: int, k_dim: int, n_dim: int) -> QExperts:
        q, scale, gs = codes(n_e, k_dim=k_dim, n_dim=n_dim)
        return QExperts(q=q, scale=scale, bits=bits, group_size=gs,
                        orig_shape=(n_e, k_dim, n_dim))

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
        if p.n_experts:
            params[f"{pre}/router/kernel"] = normal(p.dim, p.n_experts)
            params[f"{pre}/moe_gateup/kernel"] = qexperts(p.n_experts, p.dim, 2 * p.ffn_dim)
            params[f"{pre}/moe_down/kernel"] = qexperts(p.n_experts, p.ffn_dim, p.dim)
        else:
            params[f"{pre}/w_gateup/kernel"] = qweight(p.dim, 2 * p.ffn_dim)
            params[f"{pre}/w_down/kernel"] = qweight(p.ffn_dim, p.dim)
    return params


def param_bytes(params: Dict) -> int:
    return sum(v.nbytes if isinstance(v, (QTensor, QExperts)) else v.numel() * v.element_size()
               for v in params.values())
