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

import math
from typing import Dict

import torch

from tpuserve_torch.models.llama import LlamaParams
from tpuserve_torch.quant.core import QExperts, QTensor
from tpuserve_torch.utils.device import resolve_device


def init_quantized_params(p: LlamaParams, bits: int = 4, group_size: int = 128,
                          dtype=torch.bfloat16, device="cuda",
                          seed: int = 42, keep=None) -> Dict[str, object]:
    """Random int8/int4 weights at p's widths, drawn on `device` from
    `seed`. Each parameter passes through `keep(name, value)` as it is made
    (a sharded rank keeps its block there, so the device never holds the
    whole model; the draws are the same either way)."""
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
        """N(0, 0.02) drawn in f32, cast to `dtype`: in one draw, or where
        that would hold more than 2^28 f32 values beside the result (a
        256000-word embedding: 2 GiB for a 1 GiB bf16 table) in row chunks
        of at most 2^24 values (other values than one draw)."""
        if math.prod(shape) <= 1 << 28:
            return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=dev)
        rows = max(1, (1 << 24) // math.prod(shape[1:]))
        for i in range(0, shape[0], rows):
            part = torch.randn((min(rows, shape[0] - i),) + shape[1:], generator=generator,
                               device=dev)
            out[i:i + part.shape[0]] = (part * 0.02).to(dtype)
        return out

    params: Dict[str, object] = {}

    def put(name, val):
        params[name] = val if keep is None else keep(name, val)

    def ones():
        return torch.ones((p.dim,), dtype=dtype, device=dev)

    put("embed/weight", normal(p.vocab_size, p.dim))
    put("final_norm/scale", ones())
    put("lm_head/kernel", qweight(p.dim, p.vocab_size))
    for l in range(p.n_layers):
        pre = f"layers.{l}"
        put(f"{pre}/attn_norm/scale", ones())
        put(f"{pre}/mlp_norm/scale", ones())
        # fused projections (see llama._forward_block): fewer, wider kernels
        put(f"{pre}/wqkv/kernel", qweight(p.dim, qd + 2 * kvd))
        put(f"{pre}/wo/kernel", qweight(qd, p.dim))
        if p.n_experts:
            put(f"{pre}/router/kernel", normal(p.dim, p.n_experts))
            put(f"{pre}/moe_gateup/kernel", qexperts(p.n_experts, p.dim, 2 * p.ffn_dim))
            put(f"{pre}/moe_down/kernel", qexperts(p.n_experts, p.ffn_dim, p.dim))
        else:
            put(f"{pre}/w_gateup/kernel", qweight(p.dim, 2 * p.ffn_dim))
            put(f"{pre}/w_down/kernel", qweight(p.ffn_dim, p.dim))
    return params


def param_bytes(params: Dict) -> int:
    return sum(v.nbytes if isinstance(v, (QTensor, QExperts)) else v.numel() * v.element_size()
               for v in params.values())
