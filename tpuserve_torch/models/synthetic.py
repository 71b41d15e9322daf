"""Anisotropic synthetic checkpoint generator (PyTorch port of
tpuserve/models/synthetic.py).

An isotropic random-init model is the worst case for low-bit quantization:
every direction of weight error reaches the output, and every quantizer
ties at one KL floor. Trained checkpoints are not like that: their
activations concentrate in a low-dimensional residual subspace with a
handful of massive channels, and their weights carry heavy-tailed
input-channel scales. This module synthesizes that structure, so that the
int4 accuracy gate can be both passed and failed:

  * a shared r-dimensional residual subspace, r = rank_frac * dim: token
    embeddings are Z @ B + noise, with B orthonormal rows;
  * the projections that write to the residual stream (wo, w_down,
    moe_down) are projected onto that subspace (plus `subspace_leak` of
    full rank), scaled by `write_scale`;
  * a massive_frac fraction of embedding channels is boosted massive_scale
    times;
  * a row_tail_frac fraction of every 2-D kernel's input rows is scaled by
    lognormal factors of median row_tail_log_median.

The knobs and their defaults are the JAX package's. The draws come from an
explicit torch.Generator and cannot equal jax.random's, so a checkpoint
made here has the same structure as the JAX package's, not the same
numbers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from tpuserve_torch.models.llama import LlamaParams


def _orthonormal_rows(g: torch.Generator, r: int, dim: int) -> torch.Tensor:
    """[r, dim] with orthonormal rows (QR of a gaussian)."""
    x = torch.randn((dim, r), generator=g, device=g.device, dtype=torch.float32)
    q, _ = torch.linalg.qr(x)  # [dim, r], orthonormal columns
    return q.T


def init_params_anisotropic(
    generator: torch.Generator,
    p: LlamaParams,
    *,
    rank_frac: float = 1.0 / 32.0,
    spectrum_alpha: float = 0.0,
    subspace_leak: float = 0.08,
    massive_frac: float = 0.01,
    massive_scale: float = 10.0,
    row_tail_frac: float = 0.005,
    row_tail_log_median: float = 3.0,
    write_scale: float = 1.0,
    dtype=torch.float32,
) -> Dict[str, torch.Tensor]:
    """Flat param dict with trained-checkpoint-like anisotropy, on the
    generator's device. Keys and shapes are llama.init_params's, so the
    result drops into the serving path (quantize_param_tree, GPTQ,
    Llama.apply).

    spectrum_alpha: the subspace's directions carry power-law energies
    s_i ~ (i+1)^-alpha (unit mean square); 0 = flat. write_scale:
    multiplier on the kernels that write to the residual stream (the
    per-size difficulty anchor of the accuracy script)."""
    g = generator
    dev = g.device
    r = max(4, int(round(p.dim * rank_frac)))
    std = 0.02

    def normal(*shape) -> torch.Tensor:
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32)

    basis = _orthonormal_rows(g, r, p.dim)  # [r, dim]
    if spectrum_alpha > 0:
        pl = torch.arange(1, r + 1, dtype=torch.float32, device=dev) ** (-spectrum_alpha)
        pl = pl / torch.sqrt(torch.mean(pl ** 2))
        basis = basis * pl[:, None]
    proj = basis.T @ basis  # [dim, dim] residual-subspace projector

    def to_subspace(w: torch.Tensor) -> torch.Tensor:
        """Project a [*, dim] kernel's output onto the residual subspace,
        keeping a leak so that nothing is exactly singular."""
        return w @ proj + subspace_leak * w

    def row_tails(w: torch.Tensor) -> torch.Tensor:
        """Scale a fraction of input rows by lognormal factors."""
        k_in = w.shape[0]
        n_out = max(1, int(round(k_in * row_tail_frac)))
        rows = torch.randperm(k_in, generator=g, device=dev)[:n_out]
        factors = torch.exp(normal(n_out) * 0.5 + math.log(row_tail_log_median))
        mult = torch.ones((k_in,), dtype=torch.float32, device=dev)
        mult[rows] = factors
        return w * mult[:, None]

    def kernel(shape, write_to_stream: bool) -> torch.Tensor:
        w = row_tails(normal(*shape) * std)
        if write_to_stream:
            w = to_subspace(w) * write_scale
        return w.to(dtype)

    # embeddings: low-rank + noise, with massive channels
    z = normal(p.vocab_size, r)
    embed = (z @ basis) * std + subspace_leak * std * normal(p.vocab_size, p.dim)
    n_massive = max(1, int(round(p.dim * massive_frac)))
    chans = torch.randperm(p.dim, generator=g, device=dev)[:n_massive]
    boost = torch.ones((p.dim,), dtype=torch.float32, device=dev)
    boost[chans] = massive_scale
    embed = embed * boost[None, :]

    params: Dict[str, torch.Tensor] = {
        "embed/weight": embed.to(dtype),
        "final_norm/scale": torch.ones((p.dim,), dtype=dtype, device=dev),
    }
    if not p.tie_embeddings:
        params["lm_head/kernel"] = kernel((p.dim, p.vocab_size), False)
    qd = p.n_heads * p.head_dim
    kvd = p.n_kv_heads * p.head_dim
    for l in range(p.n_layers):
        pre = f"layers.{l}"
        params[f"{pre}/attn_norm/scale"] = torch.ones((p.dim,), dtype=dtype, device=dev)
        params[f"{pre}/wq/kernel"] = kernel((p.dim, qd), False)
        params[f"{pre}/wk/kernel"] = kernel((p.dim, kvd), False)
        params[f"{pre}/wv/kernel"] = kernel((p.dim, kvd), False)
        params[f"{pre}/wo/kernel"] = kernel((qd, p.dim), True)
        params[f"{pre}/mlp_norm/scale"] = torch.ones((p.dim,), dtype=dtype, device=dev)
        if p.n_experts:
            params[f"{pre}/router/kernel"] = kernel((p.dim, p.n_experts), False)
            params[f"{pre}/moe_gateup/kernel"] = torch.stack(
                [kernel((p.dim, 2 * p.ffn_dim), False) for _ in range(p.n_experts)])
            params[f"{pre}/moe_down/kernel"] = torch.stack(
                [kernel((p.ffn_dim, p.dim), True) for _ in range(p.n_experts)])
        else:
            params[f"{pre}/w_gate/kernel"] = kernel((p.dim, p.ffn_dim), False)
            params[f"{pre}/w_up/kernel"] = kernel((p.dim, p.ffn_dim), False)
            params[f"{pre}/w_down/kernel"] = kernel((p.ffn_dim, p.dim), True)
    return params
