"""Llama-family decoder (PyTorch port of tpuserve/models/llama.py, the
single-device path).

- plain functions over a flat param dict; matmul weights may be QTensors
  (INT8/INT4) dispatched through the fused quant-matmul kernel, with a
  GPTQ model's LoRC factors `{name}@lorc_a/_b` added on top (`_lorc`),
  stacked MoE experts QExperts handed to it one expert at a time;
  `_forward_block`'s `mm` hook lets GPTQ's calibration record each
  projection's input (quant/gptq.py);
- grouped-query attention + RoPE, RMSNorm, SwiGLU MLP (Llama-2/3 shapes) or
  a Mixtral-style top-k Mixture-of-Experts FFN (_moe_ffn);
- entry points shaped for continuous batching:
    prefill(params, p, tokens[1, L], cache, slot, length)        -> logits[1, V]
    prefill_chunk(params, p, tokens[1, C], cache, slot, start, length, window)
    decode_step(params, p, tokens[S], cache, positions, window)  -> logits[S, V]
    verify_step(params, p, tokens[S, C], cache, positions, lengths, window)
                                                                  -> logits[S, C, V]
  and their paged forms over a serving.paged_kv.PagedKVCache and a page
  table: prefill_paged, prefill_paged_suffix, decode_step_paged,
  verify_step_paged; each returns (logits, cache); draft_lookup drafts
  speculative candidates from the token history on the device;
  Llama.apply gives whole-sequence logits (the accuracy script's path);
- the KV cache in the flat layout k/v [n_layers, S, L, Hkv*hd] (int8,
  packed int4, bf16 or f32) with head-major scales [n_layers, S, Hkv, L],
  or the 5D layout [n_layers, S, L, Hkv, hd] that sequence parallelism
  reads (KVCache.create(flat=False));
  paged pools [n_layers, n_pages, ps, Hkv*hd] with f32 scale pools
  [n_layers, n_pages, pad8(Hkv), ps]. JAX updates caches functionally;
  here they are written in place.

Prefill attention is plain torch (the JAX package leaves it to XLA). Decode
and verify attention follow TPUSERVE_DECODE_ATTN, as in the JAX package
(`_decode_attn_mode`): "pallas" (the default) runs `ops.decode_attention`'s
flat, multi-candidate and paged kernels, "grouped" runs decode_step through
the grouped kernel, and any other value ("xla") attends with the einsums of
`_attend_window`, as do verify_step and decode_step_paged under "grouped".
Kernels run as CUDA kernels on the card and as their plain versions on the
CPU. The paged verify attends over the gathered window in plain torch in
every mode, as the JAX package leaves it to XLA.

Under a live mesh (parallel/sharding.py's active mesh: the sharded engine's
ranks) prefill, prefill_chunk and decode_step run one rank's part: its
blocks of the weights and of the cache, the tp-sharded projections through
the per-shard quant-matmul (column shards' outputs gathered over tp, row
shards' partials summed), MoE experts over tp, decode attention on the
rank's slots and kv heads through the flat core, or over its L window with
the flash-decoding merge under sp. Inputs and outputs stay global (tokens
and positions of every slot, logits [S, V]): a prefill runs on the slot's
dp group and the others add zeros to its logits. The paged forms run under
a tp/dp mesh too: the rank's pool block holds its kv
heads of every page, replicated over dp, so a prefill runs on every dp
group (each writes its copy of the pool, as a replicated computation does
in the JAX package) and a decode step on the rank's dp slots through the
paged core at its kv heads (`sharding.decode_attention_paged_sharded`).
verify_step and verify_step_paged run the rank's dp slots' candidates by
einsum, as GSPMD runs them in the JAX package (`_verify_rank`). Where tp
does not divide n_kv_heads (`sharding.kv_replicated`) every rank writes
and holds every kv head of its block (the JAX cache replicates the head
axis over tp), attends by einsum with the query heads of the kv groups
over its rows of wo and keeps those rows' columns (`_rank_heads`,
`_attn_view`).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tpuserve_torch.models.layers import rms_norm
from tpuserve_torch.models.registry import Architecture, register_architecture
from tpuserve_torch.ops.decode_attention import (decode_attention,
                                                 decode_attention_packed,
                                                 decode_attention_wide_cache,
                                                 decode_attention_wide_cache_multi,
                                                 decode_attention_wide_paged,
                                                 unpack_kv_codes)
from tpuserve_torch.parallel import sharding
from tpuserve_torch.quant.core import QExperts, QTensor, qmatmul, true_div
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.utils.device import resolve_device


# ---------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class LlamaParams:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # Mixture-of-Experts (Mixtral-style): n_experts > 0 replaces every
    # layer's FFN with a top-k router over E gated-silu experts of ffn_dim
    # each, their weights stacked [E, ...] (see _moe_ffn).
    n_experts: int = 0
    n_experts_per_tok: int = 2

    @classmethod
    def from_dict(cls, d: Dict) -> "LlamaParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        p = cls(**kw)
        assert p.n_heads % p.n_kv_heads == 0, "n_heads must be divisible by n_kv_heads"
        if p.n_experts:
            assert 0 < p.n_experts_per_tok <= p.n_experts
        return p

    @classmethod
    def llama2_7b(cls) -> "LlamaParams":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaParams":
        """CPU-test scale (the JAX package's `tiny`)."""
        return cls(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   head_dim=16, ffn_dim=128)

    @classmethod
    def mixtral_8x7b(cls) -> "LlamaParams":
        """Mixtral-8x7B-v0.1's published widths (its config.json)."""
        return cls(vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                   head_dim=128, ffn_dim=14336, rope_theta=1e6, rms_eps=1e-5,
                   n_experts=8, n_experts_per_tok=2)


def active_param_count(p: LlamaParams) -> int:
    """Matmul-active parameters per decoded token (MoE counts only the
    top-k experts a token routes through, plus the router); 2x this is the
    step's matmul FLOPs per token."""
    qd = p.n_heads * p.head_dim
    kvd = p.n_kv_heads * p.head_dim
    attn = p.dim * qd + 2 * p.dim * kvd + qd * p.dim
    ffn = 3 * p.dim * p.ffn_dim
    if p.n_experts:
        ffn = ffn * p.n_experts_per_tok + p.dim * p.n_experts
    head = p.dim * p.vocab_size  # lm_head (tied or not, the matmul runs)
    return p.n_layers * (attn + ffn) + head


# ---------------------------------------------------------------------- weights
def init_params(p: LlamaParams, dtype=torch.bfloat16, device="cuda",
                seed: int = 0, keep=None) -> Dict[str, torch.Tensor]:
    """Random-init weights (flat dict) from a seeded torch.Generator on
    `device`. Serving normally loads a checkpoint; this exists for tests and
    fixtures. (The JAX PRNG cannot be reproduced: tests carry JAX's weights
    across with interop.params_from_numpy instead.) Each tensor passes
    through `keep(name, tensor)` as it is drawn (a sharded rank moves it to
    the host there; the draws are the same either way)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    std = 0.02
    params: Dict[str, torch.Tensor] = {}

    def put(name, t):
        params[name] = t if keep is None else keep(name, t)

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def ones():
        return torch.ones((p.dim,), dtype=dtype, device=dev)

    put("embed/weight", normal(p.vocab_size, p.dim))
    put("final_norm/scale", ones())
    if not p.tie_embeddings:
        put("lm_head/kernel", normal(p.dim, p.vocab_size))
    qd = p.n_heads * p.head_dim
    kvd = p.n_kv_heads * p.head_dim
    for l in range(p.n_layers):
        pre = f"layers.{l}"
        put(f"{pre}/attn_norm/scale", ones())
        put(f"{pre}/wq/kernel", normal(p.dim, qd))
        put(f"{pre}/wk/kernel", normal(p.dim, kvd))
        put(f"{pre}/wv/kernel", normal(p.dim, kvd))
        put(f"{pre}/wo/kernel", normal(qd, p.dim))
        put(f"{pre}/mlp_norm/scale", ones())
        if p.n_experts:
            put(f"{pre}/router/kernel", normal(p.dim, p.n_experts))
            put(f"{pre}/moe_gateup/kernel", normal(p.n_experts, p.dim, 2 * p.ffn_dim))
            put(f"{pre}/moe_down/kernel", normal(p.n_experts, p.ffn_dim, p.dim))
        else:
            put(f"{pre}/w_gate/kernel", normal(p.dim, p.ffn_dim))
            put(f"{pre}/w_up/kernel", normal(p.dim, p.ffn_dim))
            put(f"{pre}/w_down/kernel", normal(p.ffn_dim, p.dim))
    return params


def _mm_w(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul against a weight value, dense or QTensor (the single-device
    path): a dense weight is cast to x's dtype and multiplied with f32
    accumulation, as the JAX package's jnp.dot(preferred_element_type=f32)."""
    if isinstance(w, QTensor):
        return qmatmul(x, w)
    return torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32)).to(x.dtype)


def _lorc(params: Dict, name: str, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Low-rank error correction (LoRC): where the quantizer stored a rank-r
    factorization of its residual under `{name}@lorc_a` / `{name}@lorc_b`
    ([K, r], [r, N], bf16), add (x @ A) @ B to the quantized matmul's
    output. The JAX package's rounding points: x @ A in A's dtype (bf16
    products summed in f32, rounded to bf16), then @ B summed in f32, added
    to out in f32 and cast back. Both products are plain matmuls, as there."""
    a = params.get(f"{name}@lorc_a")
    if a is None:
        return out
    b = params[f"{name}@lorc_b"]
    xa = torch.matmul(x.to(a.dtype).to(torch.float32), a.to(torch.float32)).to(a.dtype)
    corr = torch.matmul(xa.to(torch.float32), b.to(torch.float32))
    return (out.to(torch.float32) + corr).to(out.dtype)


def _mesh():
    """The live mesh of more than one rank, or None."""
    mesh = sharding.active_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _mm(params: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Name-keyed matmul: LoRC applies to QTensor weights only. Under a live
    mesh, the rank's weight block through the per-shard body (row shards
    summed over tp)."""
    w = params[name]
    mesh = _mesh()
    if mesh is not None:
        sharded = sharding.qmatmul_sharded if isinstance(w, QTensor) else sharding.matmul_sharded
        return sharded(x, w, name, mesh)
    if isinstance(w, QTensor):
        return _lorc(params, name, x, qmatmul(x, w))
    return _mm_w(x, w)


def _mm_direct(params: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Name-keyed matmul with LoRC on any weight (the JAX package's form for
    code inside a shard_map island; GPTQ's calibration pass runs it)."""
    return _lorc(params, name, x, _mm_w(x, params[name]))


def fuse_params(params: Dict, p: LlamaParams) -> Dict:
    """Concatenate wq/wk/wv -> wqkv and w_gate/w_up -> w_gateup (column-wise;
    safe before quantization since scales are per output column). Idempotent."""
    out = dict(params)
    for l in range(p.n_layers):
        pre = f"layers.{l}"
        if f"{pre}/wq/kernel" in out and f"{pre}/wqkv/kernel" not in out:
            out[f"{pre}/wqkv/kernel"] = torch.cat(
                [out.pop(f"{pre}/wq/kernel"), out.pop(f"{pre}/wk/kernel"),
                 out.pop(f"{pre}/wv/kernel")], dim=1)
        if f"{pre}/w_gate/kernel" in out and f"{pre}/w_gateup/kernel" not in out:
            out[f"{pre}/w_gateup/kernel"] = torch.cat(
                [out.pop(f"{pre}/w_gate/kernel"), out.pop(f"{pre}/w_up/kernel")], dim=1)
    return out


# ---------------------------------------------------------------------- rope
def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [...] -> cos/sin [..., head_dim/2] (f32)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., n_heads, head_dim]; cos/sin broadcastable [..., 1, head_dim/2].
    Rotate-half convention (matches HF Llama)."""
    half = x.shape[-1] // 2
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    o1 = xf1 * cos - xf2 * sin
    o2 = xf2 * cos + xf1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------- kv cache
@dataclasses.dataclass
class KVCache:
    """Contiguous per-slot KV cache.

    k/v: flat [n_layers, S, L, W], W = n_kv_heads*head_dim — int8, bf16/f32,
    or packed int4 (uint8 [.., W/2], see pack_kv_codes) — or 5D [n_layers,
    S, L, n_kv_heads, head_dim] (int8 or float; the layout sequence
    parallelism reads, as in the JAX package; its rows are the same bytes,
    `rows()` views them flat). k_scale/v_scale: [n_layers, S, n_kv_heads, L]
    (head-major; quantized caches only, else None), f32 or bf16. The decode
    kernel reads all of it in place.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def flat(self) -> bool:
        return self.k.dim() == 4

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """k or v as flat rows [n_layers, S, L, W] (a view of a 5D cache)."""
        return t if t.dim() == 4 else t.flatten(-2)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def n_slots(self) -> int:
        return self.k.shape[1]

    @property
    def kv_bits(self) -> int:
        return 4 if self.k.dtype == torch.uint8 else 8

    @property
    def nbytes(self) -> int:
        total = sum(t.numel() * t.element_size() for t in (self.k, self.v))
        if self.k_scale is not None:
            total += sum(t.numel() * t.element_size() for t in (self.k_scale, self.v_scale))
        return total

    @classmethod
    def create(cls, p: LlamaParams, n_slots: int, max_len: int, quantized: bool,
               dtype=torch.bfloat16, scale_dtype=torch.float32, kv_bits: int = 8,
               device="cuda", flat: bool = True) -> "KVCache":
        dev = resolve_device(device)
        w = p.n_kv_heads * p.head_dim
        shape = (p.n_layers, n_slots, max_len, w) if flat \
            else (p.n_layers, n_slots, max_len, p.n_kv_heads, p.head_dim)
        scale_shape = (p.n_layers, n_slots, p.n_kv_heads, max_len)
        if kv_bits == 4:
            if not (quantized and flat):
                raise ValueError("kv_bits=4 requires a quantized flat cache")
            if w % 2:
                raise ValueError("kv_bits=4 requires an even n_kv_heads*head_dim")
            shape = shape[:-1] + (w // 2,)
            store = torch.uint8
        elif quantized:
            store = torch.int8
        else:
            return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev),
                       k_scale=None, v_scale=None)
        return cls(
            k=torch.zeros(shape, dtype=store, device=dev),
            v=torch.zeros(shape, dtype=store, device=dev),
            k_scale=torch.zeros(scale_shape, dtype=scale_dtype, device=dev),
            v_scale=torch.zeros(scale_shape, dtype=scale_dtype, device=dev),
        )


def _quantize_kv(x: torch.Tensor, qmax: float = 127.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., head_dim] -> int codes + f32 scale over the last dim. qmax 127 =
    int8 cache; qmax 7 = int4 cache (codes in [-8, 7], packed by the writer)."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp_min(true_div(absmax, qmax), 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1, qmax).to(torch.int8)
    return q, scale


def _quantize_kv_cache(cache: KVCache, x: torch.Tensor):
    return _quantize_kv(x, 7.0 if cache.k.dtype == torch.uint8 else 127.0)


def pack_kv_codes(codes: torch.Tensor, chunks: int = 1) -> torch.Tensor:
    """int8 codes in [-8, 7] [..., W] -> packed uint8 [..., W/2], split-half
    along the last dim per chunk: within each of `chunks` equal slices of W,
    byte d holds positions d (low nibble) and Wc/2 + d (high nibble),
    offset-8. chunks=1 is the global split-half the decode kernel reads;
    chunks=tp is the JAX package's sharded cache, whose byte slice
    [(W/2)/tp] on each tp rank is that rank's own W/tp positions packed with
    chunks=1 (a rank's cache is packed so, locally)."""
    w = codes.shape[-1]
    x = codes.reshape(codes.shape[:-1] + (chunks, w // chunks))
    half = w // chunks // 2
    lo = x[..., :half].to(torch.int32) + 8
    hi = x[..., half:].to(torch.int32) + 8
    return (lo | (hi << 4)).to(torch.uint8).reshape(codes.shape[:-1] + (w // 2,))


def _pad_heads(x: torch.Tensor, hp: int) -> torch.Tensor:
    """[.., Hkv] -> [.., hp] zero-padded: scale pools hold pad8(Hkv)
    head-major rows per page."""
    pad = hp - x.shape[-1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def _kv_rows(cache, k, v):
    """This step's K/V [N, Hkv, hd] as cache rows [N, Wst] in the cache's
    storage dtype, and their scales [N, Hkv] f32 (None for a float cache)."""
    n = k.shape[0]
    if cache.quantized:
        kq, ks = _quantize_kv_cache(cache, k)
        vq, vs = _quantize_kv_cache(cache, v)
    else:
        kq, vq, ks, vs = k, v, None, None
    w = k.shape[-2] * k.shape[-1]
    kq, vq = kq.reshape(n, w), vq.reshape(n, w)   # n may be 0 (no live row)
    if cache.k.dtype == torch.uint8:  # packed int4
        kq, vq = pack_kv_codes(kq), pack_kv_codes(vq)
    return kq.to(cache.k.dtype), vq.to(cache.v.dtype), ks, vs


def _write_pages(cache, layer: int, pages, offsets, k, v, mesh=None) -> None:
    """Write K/V [N, Hkv, hd] in place at pool rows (layer, pages[i],
    offsets[i]), quantizing (and packing) for an int8/int4 pool (a 5D pool
    takes the rows as [N, Hkv, hd]). Under a tp mesh that cuts the kv heads
    (the rank's `kv_mesh`) and whose ranks each hold the whole scale pool,
    the rows' scales are gathered over tp first, so that every rank's copy
    is the whole pool's (one all_reduce for both)."""
    kq, vq, ks, vs = _kv_rows(cache, k, v)
    if cache.k.dim() == 5:
        kq, vq = kq.view(k.shape), vq.view(v.shape)
    cache.k[layer][pages, offsets] = kq
    cache.v[layer][pages, offsets] = vq
    if ks is not None and sharding.paged_scales_whole(cache, k.shape[1], mesh):
        ks, vs = mesh.gather(torch.stack([ks, vs]), "tp").unbind(0)   # one collective
    if ks is not None:
        hp = cache.k_scale.shape[2]
        cache.k_scale[layer][pages, :, offsets] = _pad_heads(ks, hp).to(cache.k_scale.dtype)
        cache.v_scale[layer][pages, :, offsets] = _pad_heads(vs, hp).to(cache.v_scale.dtype)


def _write_slot_kv(cache: KVCache, layer: int, slot: int, start: int, k, v,
                   l_off: int = 0) -> None:
    """Write K/V [C, Hkv, hd] in place at (layer, slot, start..start+C),
    quantizing (and packing) for an int8/int4 cache. A cache that holds
    the L window [l_off, l_off + max_len) of the sequence (an sp rank's)
    keeps the rows that fall inside it."""
    a, b = max(start, l_off), min(start + k.shape[0], l_off + cache.max_len)
    if a >= b:
        return
    kq, vq, ks, vs = _kv_rows(cache, k[a - start:b - start], v[a - start:b - start])
    a, b = a - l_off, b - l_off
    cache.rows(cache.k)[layer, slot, a:b] = kq
    cache.rows(cache.v)[layer, slot, a:b] = vq
    if ks is not None:
        cache.k_scale[layer, slot, :, a:b] = ks.t().to(cache.k_scale.dtype)
        cache.v_scale[layer, slot, :, a:b] = vs.t().to(cache.v_scale.dtype)


def _attend_window(q, k_rows, v_rows, k_scale, v_scale, mask, p: LlamaParams):
    """Chunk attention over a window of cache rows, as the JAX package's
    prefill_chunk, prefill_paged_suffix and verify_step_paged compute it
    (XLA einsums: bf16 dots, no q or P requant): q [..., C, H, hd] (rope
    applied); k_rows/v_rows [..., win, Wst] (codes, packed int4 codes or
    values), or [..., win, Hkv, hd] (a 5D cache's window);
    k_scale/v_scale [..., Hkv, win] or None; mask [..., C, win]. Leading
    dims (slots) batch. Returns [..., C, H*hd] f32."""
    c, win = q.shape[-3], mask.shape[-1]
    lead = q.shape[:-3]
    if k_rows.dtype == torch.uint8:
        k_rows, v_rows = unpack_kv_codes(k_rows), unpack_kv_codes(v_rows)
    k_all = k_rows.reshape(*lead, win, p.n_kv_heads, p.head_dim)
    v_all = v_rows.reshape(*lead, win, p.n_kv_heads, p.head_dim)
    qg = q.reshape(*lead, c, p.n_kv_heads, p.n_heads // p.n_kv_heads, p.head_dim)
    cdt = torch.float32 if k_all.dtype == torch.float32 else torch.bfloat16
    scores = torch.einsum("...cgrd,...lgd->...cgrl", qg.to(cdt).to(torch.float32),
                          k_all.to(cdt).to(torch.float32))
    if k_scale is not None:
        scores = scores * k_scale[..., None, :, None, :]
    scores = true_div(scores, math.sqrt(p.head_dim))
    scores = torch.where(mask[..., :, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[..., None, :, None, :]
    out = torch.einsum("...cgrl,...lgd->...cgrd", probs.to(cdt).to(torch.float32),
                       v_all.to(cdt).to(torch.float32))
    return out.reshape(*lead, c, p.n_heads * p.head_dim)


def _window_scales(cache: KVCache, layer: int, win: int):
    """This layer's [S, Hkv, win] scales of the first `win` rows (views), or
    (None, None) for a float cache."""
    if not cache.quantized:
        return None, None
    return cache.k_scale[layer, :, :, :win], cache.v_scale[layer, :, :, :win]


def _paged_window_scales(cache, layer: int, cols: torch.Tensor, p: LlamaParams):
    """The scale pages of a [S, n_cols] page table gathered into [S, Hkv,
    n_cols * ps] windows, or (None, None) for a float pool."""
    if not cache.quantized:
        return None, None
    s, n_cols = cols.shape
    l_virt = n_cols * cache.page_size

    def gather(pool):  # [S, n_cols, hp, ps] -> [S, Hkv, l_virt]
        return pool[layer][cols].permute(0, 2, 1, 3).reshape(s, -1, l_virt)[:, :p.n_kv_heads]

    return gather(cache.k_scale), gather(cache.v_scale)


def _decode_attn_mode(p: LlamaParams) -> str:
    """Decode-attention implementation, read from TPUSERVE_DECODE_ATTN
    (case-insensitive) once per call of decode_step, verify_step and
    decode_step_paged, as the JAX package's `_decode_attn_mode`:

    - "pallas" (default): the flat kernel in decode_step, the multi-candidate
      kernel in verify_step, the paged kernel in decode_step_paged;
    - "grouped": decode_step through the grouped kernel
      (`ops.decode_attention`) over the [S, win, Hkv, hd] window;
      verify_step and decode_step_paged take the einsum path;
    - any other value, "xla": the einsum path (`_attend_window`) in all three.

    "pallas" with a head_dim that is not a multiple of 128 means "xla", as in
    the JAX package. Unlike it, the CPU keeps "pallas" and "grouped" (their
    kernels' plain versions), where the JAX package takes "xla" off a TPU."""
    mode = os.environ.get("TPUSERVE_DECODE_ATTN", "pallas").lower()
    if mode not in ("pallas", "grouped"):
        return "xla"
    if mode == "pallas" and p.head_dim % 128 != 0:
        return "xla"
    return mode


def _attend_grouped(q, cache: KVCache, layer: int, win: int, positions, p: LlamaParams):
    """decode_step's attention under "grouped": the first `win` rows of this
    layer through the grouped kernel, read in place: an int8 or float cache
    as [S, win, Hkv, hd] with [S, win, Hkv] scales (transposed views)
    through `ops.decode_attention`; a packed int4 cache as its packed window
    [S, win, W/2] with the head-major [S, Hkv, win] scales through
    `ops.decode_attention_packed`, which decodes the nibbles itself (the
    JAX package unpacks the window in XLA first: the same codes). q [S, H,
    hd] with RoPE applied; returns [S, H, hd] f32."""
    s = q.shape[0]
    k_rows, v_rows = cache.k[layer, :, :win], cache.v[layer, :, :win]
    ks, vs = _window_scales(cache, layer, win)
    q = true_div(q, math.sqrt(p.head_dim))
    if cache.k.dtype == torch.uint8:
        return decode_attention_packed(q, k_rows, v_rows, ks, vs, positions)
    shape = (s, win, p.n_kv_heads, p.head_dim)
    if ks is not None:
        ks, vs = ks.transpose(1, 2), vs.transpose(1, 2)
    return decode_attention(q, k_rows.view(shape), v_rows.view(shape), ks, vs, positions)


# ---------------------------------------------------------------------- blocks
def _attention_prefill(q, k, v, mask):
    """Full self-attention over the prompt. q,k,v [B, L, H(kv), hd]."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    scores = torch.einsum("blhd,bmhd->bhlm", q.to(torch.float32), k.to(torch.float32))
    scores = true_div(scores, math.sqrt(hd))
    scores = torch.where(mask[:, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(v.dtype)


def _forward_block(params, pre, x, p: LlamaParams, attn_fn, mm=None):
    """One transformer block; attn_fn maps (q, k, v) -> attn output. Uses the
    fused wqkv / w_gateup weights when the checkpoint carries them; a MoE
    model's FFN is _moe_ffn. `mm` overrides the projections' matmul
    (default `_mm`; GPTQ's calibration pass records each projection's input
    through it)."""
    mm = mm or _mm
    qd = p.n_heads * p.head_dim
    kvd = p.n_kv_heads * p.head_dim
    mesh = _mesh()
    # under tp the column shards' outputs are gathered, then each rank takes
    # its heads (and its ffn columns), as GSPMD reshards them in the JAX package
    full = (lambda y: mesh.gather(y, "tp")) if mesh is not None else (lambda y: y)
    heads = None if mesh is None else sharding.attention_heads(p, mesh)
    h = rms_norm(params, f"{pre}/attn_norm", x, p.rms_eps)
    if f"{pre}/wqkv/kernel" in params:
        qkv = full(mm(params, f"{pre}/wqkv/kernel", h))
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    else:
        q = full(mm(params, f"{pre}/wq/kernel", h))
        k = full(mm(params, f"{pre}/wk/kernel", h))
        v = full(mm(params, f"{pre}/wv/kernel", h))
    if heads is not None:
        # every kv head on every rank (kv_replicated): the query heads of the
        # kv groups over its wo rows attend, and it keeps those rows' columns
        group = p.n_heads // p.n_kv_heads * p.head_dim
        q = q[..., heads[0].start * group:heads[0].stop * group]
    elif mesh is not None:
        q, k, v = (_tp_part(t, mesh) for t in (q, k, v))
    attn_out = attn_fn(q, k, v)
    if heads is not None:
        attn_out = attn_out[..., heads[1]].contiguous()
    x = x + mm(params, f"{pre}/wo/kernel", attn_out)
    h = rms_norm(params, f"{pre}/mlp_norm", x, p.rms_eps)
    if p.n_experts:
        return x + _moe_ffn(params, pre, h, p, mm=mm)
    if f"{pre}/w_gateup/kernel" in params:
        gateup = full(mm(params, f"{pre}/w_gateup/kernel", h))
        gate, up = gateup[..., :p.ffn_dim], gateup[..., p.ffn_dim:]
    else:
        gate = full(mm(params, f"{pre}/w_gate/kernel", h))
        up = full(mm(params, f"{pre}/w_up/kernel", h))
    if mesh is not None:
        gate, up = _tp_part(gate, mesh), _tp_part(up, mesh)
    gate = F.silu(gate.to(torch.float32)).to(h.dtype)
    return x + mm(params, f"{pre}/w_down/kernel", gate * up)


def _tp_part(t: torch.Tensor, mesh) -> torch.Tensor:
    """This tp rank's contiguous share of the last dim (its heads)."""
    n = t.shape[-1] // mesh.shape["tp"]
    return t[..., mesh.coords["tp"] * n:(mesh.coords["tp"] + 1) * n]


# ---------------------------------------------------------------------- MoE
def _expert_slice(w, e: int):
    """One expert's [K, N] weight from a stacked [E, K, N] tensor or
    QExperts: a view, no copy."""
    if isinstance(w, QExperts):
        return w.expert(e)
    return w[e]


def expert_forward(h: torch.Tensor, gu, dn, ffn_dim: int) -> torch.Tensor:
    """One expert's gated-silu FFN over all rows of h [T, D] -> [T, D].
    gu [D, 2F] (fused gate|up), dn [F, D]; dense tensors or QTensors."""
    gateup = _mm_w(h, gu)
    gate, up = gateup[..., :ffn_dim], gateup[..., ffn_dim:]
    gate = F.silu(gate.to(torch.float32)).to(h.dtype)
    return _mm_w(gate * up, dn)


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index, as jax.lax.top_k breaks them (torch.topk promises no
    order for ties): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_combine_weights(logits: torch.Tensor, n_experts: int, k: int) -> torch.Tensor:
    """Top-k routing: logits [.., E] -> combine weights [.., E] f32 (softmax
    over the selected k, zero elsewhere), the Mixtral convention."""
    top_vals, top_idx = _top_k(logits.to(torch.float32), k)
    unnorm = torch.exp(top_vals - top_vals.amax(dim=-1, keepdim=True))
    gates = unnorm / unnorm.sum(dim=-1, keepdim=True)  # jax.nn.softmax's form
    zeros = torch.zeros(logits.shape[:-1] + (n_experts,), dtype=torch.float32,
                        device=logits.device)
    return zeros.scatter(-1, top_idx, gates)


def _moe_ffn(params, pre, h, p: LlamaParams, mm=None):
    """Mixture-of-Experts FFN (Mixtral-style top-k routing). Under a live
    mesh whose tp divides E, the JAX package's mesh branch: the rank's E/tp
    experts in the dense loop, one psum over tp (moe_ffn_sharded).

    Every expert runs on every call, whatever the routing, so a call
    launches the same kernels each time and never syncs on per-expert
    counts. 3-D input (prefill and its chunks) takes the static-capacity
    dispatch (_moe_dispatch) whenever TPUSERVE_MOE_CF > 0 and the capacity
    is under the token count; 2-D input (decode [S, D], verify [S*C, D])
    only at T >= TPUSERVE_MOE_DECODE_DISPATCH_T (default 64). Otherwise
    the dense loop runs every expert over all T rows and combines through
    the routing weights (zero for unrouted pairs). Both knobs are read per
    call. `mm` is taken as the JAX package takes it, where it only keeps a
    call inside a shard_map island from nesting another: the router and the
    experts never go through it, so calibration records no expert input."""
    router = params[f"{pre}/router/kernel"]
    logits = torch.matmul(h.to(torch.float32), router.to(torch.float32))
    w_se = moe_combine_weights(logits, p.n_experts, p.n_experts_per_tok)
    gu = params[f"{pre}/moe_gateup/kernel"]
    dn = params[f"{pre}/moe_down/kernel"]

    lead_shape = h.shape[:-1]
    h2 = h.reshape(-1, h.shape[-1])        # [T, D]
    w2 = w_se.reshape(-1, p.n_experts)     # [T, E]
    mesh = None if mm is _mm_direct else _mesh()
    if mesh is not None and p.n_experts % mesh.shape["tp"] == 0:
        # the JAX package's mesh branch: the rank's E/tp experts, every row
        return sharding.moe_ffn_sharded(h2, w2, gu, dn, p, mesh).reshape(*lead_shape,
                                                                          h.shape[-1])
    cf = float(os.environ.get("TPUSERVE_MOE_CF", "2.0"))
    decode_t = int(os.environ.get("TPUSERVE_MOE_DECODE_DISPATCH_T", "64"))
    t = h2.shape[0]
    if cf > 0 and (len(lead_shape) > 1 or t >= decode_t):
        cap = min(t, max(8, int(math.ceil(t * p.n_experts_per_tok / p.n_experts * cf))))
        if cap < t:
            return _moe_dispatch(h2, w2, gu, dn, p, cap).reshape(*lead_shape, h.shape[-1])
    from tpuserve_torch.ops import quant_matmul

    before = quant_matmul.launches
    out = torch.zeros_like(h2)
    for e in range(p.n_experts):
        y = expert_forward(h2, _expert_slice(gu, e), _expert_slice(dn, e), p.ffn_dim)
        out = out + w2[:, e:e + 1].to(y.dtype) * y
    sharding._launched("quant_matmul experts", before, quant_matmul.launches, (p.n_experts,))
    return out.reshape(*lead_shape, h.shape[-1])


def _moe_dispatch(h2: torch.Tensor, w2: torch.Tensor, gu, dn, p: LlamaParams,
                  cap: int) -> torch.Tensor:
    """Static-capacity top-k dispatch: gather each expert's routed tokens
    into an [E, cap, D] buffer, run every expert over its own cap rows,
    scatter-add the weighted outputs back in f32, one expert after another.
    Pairs (token, expert) take an expert's slots in token order, the top
    pick of a token first; pairs past an expert's capacity go to an
    overflow slot that is dropped, so they lose that expert's contribution;
    unrouted slots point at token 0 with weight 0. Within one expert every
    real index is distinct, so the f32 sums keep the JAX package's order.
    All shapes are static and nothing waits on the device.

    h2 [T, D] tokens; w2 [T, E] combine weights (zero off the top-k)."""
    t, d = h2.shape
    e_n, k = p.n_experts, p.n_experts_per_tok
    dev = h2.device
    top_w, top_idx = _top_k(w2, k)                                  # [T, k]
    pair_e = top_idx.reshape(-1)                                    # expert per pair
    pair_t = torch.arange(t * k, device=dev) // k                   # token per pair
    onehot = (pair_e[:, None] == torch.arange(e_n, device=dev)[None, :]).long()
    pos_in_e = ((onehot.cumsum(0) - 1) * onehot).sum(1)           # arrival order
    slot = torch.clamp_max(pos_in_e, cap)                           # cap = overflow bin
    gat_t = torch.zeros((e_n, cap + 1), dtype=torch.long, device=dev)
    gat_w = torch.zeros((e_n, cap + 1), dtype=torch.float32, device=dev)
    gat_t[pair_e, slot] = pair_t
    gat_w[pair_e, slot] = top_w.reshape(-1).to(torch.float32)
    gat_t, gat_w = gat_t[:, :cap], gat_w[:, :cap]                   # drop the overflow bin
    xg = h2[gat_t.reshape(-1)].reshape(e_n, cap, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for e in range(e_n):
        y = expert_forward(xg[e], _expert_slice(gu, e), _expert_slice(dn, e), p.ffn_dim)
        out.index_add_(0, gat_t[e], gat_w[e][:, None] * y.to(torch.float32))
    return out.to(h2.dtype)


def _logits(params, x, p: LlamaParams):
    h = rms_norm(params, "final_norm", x, p.rms_eps)
    if p.tie_embeddings:
        w = params["embed/weight"]
        if isinstance(w, QTensor):
            raise ValueError("tied embeddings cannot be quantized")
        return torch.matmul(h.to(torch.float32), w.to(torch.float32).t())
    logits = _mm(params, "lm_head/kernel", h).to(torch.float32)
    mesh = _mesh()
    return logits if mesh is None else mesh.gather(logits, "tp")


# ---------------------------------------------------------------------- prefill
def _on_slot_group(mesh, cache: KVCache, slot: int, vocab: int, run):
    """Run a one-slot step (`run(local_slot)` -> logits [1, V] f32) on the
    dp group that owns `slot` under a mesh: the other dp groups hold
    nothing of the slot and add zeros, so every rank gets its logits."""
    if mesh is None or mesh.shape["dp"] == 1:
        return run(slot)
    owner, local = divmod(slot, cache.n_slots)
    if owner == mesh.coords["dp"]:
        logits = run(local)
    else:
        logits = torch.zeros((1, vocab), dtype=torch.float32, device=cache.k.device)
    return mesh.psum(logits, "dp")


def prefill(params, p: LlamaParams, tokens: torch.Tensor, cache: KVCache, slot: int,
            length: int):
    """Process a prompt into cache slot `slot`.

    tokens: int [1, L] (right-padded to a bucket; `length` = real length).
    Returns (logits_last [1, V] f32 at position length-1, cache). Under a
    mesh, `cache` is the rank's block (its slots, kv heads and L window).
    """
    b, l = tokens.shape
    slot, length = int(slot), int(length)
    mesh = _mesh()
    pl, pa, hs, _ = _rank_heads(p, mesh)
    l_off = _l_off(mesh, cache)
    positions = torch.arange(l, device=tokens.device)[None, :]
    cos, sin = rope_cos_sin(positions, p.head_dim, p.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    valid = positions < length
    mask = valid[:, None, :] & (positions[:, :, None] >= positions[:, None, :])

    def run(local_slot: int):
        x = params["embed/weight"][tokens]  # embeddings stay unquantized
        for layer in range(p.n_layers):
            def attn_fn(q, k, v, layer=layer):
                q = apply_rope(q.reshape(b, l, pa.n_heads, p.head_dim), cos, sin)
                k = apply_rope(k.reshape(b, l, pl.n_kv_heads, p.head_dim), cos, sin)
                v = v.reshape(b, l, pl.n_kv_heads, p.head_dim)
                # write K/V into the slot (whole bucket; the invalid tail is
                # masked on every read)
                _write_slot_kv(cache, layer, local_slot, 0, k[0], v[0], l_off)
                out = _attention_prefill(q, _kv_heads(k, hs), _kv_heads(v, hs), mask)
                return out.reshape(b, l, pa.n_heads * p.head_dim)

            x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)
        return _logits(params, x[:, length - 1, :], p)

    return _on_slot_group(mesh, cache, slot, p.vocab_size, run), cache


def prefill_chunk(params, p: LlamaParams, tokens: torch.Tensor, cache: KVCache, slot: int,
                  start: int, length: int, window: int):
    """Process ONE chunk of a prompt into cache slot `slot`.

    tokens: int [1, C] (right-padded; `length` = valid tokens); start: global
    position of tokens[0]; `window` = bucket covering start+C. Queries attend
    to cache positions < start (earlier chunks) plus causally within the
    chunk. The padded tail writes garbage K/V at [start+length, start+C),
    which decode overwrites before any read reaches it. Under sp each rank
    attends over its L window, the softmax split over sp as GSPMD splits the
    JAX package's einsums (`sharding.attend_seq_softmax`). Returns (logits
    [1, V] at the chunk's last valid position, cache).
    """
    b, c = tokens.shape
    slot, start, length, window = int(slot), int(start), int(length), int(window)
    dev = tokens.device
    mesh = _mesh()
    pl, pa, hs, _ = _rank_heads(p, mesh)
    av = _attn_view(cache, hs, p.head_dim)
    l_off = _l_off(mesh, cache)
    gpos = start + torch.arange(c, device=dev)
    cos, sin = rope_cos_sin(gpos[None, :], p.head_dim, p.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    kpos = torch.arange(window, device=dev)
    mask = kpos[None, :] <= gpos[:, None]  # [C, win]

    def run(ls: int):
        x = params["embed/weight"][tokens]
        for layer in range(p.n_layers):
            def attn_fn(q, k, v, layer=layer):
                q = apply_rope(q.reshape(b, c, pa.n_heads, p.head_dim), cos, sin)
                k = apply_rope(k.reshape(b, c, pl.n_kv_heads, p.head_dim), cos, sin)
                v = v.reshape(b, c, pl.n_kv_heads, p.head_dim)
                _write_slot_kv(cache, layer, ls, start, k[0], v[0], l_off)
                if sharding.mesh_sp(mesh) > 1:
                    k5, v5 = _heads_view(av, pa)
                    out = sharding.attend_seq_softmax(
                        q, k5[layer, ls:ls + 1], v5[layer, ls:ls + 1],
                        av.k_scale[layer, ls:ls + 1] if av.quantized else None,
                        av.v_scale[layer, ls:ls + 1] if av.quantized else None,
                        gpos[None, :], mesh, math.sqrt(p.head_dim))
                    return out.to(x.dtype).reshape(b, c, -1)
                ks = vs = None
                if av.quantized:
                    ks = av.k_scale[layer, ls][:, :window]
                    vs = av.v_scale[layer, ls][:, :window]
                out = _attend_window(q[0], av.k[layer, ls, :window], av.v[layer, ls, :window],
                                     ks, vs, mask, pa)
                return out.to(x.dtype).reshape(b, c, -1)

            x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)
        return _logits(params, x[:, length - 1, :], p)

    return _on_slot_group(mesh, cache, slot, p.vocab_size, run), cache


def _rank_heads(p: LlamaParams, mesh):
    """This rank's heads: (pl, pa, hs, kv_mesh). pl: the LlamaParams of its
    K/V and cache (its kv-head groups, or every head where
    sharding.kv_replicated); pa: those of the attention it runs; hs: the kv
    heads of pl that pa attends over (None: all of them); kv_mesh: the mesh
    where its tp cuts the kv heads (a paged pool's replicated scale rows are
    then the rank's view and gathered over tp on a write), else None."""
    if mesh is None:
        return p, p, None, None
    pl = sharding.local_llama_params(p, mesh)
    heads = sharding.attention_heads(p, mesh)
    if heads is None:
        return pl, pl, None, mesh
    n_kv = heads[0].stop - heads[0].start
    pa = dataclasses.replace(p, n_heads=n_kv * (p.n_heads // p.n_kv_heads), n_kv_heads=n_kv)
    return pl, pa, heads[0], None


def _attn_view(cache, hs: Optional[slice], head_dim: int):
    """A KVCache or PagedKVCache as the rank's attention reads it: the cache
    itself, or where it holds every kv head (kv_replicated) views of k and
    v as [.., Hkv, hd] and of the head-major scales at the kv heads `hs`
    (no copy; writes to the cache show through)."""
    if hs is None:
        return cache
    if cache.k.dtype == torch.uint8:
        raise ValueError("kv_cache int4 under tp needs tp | n_kv_heads")

    def heads(t):
        if t.dim() == 4:   # flat rows: W on head boundaries
            t = t.view(t.shape[:3] + (-1, head_dim))
        return t[..., hs, :]

    return dataclasses.replace(
        cache, k=heads(cache.k), v=heads(cache.v),
        k_scale=None if cache.k_scale is None else cache.k_scale[:, :, hs],
        v_scale=None if cache.v_scale is None else cache.v_scale[:, :, hs])


def _kv_heads(t: torch.Tensor, hs: Optional[slice]) -> torch.Tensor:
    """K or V [.., Hkv, hd] at the kv heads `hs` (all of them for None)."""
    return t if hs is None else t[..., hs, :]


def _l_off(mesh, cache: KVCache) -> int:
    """The first global position of this rank's L window (0 without sp)."""
    return 0 if mesh is None else mesh.coords["sp"] * cache.max_len


def _heads_view(cache: KVCache, pl: LlamaParams):
    """k and v as [n_layers, S, L, Hkv, hd] (a view of a flat int8 or float
    cache)."""
    if not cache.flat:
        return cache.k, cache.v
    shape = cache.k.shape[:3] + (pl.n_kv_heads, pl.head_dim)
    return cache.k.view(shape), cache.v.view(shape)


# ---------------------------------------------------------------------- decode
def decode_step(params, p: LlamaParams, tokens: torch.Tensor, cache: KVCache,
                positions: torch.Tensor, window: Optional[int] = None, *,
                active_idx: Optional[torch.Tensor] = None):
    """One continuous-batching decode step over all S slots.

    tokens: int [S] (current token per slot); positions: int [S] (index where
    this token goes; negative = inactive slot). `window` limits attention
    reads to the first `window` cache positions; callers guarantee
    max(positions)+1 <= window. `active_idx` (the indices of slots with
    positions >= 0) may be passed to spare a device-to-host sync. Attention
    follows `_decode_attn_mode`. Returns (logits [S, V] f32, cache).

    Under a mesh each rank steps its dp slots (the flat core on its kv
    heads, or under sp the seq-sharded merge over its L window, which reads
    the whole window) and the logits are gathered over dp.
    """
    mode = _decode_attn_mode(p)
    mesh = _mesh()
    pl, pa, hs, _ = _rank_heads(p, mesh)
    if mode == "pallas" and mesh is not None and cache.k.dtype == torch.uint8 \
            and (cache.k.shape[-1] % 128):
        mode = "xla"   # a packed shard narrower than the core's 128-byte rows, as in JAX
    if hs is not None:
        mode = "xla"   # every kv head on every rank: GSPMD's einsums in the JAX package
    av = _attn_view(cache, hs, p.head_dim)
    positions = positions.to(device=tokens.device, dtype=torch.int32)
    all_active = positions >= 0
    sp = sharding.mesh_sp(mesh)
    if mesh is not None:
        lo, hi = sharding.local_slots(mesh, tokens.shape[0])
        tokens, positions = tokens[lo:hi], positions[lo:hi]
        active_idx = None
    s = tokens.shape[0]
    active = positions >= 0
    pos = positions.clamp_min(0)
    l_off = _l_off(mesh, cache)
    if active_idx is None:
        held = active if sp == 1 else active & (pos >= l_off) & (pos < l_off + cache.max_len)
        active_idx = torch.nonzero(held).flatten()
    pos_a = pos[active_idx].long() - l_off
    x = params["embed/weight"][tokens]  # [S, D]
    cos, sin = rope_cos_sin(pos, p.head_dim, p.rope_theta)
    cos_q, sin_q = cos[:, None, :], sin[:, None, :]
    win = cache.max_len if window is None else min(int(window), cache.max_len)
    read_mask = torch.arange(win, device=tokens.device)[None, :] <= pos[:, None]  # [S, win]
    k_rows, v_rows = cache.rows(cache.k), cache.rows(cache.v)

    for layer in range(p.n_layers):
        def attn_fn(q, k, v, layer=layer):
            q = apply_rope(q.reshape(s, pa.n_heads, p.head_dim), cos_q, sin_q)
            k = apply_rope(k.reshape(s, pl.n_kv_heads, p.head_dim), cos_q, sin_q)
            v = v.reshape(s, pl.n_kv_heads, p.head_dim)
            kq, vq, ks, vs = _kv_rows(cache, k, v)  # [S, Wst] rows, [S, Hkv]
            # In-place write of this step's K/V at (layer, slot, pos) for the
            # ACTIVE slots only (under sp: those whose position lies in this
            # rank's window): other rows are never written. (JAX writes
            # functionally and rewrites the old value for inactive slots.)
            k_rows[layer][active_idx, pos_a] = kq[active_idx]
            v_rows[layer][active_idx, pos_a] = vq[active_idx]
            if ks is not None:
                cache.k_scale[layer][active_idx, :, pos_a] = ks[active_idx].to(cache.k_scale.dtype)
                cache.v_scale[layer][active_idx, :, pos_a] = vs[active_idx].to(cache.v_scale.dtype)
            if sp > 1:
                k5, v5 = _heads_view(av, pa)
                out = sharding.decode_attention_seq_sharded(
                    true_div(q, math.sqrt(p.head_dim)), k5[layer], v5[layer],
                    av.k_scale[layer] if av.quantized else None,
                    av.v_scale[layer] if av.quantized else None, positions, mesh)
            elif mode == "pallas":
                args = (true_div(q, math.sqrt(p.head_dim)), k_rows, v_rows,
                        cache.k_scale[layer] if cache.quantized else None,
                        cache.v_scale[layer] if cache.quantized else None,
                        positions, layer)
                if mesh is not None:
                    out = sharding.decode_attention_sharded(*args, mesh, window=win)
                else:
                    out = decode_attention_wide_cache(*args, window=win)
            elif mode == "grouped":
                out = _attend_grouped(q, cache, layer, win, positions, pl)
            else:
                out = _attend_window(q[:, None], av.k[layer, :, :win], av.v[layer, :, :win],
                                     *_window_scales(av, layer, win), read_mask[:, None], pa)
            return out.to(x.dtype).reshape(s, pa.n_heads * p.head_dim)

        x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)

    logits = torch.where(active[:, None], _logits(params, x, p), 0.0)
    if mesh is not None:
        logits = mesh.gather(logits, "dp", dim=0)
    return torch.where(all_active[:, None], logits, 0.0), cache


# ---------------------------------------------------------------------- speculation
def draft_lookup(hist: torch.Tensor, seq_lens: torch.Tensor, n: int, k: int,
                 k_cap: torch.Tensor):
    """Prompt-lookup drafting on the device, in tensor ops (no host sync).

    hist [S, L] int: each slot's token history (prompt + generated,
    including the uncommitted last token), right-padded; seq_lens [S] valid
    tokens per row; n the n-gram length, k the most drafts; k_cap [S] a
    per-slot cap. The trailing n-gram is matched against every window that
    ends before the sequence tail; the rightmost match with >= k tokens
    after it wins, else the match with the longest continuation (the first
    of equals). Returns (drafts [S, k] right-padded with 0, k_eff [S]), the
    JAX package's draft_lookup integer for integer."""
    s, l = hist.shape
    dev = hist.device
    seq_lens = seq_lens.to(device=dev, dtype=torch.int64)
    k_cap = k_cap.to(device=dev, dtype=torch.int64)
    idx = torch.arange(l - n + 1, device=dev)                   # window starts
    win = hist.unfold(1, n, 1)                                  # [S, L-n+1, n]
    pat_idx = torch.clamp(seq_lens[:, None] - n + torch.arange(n, device=dev)[None, :], 0, l - 1)
    pat = torch.gather(hist, 1, pat_idx)                        # [S, n]
    match = (win == pat[:, None, :]).all(dim=-1)                # [S, L-n+1]
    avail = seq_lens[:, None] - (idx[None, :] + n)              # continuation tokens
    valid = match & (avail >= 1) & (seq_lens[:, None] >= n + 1)
    full = valid & (avail >= k)
    j_full = torch.where(full, idx[None, :], -1).amax(dim=1)   # rightmost
    avail_masked = torch.where(valid, avail, -1)
    j_best = torch.argmax(avail_masked, dim=1)                  # first max
    has_any = avail_masked.amax(dim=1) >= 1
    j = torch.where(j_full >= 0, j_full, j_best)
    av = torch.gather(avail, 1, j[:, None])[:, 0]
    k_eff = torch.where(has_any, torch.clamp(torch.minimum(av, k_cap), 0, k), 0)
    cols = torch.arange(k, device=dev)[None, :]
    drafts = torch.gather(hist, 1, torch.clamp(j[:, None] + n + cols, 0, l - 1))
    return torch.where(cols < k_eff[:, None], drafts, 0), k_eff


def _verify_prep(params, p: LlamaParams, tokens, positions, lengths, l_max: int):
    """What verify_step and verify_step_paged share: per-(slot, candidate)
    positions pos_c [S, C] (clamped to l_max - 1), the valid mask [S, C],
    the 2-D embeddings [S*C, D] and RoPE tables [S, C, 1, hd/2]."""
    s, c = tokens.shape
    dev = tokens.device
    positions = positions.to(device=dev, dtype=torch.int64)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    cols = torch.arange(c, device=dev)[None, :]
    active = positions >= 0
    pos_c = torch.clamp_max(positions.clamp_min(0)[:, None] + cols, l_max - 1)
    valid = active[:, None] & (cols < lengths[:, None])
    x = params["embed/weight"][tokens].reshape(s * c, p.dim)
    cos, sin = rope_cos_sin(pos_c, p.head_dim, p.rope_theta)
    return pos_c, valid, x, cos[:, :, None, :], sin[:, :, None, :]


def verify_step(params, p: LlamaParams, tokens: torch.Tensor, cache: KVCache,
                positions: torch.Tensor, lengths: torch.Tensor,
                window: Optional[int] = None):
    """Speculative verification: C candidate tokens per slot in one step.

    tokens [S, C]: column 0 is the slot's real next token, columns 1.. a
    drafted continuation (right-padded); positions [S] where column 0 goes
    (-1 = inactive); lengths [S] valid tokens per row (>= 1 for a live
    slot). `window` bounds attention reads; callers guarantee
    max(positions) + C <= window. Returns (logits [S, C, V] f32, position
    j's predicting token j+1, 0 on invalid rows; cache).

    Activations stay 2-D [S*C, D] through the blocks. Every candidate's
    K/V is written in place at positions[s] + c (clamped to L-1, as in the
    JAX package) before attention reads, so draft j attends to drafts < j
    through the cache; rejected drafts leave entries past the slot's live
    position, masked on every later read and overwritten later. An invalid
    row stores back the bytes it read, so the cache ends as if only valid
    rows were written, with no host sync (the fused rounds need none).
    Callers keep valid rows below L-1, where clamped invalid rows gather.
    Attention is the multi-candidate kernel (`decode_attention_wide_cache_
    multi`) under "pallas" and the einsum path otherwise (`_decode_attn_mode`).
    Under a live mesh the rank runs its part (`_verify_rank`)."""
    mesh = _mesh()
    if mesh is not None:
        return _verify_rank(params, p, tokens, cache, positions, lengths, window, mesh)
    s, c = tokens.shape
    mode = _decode_attn_mode(p)
    pos_c, valid, x, cos_q, sin_q = _verify_prep(params, p, tokens, positions, lengths,
                                                 cache.max_len)
    win = cache.max_len if window is None else min(int(window), cache.max_len)
    read_mask = torch.arange(win, device=tokens.device)[None, None, :] <= pos_c[:, :, None]
    sidx = torch.arange(s, device=tokens.device)[:, None]   # broadcasts against pos_c

    def masked(new, old):  # [S, C, ...]: the new rows where valid, else the old
        return torch.where(valid[:, :, None], new.view(s, c, -1).to(old.dtype), old)

    for layer in range(p.n_layers):
        def attn_fn(q, k, v, layer=layer):
            q = apply_rope(q.reshape(s, c, p.n_heads, p.head_dim), cos_q, sin_q)
            k = apply_rope(k.reshape(s, c, p.n_kv_heads, p.head_dim), cos_q, sin_q)
            v = v.reshape(s, c, p.n_kv_heads, p.head_dim)
            kq, vq, ks, vs = _kv_rows(cache, k.reshape(s * c, p.n_kv_heads, p.head_dim),
                                      v.reshape(s * c, p.n_kv_heads, p.head_dim))
            for dst, new in ((cache.k[layer], kq), (cache.v[layer], vq)):
                dst[sidx, pos_c] = masked(new, dst[sidx, pos_c])
            if ks is not None:  # head-major scales: [S, C, Hkv] at [sidx, :, pos_c]
                for dst, new in ((cache.k_scale[layer], ks), (cache.v_scale[layer], vs)):
                    dst[sidx, :, pos_c] = masked(new, dst[sidx, :, pos_c])
            if mode == "pallas":
                out = decode_attention_wide_cache_multi(
                    true_div(q, math.sqrt(p.head_dim)), cache.k, cache.v,
                    cache.k_scale[layer] if cache.quantized else None,
                    cache.v_scale[layer] if cache.quantized else None,
                    positions, layer, window=win)
            else:
                out = _attend_window(q, cache.k[layer, :, :win], cache.v[layer, :, :win],
                                     *_window_scales(cache, layer, win), read_mask, p)
            return out.to(x.dtype).reshape(s * c, p.n_heads * p.head_dim)

        x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)

    logits = _logits(params, x, p).reshape(s, c, -1)
    return torch.where(valid[:, :, None], logits, 0.0), cache


def _verify_rank(params, p: LlamaParams, tokens, cache, positions, lengths, window, mesh,
                 page_table=None):
    """verify_step under a live mesh, or verify_step_paged (`page_table`)
    with or without one, on this rank, as the JAX package runs them there
    (einsums: a mesh and a pool have no multi-candidate kernel). The rank's
    dp slots' candidates go through its weight blocks (q, k, v at its
    heads); their K/V is written into its block only: the valid rows of its
    slots, at its kv heads (a packed int4 cache packed per shard), under sp
    only the rows whose position lies in its L window (one slot's
    candidates may straddle two windows), in a pool its slots' pages.
    Attention is `_attend_window` on its heads over its window, or under sp
    the verify's softmax as GSPMD splits it over the windows
    (`sharding.attend_seq_softmax`); positions clamp at the global L - 1
    (a pool's: the window's pages), as in the JAX package. Logits are
    gathered over tp and dp. Under a mesh the host work (the rank's inputs,
    the rows it writes, which syncs) and the step run under
    `sharding.run_agreed`: a failure on any rank raises VerifyFailed on
    every rank."""
    c = tokens.shape[1]
    hd = p.head_dim
    pl, pa, hs, kv_mesh = _rank_heads(p, mesh)
    sp = sharding.mesh_sp(mesh)
    paged = page_table is not None

    def prep():
        toks, pos, lens, table = sharding.local_verify_inputs(mesh, tokens, positions, lengths,
                                                              page_table)
        dev = toks.device
        st = dict(s=toks.shape[0])
        if paged:
            ps = cache.page_size
            table = table.to(device=dev, dtype=torch.long)
            if window is not None:
                table = table[:, :max(1, min(int(window) // ps, table.shape[1]))]
            win = l_lim = table.shape[1] * ps
            ksr, vsr = sharding.paged_scale_rows(cache, pl.n_kv_heads, kv_mesh)
            view = dataclasses.replace(cache, k_scale=ksr, v_scale=vsr)
        else:
            win = cache.max_len if window is None else min(int(window), cache.max_len)
            l_lim = cache.max_len * sp
            view = cache
        st.update(table=table, view=_attn_view(view, hs, hd))
        pos_c, valid, x, cos_q, sin_q = _verify_prep(params, p, toks, pos, lens, l_lim)
        l_off = _l_off(mesh, cache) if not paged else 0
        si, ci, lp = sharding.verify_write_rows(valid, pos_c, l_off,
                                                cache.max_len if sp > 1 else None)
        if paged:
            lp = (st["table"][si, lp // cache.page_size], lp % cache.page_size)
        st.update(win=win, pos_c=pos_c, valid=valid, x=x, cos=cos_q, sin=sin_q, si=si, ci=ci,
                  lp=lp, mask=torch.arange(win, device=dev)[None, None, :] <= pos_c[:, :, None])
        return st

    def body(st):
        s, win, si, ci, lp = st["s"], st["win"], st["si"], st["ci"], st["lp"]
        x, av = st["x"], st["view"]
        for layer in range(p.n_layers):
            def attn_fn(q, k, v, layer=layer):
                q = apply_rope(q.reshape(s, c, pa.n_heads, hd), st["cos"], st["sin"])
                k = apply_rope(k.reshape(s, c, pl.n_kv_heads, hd), st["cos"], st["sin"])
                v = v.reshape(s, c, pl.n_kv_heads, hd)
                if paged:
                    _write_pages(cache, layer, lp[0], lp[1], k[si, ci], v[si, ci], kv_mesh)
                    table = st["table"]
                    out = _attend_window(q, av.k[layer][table].reshape(s, win, -1),
                                         av.v[layer][table].reshape(s, win, -1),
                                         *_paged_window_scales(av, layer, table, pa),
                                         st["mask"], pa)
                    return out.to(x.dtype).reshape(s * c, -1)
                kq, vq, ks, vs = _kv_rows(cache, k[si, ci], v[si, ci])
                cache.rows(cache.k)[layer][si, lp] = kq
                cache.rows(cache.v)[layer][si, lp] = vq
                if ks is not None:
                    cache.k_scale[layer][si, :, lp] = ks.to(cache.k_scale.dtype)
                    cache.v_scale[layer][si, :, lp] = vs.to(cache.v_scale.dtype)
                if sp > 1:
                    k5, v5 = _heads_view(av, pa)
                    out = sharding.attend_seq_softmax(
                        q, k5[layer], v5[layer],
                        av.k_scale[layer] if av.quantized else None,
                        av.v_scale[layer] if av.quantized else None, st["pos_c"], mesh,
                        math.sqrt(hd))
                else:
                    out = _attend_window(q, av.k[layer, :, :win], av.v[layer, :, :win],
                                         *_window_scales(av, layer, win), st["mask"], pa)
                return out.to(x.dtype).reshape(s * c, -1)

            x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)
        logits = _logits(params, x, p).reshape(s, c, -1)
        logits = torch.where(st["valid"][:, :, None], logits, 0.0)
        sharding.verify_rows_written += int(si.numel())
        return logits if mesh is None else mesh.gather(logits, "dp", dim=0)

    if mesh is None:
        return body(prep()), cache
    return sharding.run_agreed(mesh, tokens.device, prep, body), cache


# ---------------------------------------------------------------------- paged
def prefill_paged(params, p: LlamaParams, tokens: torch.Tensor, cache, page_table: torch.Tensor,
                  slot: int, length: int):
    """Prefill into a PagedKVCache (serving/paged_kv.py).

    tokens [1, L_bucket]; page_table [S, P] int32 (pool page ids, 0 = the
    reserved zero page); the engine guarantees the slot's chain covers the
    whole bucket, which is written (the invalid tail is masked on every
    read). Returns (logits_last [1, V], cache).
    """
    b, l = tokens.shape
    slot, length = int(slot), int(length)
    dev = tokens.device
    ps = cache.page_size
    mesh = _mesh()
    pl, pa, hs, kv_mesh = _rank_heads(p, mesh)
    x = params["embed/weight"][tokens]
    positions = torch.arange(l, device=dev)[None, :]
    cos, sin = rope_cos_sin(positions, p.head_dim, p.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    valid = positions < length
    mask = valid[:, None, :] & (positions[:, :, None] >= positions[:, None, :])
    # pool coordinates of logical positions 0..l-1 of this slot
    lpos = torch.arange(l, device=dev)
    pages = page_table[slot].to(device=dev, dtype=torch.long)[lpos // ps]
    offsets = lpos % ps

    for layer in range(p.n_layers):
        def attn_fn(q, k, v, layer=layer):
            q = apply_rope(q.reshape(b, l, pa.n_heads, p.head_dim), cos, sin)
            k = apply_rope(k.reshape(b, l, pl.n_kv_heads, p.head_dim), cos, sin)
            v = v.reshape(b, l, pl.n_kv_heads, p.head_dim)
            _write_pages(cache, layer, pages, offsets, k[0], v[0], kv_mesh)
            out = _attention_prefill(q, _kv_heads(k, hs), _kv_heads(v, hs), mask)
            return out.reshape(b, l, pa.n_heads * p.head_dim)

        x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)

    return _logits(params, x[:, length - 1, :], p), cache


def prefill_paged_suffix(params, p: LlamaParams, tokens: torch.Tensor, cache,
                         page_table: torch.Tensor, slot: int, start: int, length: int,
                         window: int):
    """Prefill the SUFFIX of a prompt whose first `start` tokens already hold
    valid KV in the slot's pages (a shared prefix, or earlier chunks).

    tokens [1, C] (suffix, right-padded; `length` = valid tokens); start =
    global position of tokens[0] (page-aligned); `window` (a page multiple)
    covers start + C. Queries attend to the prefix pages plus causally
    within the suffix, over a plain-torch gather of the window's pages, as
    prefill_chunk does. Only the `length` valid rows are written (the JAX
    package routes the padded tail to a masked zero-page write, which
    leaves the pool as this does). Returns (logits [1, V] at the suffix's
    last valid position, cache).
    """
    b, c = tokens.shape
    slot, start, length = int(slot), int(start), int(length)
    dev = tokens.device
    ps = cache.page_size
    mesh = _mesh()
    pl, pa, hs, kv_mesh = _rank_heads(p, mesh)
    ks_pool, vs_pool = sharding.paged_scale_rows(cache, pl.n_kv_heads, kv_mesh)
    av = _attn_view(dataclasses.replace(cache, k_scale=ks_pool, v_scale=vs_pool), hs,
                    p.head_dim)
    x = params["embed/weight"][tokens]
    gpos = start + torch.arange(c, device=dev)
    cos, sin = rope_cos_sin(gpos[None, :], p.head_dim, p.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    n_cols = max(1, min(int(window) // ps, page_table.shape[1]))
    l_virt = n_cols * ps
    mask = torch.arange(l_virt, device=dev)[None, :] <= gpos[:, None]  # [C, win]
    row = page_table[slot].to(device=dev, dtype=torch.long)
    wpos = gpos[:length]
    wpages, woffs = row[wpos // ps], wpos % ps
    cols = row[:n_cols]

    def window_scales(pool, layer):  # [n_cols, hp, ps] -> [Hkv, l_virt]
        return pool[layer][cols].permute(1, 0, 2).reshape(-1, l_virt)[:pa.n_kv_heads]

    for layer in range(p.n_layers):
        def attn_fn(q, k, v, layer=layer):
            q = apply_rope(q.reshape(b, c, pa.n_heads, p.head_dim), cos, sin)
            k = apply_rope(k.reshape(b, c, pl.n_kv_heads, p.head_dim), cos, sin)
            v = v.reshape(b, c, pl.n_kv_heads, p.head_dim)
            _write_pages(cache, layer, wpages, woffs, k[0, :length], v[0, :length], kv_mesh)
            ks = vs = None
            if av.quantized:
                ks, vs = window_scales(av.k_scale, layer), window_scales(av.v_scale, layer)
            out = _attend_window(q[0], av.k[layer][cols].reshape(l_virt, -1),
                                 av.v[layer][cols].reshape(l_virt, -1), ks, vs, mask, pa)
            return out.to(x.dtype).reshape(b, c, -1)

        x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)

    return _logits(params, x[:, length - 1, :], p), cache


def decode_step_paged(params, p: LlamaParams, tokens: torch.Tensor, cache,
                      page_table: torch.Tensor, positions: torch.Tensor,
                      window: Optional[int] = None, *,
                      active_idx: Optional[torch.Tensor] = None):
    """One decode step over a PagedKVCache.

    page_table [S, P] int32; positions [S] (-1 = inactive). The engine
    guarantees every active slot's chain covers positions[s]+1 tokens.
    `window` limits reads to the leading ceil(window/ps) pages. This step's
    K/V is written in place for the active slots only; under "pallas"
    attention reads the pool in place through `decode_attention_wide_paged`,
    otherwise (`_decode_attn_mode`) the einsum path attends over the
    gathered window. Returns (logits [S, V] f32, cache). Under a mesh the
    rank steps its dp slots over its pool block and the logits are
    gathered over dp.
    """
    mode = _decode_attn_mode(p)
    dev = tokens.device
    ps = cache.page_size
    mesh = _mesh()
    pl, pa, hs, kv_mesh = _rank_heads(p, mesh)
    if hs is not None:
        mode = "xla"   # every kv head on every rank: GSPMD's einsums in the JAX package
    positions = positions.to(device=dev, dtype=torch.int32)
    page_table = page_table.to(device=dev, dtype=torch.int32)
    all_active = positions >= 0
    if mesh is not None:
        lo, hi = sharding.local_slots(mesh, tokens.shape[0])
        tokens, positions, page_table = tokens[lo:hi], positions[lo:hi], page_table[lo:hi]
        active_idx = None
    s = tokens.shape[0]
    if window is not None:
        page_table = page_table[:, :max(1, min(-(-int(window) // ps), page_table.shape[1]))]
    l_virt = page_table.shape[1] * ps
    active = positions >= 0
    pos = positions.clamp_min(0)
    if active_idx is None:
        active_idx = torch.nonzero(active).flatten()
    pos_a = pos[active_idx].long()
    wpages = page_table[active_idx, pos_a // ps].long()
    woffs = pos_a % ps
    x = params["embed/weight"][tokens]
    cos, sin = rope_cos_sin(pos, p.head_dim, p.rope_theta)
    cos_q, sin_q = cos[:, None, :], sin[:, None, :]
    read_mask = torch.arange(l_virt, device=dev)[None, :] <= pos[:, None]  # [S, l_virt]
    ks_pool, vs_pool = sharding.paged_scale_rows(cache, pl.n_kv_heads, kv_mesh)
    av = _attn_view(dataclasses.replace(cache, k_scale=ks_pool, v_scale=vs_pool), hs,
                    p.head_dim)

    for layer in range(p.n_layers):
        def attn_fn(q, k, v, layer=layer):
            q = apply_rope(q.reshape(s, pa.n_heads, p.head_dim), cos_q, sin_q)
            k = apply_rope(k.reshape(s, pl.n_kv_heads, p.head_dim), cos_q, sin_q)
            v = v.reshape(s, pl.n_kv_heads, p.head_dim)
            _write_pages(cache, layer, wpages, woffs, k[active_idx], v[active_idx], kv_mesh)
            if mode == "pallas":
                args = (true_div(q, math.sqrt(p.head_dim)), cache.k, cache.v, ks_pool, vs_pool,
                        page_table, positions, layer)
                if mesh is not None:
                    out = sharding.decode_attention_paged_sharded(*args, mesh, window=l_virt)
                else:
                    out = decode_attention_wide_paged(*args, window=l_virt)
            else:
                cols = page_table.long()
                out = _attend_window(
                    q[:, None], av.k[layer][cols].reshape(s, l_virt, -1),
                    av.v[layer][cols].reshape(s, l_virt, -1),
                    *_paged_window_scales(av, layer, cols, pa), read_mask[:, None], pa)
            return out.to(x.dtype).reshape(s, pa.n_heads * p.head_dim)

        x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)

    logits = torch.where(active[:, None], _logits(params, x, p), 0.0)
    if mesh is not None:
        logits = mesh.gather(logits, "dp", dim=0)
    return torch.where(all_active[:, None], logits, 0.0), cache


def verify_step_paged(params, p: LlamaParams, tokens: torch.Tensor, cache,
                      page_table: torch.Tensor, positions: torch.Tensor,
                      lengths: torch.Tensor, window: Optional[int] = None):
    """Speculative verification over a PagedKVCache: C candidate tokens per
    slot write into their slots' pages and attend through the gathered
    window in one step (the JAX package's verify_step_paged, which has no
    kernel: its attention is XLA einsums over the gathered window, here
    `_attend_window` batched over slots).

    tokens [S, C], positions [S] (-1 = inactive), lengths [S] as
    verify_step; page_table [S, P] int32; `window` limits reads to the
    leading window // ps pages. The engine ensures each slot's chain covers
    positions[s] + lengths[s] tokens. Only the valid rows are written,
    through `_write_pages` (finding them syncs with the host, which the
    host-drafted paged path does anyway); rejected drafts leave entries past
    the live position, masked by position. Returns (logits [S, C, V] f32,
    0 on invalid rows; cache). One rank or a live tp/dp mesh runs the same
    body (`_verify_rank`)."""
    return _verify_rank(params, p, tokens, cache, positions, lengths, window, _mesh(),
                        page_table=page_table)


# ---------------------------------------------------------------------- whole sequence
@register_architecture("llama")
@register_architecture("mixtral")  # MoE Llama: set model_params.n_experts
class Llama(Architecture):
    """Model-zoo wrapper: whole-sequence forward, logits for given
    input_ids, as the JAX package's computes them. Generation runs through
    the serving engine, not this path. `config` is a ModelConfig (the
    registry's call) or its model_params dict."""

    def __init__(self, config, device="cuda"):
        self.config = config if isinstance(config, ModelConfig) else None
        self.params_cfg = dict(config.model_params if self.config else config)
        self.device = resolve_device(device)

    def _p(self) -> LlamaParams:
        return LlamaParams.from_dict(self.params_cfg)

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device))
        return init_params(self._p(), device=self.device, seed=seed)

    def apply(self, params: Dict, inputs: Dict) -> Dict[str, torch.Tensor]:
        """inputs["input_ids"] [B, L] -> {"logits": [B, L, V] f32}, causal
        attention over the whole sequence."""
        p = self._p()
        tokens = torch.as_tensor(inputs["input_ids"]).to(device=self.device, dtype=torch.long)
        b, l = tokens.shape
        x = params["embed/weight"][tokens]
        positions = torch.arange(l, device=self.device)[None, :]
        cos, sin = rope_cos_sin(positions, p.head_dim, p.rope_theta)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
        mask = positions[:, :, None] >= positions[:, None, :]

        def attn_fn(q, k, v):
            q = apply_rope(q.reshape(b, l, p.n_heads, p.head_dim), cos, sin)
            k = apply_rope(k.reshape(b, l, p.n_kv_heads, p.head_dim), cos, sin)
            v = v.reshape(b, l, p.n_kv_heads, p.head_dim)
            return _attention_prefill(q, k, v, mask).reshape(b, l, -1)

        for layer in range(p.n_layers):
            x = _forward_block(params, f"layers.{layer}", x, p, attn_fn)
        return {"logits": _logits(params, x, p)}

    def quant_predicate(self, name: str, arr) -> bool:
        # 2-D projections and stacked 3-D MoE expert weights; routers stay
        # unquantized (routing is precision-sensitive)
        if "router" in name:
            return False
        return getattr(arr, "ndim", 0) in (2, 3) and name.endswith("kernel")
