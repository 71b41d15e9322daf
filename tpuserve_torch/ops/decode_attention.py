"""Single-token GQA decode attention over the flat multi-layer KV cache
(PyTorch port of tpuserve/ops/decode_attention.py::decode_attention_wide_cache).

The cache is read in place: k/v [n_layers, S, L, W] (W = Hkv*hd; int8,
bf16 or f32) or packed int4 uint8 [n_layers, S, L, W/2] (global split-half:
byte d holds W-position d in its low nibble and W/2 + d in its high
nibble), at a layer offset. Scales are this layer's [S, Hkv, L] (bf16 or
f32, head-major). For tensors on the card the wrapper launches the CUDA
kernel in csrc/decode_attention.cu; for tensors on the CPU it runs the
plain version below, which follows the kernel's (and the TPU kernel's)
algorithm step by step:

- q quantized to int8 per (slot, head) (`_quantize_q`); int32 score dots,
  then  s * q_scale * k_scale ; int4 adds the  -8*sum(q)  fold;
- positions past positions[s] masked with -1e30; online softmax over
  block_l blocks with  m_safe = max(m, -5e29) ; blocks wholly past
  positions[s] are skipped (inactive slots, positions = -1, give zeros);
- v_scale folded into P, P requantized to int8 per row and block
  (pscale = max(pmax/127, 1e-20)), int32 P@V;
- bf16/f32 caches: plain f32 dots, P rounded to bf16 for a bf16 cache.

When the window is small enough that the TPU packs several slots into one
block (`_packed_kernel`: win == L, int8 or float cache, win*W*sb < 1 MiB),
the whole window is one L block: a plain softmax with one P requant per row.

`decode_attention_wide_paged` (the JAX package's entry point of the same
name, `_wide_kernel` with `paged_sc`) runs the same algorithm over a paged
pool [n_layers, n_pages, ps, W] read in place through a page table, with
f32 scale pools [n_layers, n_pages, pad8(Hkv), ps]. Its online-softmax
block is always one page (block_l = ps), so P is requantized once per page.

`decode_attention_wide_cache_multi` (the JAX package's entry point of the
same name, `_wide_multi_kernel`) is speculative verification: C candidate
queries per slot over one read of the flat cache, candidate c attending to
rows <= positions[s] + c. It never takes the multi-slot packed form, and
blocks run while they hold a row <= positions[s] + C - 1. Its kernel is
csrc/decode_attention_multi.cu.

`decode_attention_wide` (the JAX package's entry of the same name,
`_wide_kernel` with a prebuilt Q_wide) is the flat kernel's function over
a contiguous [S, L, Hkv, hd] cache: a one-layer view, never packed.

TPUSERVE_INT4_UNPACK (read per call, as the JAX package's `_unpack_nibbles`
reads it when it traces): "noop" makes the flat, paged and multi-candidate
entries, kernels and plain versions, feed the raw packed bytes as signed
int8 to both nibble halves of K and V, keeping the -8*sum(q) and -8 folds.
Numerically wrong on purpose: timed against the default ("cur") it gives
the nibble unpack's share of the kernel's time in place.

`decode_attention` (the JAX package's entry of the same name, the grouped
`_kernel` behind TPUSERVE_DECODE_ATTN=grouped) takes k/v [S, L, Hkv, hd]
and [S, L, Hkv] scales and computes other numerics: no P requant, P times
v_scale rounded to bf16, P@V on V's values. Its kernel is
csrc/decode_attention_grouped.cu.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from tpuserve_torch.quant.core import true_div

launches = 0          # flat-cache kernel launches (the plain versions do not count)
paged_launches = 0    # paged-pool kernel launches
multi_launches = 0    # multi-candidate (speculative verify) kernel launches
wide_launches = 0     # flat-kernel launches through decode_attention_wide
grouped_launches = 0  # grouped kernel launches

_NEG_INF = -1e30
_HD = 128          # head_dim the CUDA kernel is written for
_KERNEL_NQ = (1, 2, 4, 8)
_BLOCK_L = 128     # L rows per online-softmax block (the TPU kernel's default)
_GROUPED_MAX_BL = 2048   # the grouped kernel's scores [nq, block_l] f32 in shared memory
_UNPACK_ENV = "TPUSERVE_INT4_UNPACK"


def int4_unpack_noop() -> bool:
    """Whether TPUSERVE_INT4_UNPACK is "noop" (anything else, and unset,
    is the JAX package's default "cur": unpack the nibbles)."""
    return os.environ.get(_UNPACK_ENV, "cur") == "noop"


def _quantize_q(q: torch.Tensor):
    """Per-(slot, head) symmetric int8: [S, H, hd] -> int8 + scale [S, H, 1]."""
    qf = q.to(torch.float32)
    absmax = qf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(true_div(absmax, 127.0), 1e-10)
    qi = torch.clamp(torch.round(qf / scale), -127, 127).to(torch.int8)
    return qi, scale


def _geometry(q, k_full, k_scale_l, window, block_l, pack: bool = True):
    """Shapes and the L blocking, chosen as the JAX entry point chooses them
    (`pack=False`: never the multi-slot whole-row form, as the paged path)."""
    s_dim, n_heads, hd = q.shape
    if k_full.dim() != 4:
        raise ValueError("decode attention expects the flat [n_layers, S, L, W] cache")
    kv_bits = 4 if k_full.dtype == torch.uint8 else 8
    n_layers, _, l_max, w_store = k_full.shape
    w = w_store * (2 if kv_bits == 4 else 1)
    n_kv = w // hd
    quantized = k_scale_l is not None
    kv_int8 = quantized and k_full.dtype in (torch.int8, torch.uint8)
    if kv_bits == 4:
        if not quantized:
            raise ValueError("packed int4 KV requires scales")
        if (w // 2) % 128 != 0:
            raise ValueError(
                f"packed int4 KV needs (n_kv_heads*head_dim)/2 % 128 == 0, got W={w}")
    if quantized and not kv_int8:
        raise ValueError("scales are only supported with an int8 or packed int4 cache")
    win = l_max if window is None else min(int(window), l_max)
    block_l = min(block_l or _BLOCK_L, win)
    while win % block_l != 0:
        block_l //= 2
    # the TPU's multi-slot packing (sb > 1) is one L block over the window
    sb = 1
    if pack and win == l_max and kv_bits == 8:
        while (sb * 2) <= s_dim and s_dim % (sb * 2) == 0 and win * w * sb < (1 << 20):
            sb *= 2
    if sb > 1:
        block_l = win
    return dict(s_dim=s_dim, n_heads=n_heads, hd=hd, kv_bits=kv_bits, n_layers=n_layers,
                l_max=l_max, w=w, n_kv=n_kv, rep=n_heads // n_kv, quantized=quantized,
                kv_int8=kv_int8, win=win, block_l=block_l)


def decode_attention_wide_cache_plain(q, k_full, v_full, k_scale_l, v_scale_l, positions,
                                      layer: int, *, window: Optional[int] = None,
                                      block_l: Optional[int] = None) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch (any device). Returns
    [S, H, hd] f32."""
    return _attend_plain(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer,
                         _geometry(q, k_full, k_scale_l, window, block_l))


def _attend_plain(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer, g,
                  cands: int = 1):
    """q [S, C*H, hd] rows candidate-major (C = `cands`): row c*H + h is
    candidate c's head h and sees cache rows <= positions[s] + c."""
    s_dim, n_heads, hd, n_kv, rep = g["s_dim"], g["n_heads"], g["hd"], g["n_kv"], g["rep"]
    m_dim = cands * n_heads
    bl, win = g["block_l"], g["win"]
    dev = q.device
    pos = positions.to(device=dev, dtype=torch.int64)
    kv_int8 = g["kv_int8"]
    if kv_int8:
        qc, qs = _quantize_q(q)                  # [S, M, hd] int8, [S, M, 1]
        qd = qc.to(torch.float64)                # integer dots are exact in f64
        qsum = qd.sum(dim=-1, keepdim=True)      # [S, M, 1]
        ks, vs = (sc[:, :, :win].to(torch.float32).repeat_interleave(rep, dim=1)
                  .repeat(1, cands, 1) for sc in (k_scale_l, v_scale_l))
    else:
        cdt = torch.float32 if k_full.dtype == torch.float32 else torch.bfloat16
        qd = q.to(cdt).to(torch.float32)
    rows = torch.arange(m_dim, device=dev)
    kv_head = (rows % n_heads) // rep            # query row -> kv head
    horizon = (pos.view(s_dim, 1) + (rows // n_heads).view(1, m_dim)).view(s_dim, m_dim, 1)
    noop = g["kv_bits"] == 4 and int4_unpack_noop()

    def heads(block):  # [S, bl, Wst] -> [S, Hkv, bl, hd] (codes or values)
        if noop:   # the raw bytes, signed, for both halves
            b = block.view(torch.int8)
            block = torch.cat([b, b], dim=-1)
        elif g["kv_bits"] == 4:
            p32 = block.to(torch.int32)
            block = torch.cat([p32 & 15, p32 >> 4], dim=-1)  # biased nibbles
        return block.reshape(s_dim, bl, n_kv, hd).permute(0, 2, 1, 3)

    m_run = torch.full((s_dim, m_dim, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((s_dim, m_dim, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((s_dim, m_dim, hd), dtype=torch.float32, device=dev)
    for j in range(win // bl):
        l0 = j * bl
        run = (l0 <= pos + cands - 1).view(s_dim, 1, 1)  # blocks past the last row skipped
        kb = heads(k_full[layer, :, l0:l0 + bl])[:, kv_head]   # [S, M, bl, hd]
        vb = heads(v_full[layer, :, l0:l0 + bl])[:, kv_head]
        if kv_int8:
            dots = torch.einsum("smd,smld->sml", qd, kb.to(torch.float64))
            if g["kv_bits"] == 4:
                dots = dots - 8.0 * qsum
            s = dots.to(torch.float32) * qs * ks[:, :, l0:l0 + bl]
        else:
            s = torch.einsum("smd,smld->sml", qd, kb.to(torch.float32))
        lpos = torch.arange(l0, l0 + bl, device=dev).view(1, 1, bl)
        s = s + torch.where(lpos <= horizon, 0.0, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        m_safe = torch.clamp_min(m_new, _NEG_INF / 2)
        p = torch.exp(s - m_safe)
        corr = torch.exp(m_run - m_safe)
        l_new = l_run * corr + p.sum(dim=-1, keepdim=True)
        if kv_int8:
            p = p * vs[:, :, l0:l0 + bl]
            pmax = p.abs().amax(dim=-1, keepdim=True)
            pscale = torch.clamp_min(true_div(pmax, 127.0), 1e-20)
            pq = torch.clamp(torch.round(p / pscale), -127, 127)
            vals = vb.to(torch.float64) - (8.0 if g["kv_bits"] == 4 else 0.0)
            part = torch.einsum("sml,smld->smd", pq.to(torch.float64), vals)
            part = part.to(torch.float32) * pscale
        else:
            if k_full.dtype != torch.float32:
                p = p.to(torch.bfloat16).to(torch.float32)
            part = torch.einsum("sml,smld->smd", p, vb.to(torch.float32))
        acc = torch.where(run, acc * corr + part, acc)
        l_run = torch.where(run, l_new, l_run)
        m_run = torch.where(run, m_new, m_run)
    return torch.where(l_run > 0, acc / torch.clamp_min(l_run, 1e-20), 0.0)


def _kernel_kind(k_dtype, kv_bits: int, n_kv: int, rep: int, hd: int):
    """The kernel's (kind, query heads per block) for a cache dtype; raises
    on what the CUDA kernel does not take. Packed int4 is kind 1, or 4
    under TPUSERVE_INT4_UNPACK=noop."""
    if hd != _HD:
        raise ValueError(f"decode attention kernel: head_dim must be {_HD}, got {hd}")
    if kv_bits == 4:
        kind, nq = (4 if int4_unpack_noop() else 1), 2 * rep
        if n_kv % 2:
            raise ValueError("decode attention kernel: packed int4 needs an even n_kv_heads")
    elif k_dtype == torch.int8:
        kind, nq = 0, rep
    elif k_dtype == torch.bfloat16:
        kind, nq = 2, rep
    elif k_dtype == torch.float32:
        kind, nq = 3, rep
    else:
        raise ValueError(f"decode attention kernel: unsupported cache dtype {k_dtype}")
    if nq not in _KERNEL_NQ:
        raise ValueError(f"decode attention kernel: {nq} query heads per block unsupported")
    return kind, nq


def _check_inputs(q, tensors, k, v, block_rows, nq):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode attention kernel: unsupported q dtype {q.dtype}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("decode attention kernel: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("decode attention kernel: inputs must be contiguous")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("decode attention kernel: k and v caches differ")
    if nq * block_rows * 5 > 160 * 1024:
        raise ValueError(f"decode attention kernel: block of {block_rows} rows too large")


def decode_attention_wide_cache(q, k_full, v_full, k_scale_l, v_scale_l, positions,
                                layer: int, *, window: Optional[int] = None,
                                block_l: Optional[int] = None) -> torch.Tensor:
    """Decode attention over the flat cache, in place at `layer`.

    q [S, H, hd] (f32 or bf16), already scaled by 1/sqrt(hd); k_full/v_full
    [n_layers, S, L, Wst]; k_scale_l/v_scale_l [S, Hkv, L] or None;
    positions [S] int (-1 = inactive); `window` (<= L) bounds the read and
    callers guarantee max(positions)+1 <= window. Returns [S, H, hd] f32.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global launches
    if not q.is_cuda:
        return decode_attention_wide_cache_plain(q, k_full, v_full, k_scale_l, v_scale_l,
                                                 positions, layer, window=window,
                                                 block_l=block_l)
    out = _launch_flat(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer,
                       _geometry(q, k_full, k_scale_l, window, block_l))
    launches += 1
    return out


def _launch_flat(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer, g):
    """Check the inputs and launch the flat kernel over the geometry `g`."""
    from tpuserve_torch import kernels

    n_kv = g["n_kv"]
    kind, nq = _kernel_kind(k_full.dtype, g["kv_bits"], n_kv, g["rep"], g["hd"])
    _check_inputs(q, [q, k_full, v_full, positions]
                  + ([k_scale_l, v_scale_l] if g["quantized"] else []),
                  k_full, v_full, g["block_l"], nq)
    if not 0 <= int(layer) < g["n_layers"]:
        raise ValueError(f"layer {layer} out of range")
    sc_bf16 = 0
    if g["quantized"]:
        want = (g["s_dim"], n_kv, g["l_max"])
        if tuple(k_scale_l.shape) != want or tuple(v_scale_l.shape) != want:
            raise ValueError(f"decode attention kernel: scales must be {want}")
        if k_scale_l.dtype != v_scale_l.dtype or k_scale_l.dtype not in (torch.float32,
                                                                          torch.bfloat16):
            raise ValueError("decode attention kernel: scales must be f32 or bf16")
        sc_bf16 = int(k_scale_l.dtype == torch.bfloat16)
    pos32 = positions if positions.dtype == torch.int32 else positions.to(torch.int32)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    null = 0
    rc = kernels.lib().tpuserve_decode_attention(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
        k_scale_l.data_ptr() if g["quantized"] else null,
        v_scale_l.data_ptr() if g["quantized"] else null,
        pos32.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), sc_bf16,
        g["s_dim"], g["n_heads"], n_kv, g["l_max"], int(layer), g["win"], g["block_l"],
        k_full.shape[-1], kind, nq, kernels.stream_of(q))
    kernels.check(rc, "decode_attention")
    return out


# ---------------------------------------------------------------- prebuilt Q_wide
def _wide_flat(q, k, v, k_scale, v_scale, block_l):
    """The prebuilt-Q_wide entry's operands as the flat kernel's: k/v [S, L,
    Hkv, hd] viewed as one layer [1, S, L, Hkv*hd] (no copy), and its
    geometry without the multi-slot packed form."""
    if k.dim() != 4:
        raise ValueError("decode_attention_wide expects k/v [S, L, Hkv, hd]")
    s_dim, l_max, n_kv, hd = k.shape
    kf = k.reshape(1, s_dim, l_max, n_kv * hd)
    vf = v.reshape(1, s_dim, l_max, n_kv * hd)
    return kf, vf, _geometry(q, kf, k_scale, None, block_l, pack=False)


def decode_attention_wide_plain(q, k, v, k_scale, v_scale, positions, *,
                                block_l: int = 256) -> torch.Tensor:
    """decode_attention_wide's algorithm in plain PyTorch (any device): the
    flat kernel's plain version over the one-layer view. [S, H, hd] f32."""
    kf, vf, g = _wide_flat(q, k, v, k_scale, v_scale, block_l)
    return _attend_plain(q, kf, vf, k_scale, v_scale, positions, 0, g)


def decode_attention_wide(q, k, v, k_scale, v_scale, positions, *,
                          block_l: int = 256) -> torch.Tensor:
    """The JAX package's decode_attention_wide (`_wide_kernel` with a
    prebuilt Q_wide), the flat kernel's function over a contiguous cache:
    q [S, H, hd] (f32 or bf16, scaled by 1/sqrt(hd)); k/v [S, L, Hkv, hd]
    int8, bf16 or f32; k_scale/v_scale [S, Hkv, L] (f32 or bf16) or None;
    positions [S] (-1 = inactive). L is read in blocks of `block_l`
    (clipped to L, halved until it divides L), never in the multi-slot
    packed form, which this entry never takes. Returns [S, H, hd] f32.
    CUDA tensors launch the flat kernel (csrc/decode_attention.cu) on a
    one-layer view; CPU tensors take the plain version."""
    global wide_launches
    if not q.is_cuda:
        return decode_attention_wide_plain(q, k, v, k_scale, v_scale, positions,
                                           block_l=block_l)
    kf, vf, g = _wide_flat(q, k, v, k_scale, v_scale, block_l)
    out = _launch_flat(q, kf, vf, k_scale, v_scale, positions, 0, g)
    wide_launches += 1
    return out


# ---------------------------------------------------------------- grouped
_GKV_ENV = "TPUSERVE_ATTN_GKV"


def _grouped_geometry(q, k, v, k_scale, v_scale, block_l: int, g_kv: Optional[int]):
    """Shapes, the kv heads per block and the L blocking of the grouped
    entry, chosen as the JAX package's decode_attention chooses them, but
    for the default split (see decode_attention)."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("grouped decode attention expects q [S, H, hd] and k/v [S, L, Hkv, hd]")
    s_dim, n_heads, hd = q.shape
    _, l_max, n_kv, hd_k = k.shape
    if k.shape != v.shape or k.dtype != v.dtype or k.shape[0] != s_dim or hd_k != hd:
        raise ValueError(f"grouped decode attention: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"{k.dtype}, v {tuple(v.shape)} {v.dtype} do not fit")
    if n_heads % n_kv:
        raise ValueError(f"grouped decode attention: {n_heads} heads over {n_kv} kv heads")
    if k.dtype not in (torch.int8, torch.bfloat16, torch.float32):
        raise ValueError(f"grouped decode attention: unsupported cache dtype {k.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("grouped decode attention: give both scales or neither")
    if k.dtype == torch.int8 and not quantized:
        raise ValueError("grouped decode attention: an int8 cache needs scales")
    if quantized and (tuple(k_scale.shape) != (s_dim, l_max, n_kv)
                      or tuple(v_scale.shape) != (s_dim, l_max, n_kv)):
        raise ValueError(f"grouped decode attention: scales must be {(s_dim, l_max, n_kv)}")
    if g_kv is None:
        g_kv = int(os.environ.get(_GKV_ENV, "0")) or 1
    g_kv = max(1, min(int(g_kv), n_kv))
    while n_kv % g_kv:
        g_kv -= 1
    bl = max(1, min(int(block_l), l_max))
    while l_max % bl:
        bl //= 2
    return dict(s_dim=s_dim, n_heads=n_heads, hd=hd, l_max=l_max, n_kv=n_kv,
                rep=n_heads // n_kv, quantized=quantized, kv_int8=k.dtype == torch.int8,
                g_kv=g_kv, block_l=bl)


def decode_attention_plain(q, k, v, k_scale, v_scale, positions, *, block_l: int = 256,
                           g_kv: Optional[int] = None) -> torch.Tensor:
    """The grouped kernel's algorithm in plain PyTorch (any device), step
    for step as the TPU's `_kernel`: int8 q per (slot, head) and integer
    score dots for an int8 cache (q's own values for a float cache), then
    s * k_scale * q_scale; positions past positions[s] masked with -1e30;
    online softmax over `block_l` blocks (m_safe = max(m, -5e29)), blocks
    wholly past positions[s] skipped; P * v_scale rounded to bf16 (unless
    the cache is f32) and P@V on V's values with f32 accumulation, no P
    requant; out = acc / max(l, 1e-20) where l > 0, else 0. `g_kv` only
    splits the work (the TPU's masked head pairs add exact zeros), so it
    changes no value. Returns [S, H, hd] f32."""
    g = _grouped_geometry(q, k, v, k_scale, v_scale, block_l, g_kv)
    s_dim, n_heads, hd, l_max, bl = g["s_dim"], g["n_heads"], g["hd"], g["l_max"], g["block_l"]
    dev = q.device
    pos = positions.to(device=dev, dtype=torch.int64).view(s_dim, 1, 1)
    kv_head = torch.arange(n_heads, device=dev) // g["rep"]   # query head -> kv head
    if g["kv_int8"]:
        qc, qs = _quantize_q(q)                    # [S, H, hd] int8, [S, H, 1]
        qd = qc.to(torch.float64)                  # integer dots are exact in f64
    else:
        qd = q.to(torch.float32)

    def heads(x, l0):   # [S, L, Hkv, ...] block -> [S, H, bl, ...] per query head
        return x[:, l0:l0 + bl][:, :, kv_head].transpose(1, 2)

    m_run = torch.full((s_dim, n_heads, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((s_dim, n_heads, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((s_dim, n_heads, hd), dtype=torch.float32, device=dev)
    for l0 in range(0, l_max, bl):
        run = l0 <= pos
        kb, vb = heads(k, l0), heads(v, l0)        # [S, H, bl, hd]
        if g["kv_int8"]:
            s = torch.einsum("shd,shld->shl", qd, kb.to(torch.float64)).to(torch.float32)
            s = s * heads(k_scale, l0).to(torch.float32) * qs
        else:
            s = torch.einsum("shd,shld->shl", qd, kb.to(torch.float32))
            if g["quantized"]:
                s = s * heads(k_scale, l0).to(torch.float32)
        lpos = torch.arange(l0, l0 + bl, device=dev).view(1, 1, bl)
        s = s + torch.where(lpos <= pos, 0.0, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        m_safe = torch.clamp_min(m_new, _NEG_INF / 2)
        p = torch.exp(s - m_safe)
        corr = torch.exp(m_run - m_safe)
        l_new = l_run * corr + p.sum(dim=-1, keepdim=True)
        if g["quantized"]:
            p = p * heads(v_scale, l0).to(torch.float32)
        if k.dtype != torch.float32:
            p = p.to(torch.bfloat16).to(torch.float32)
        part = torch.einsum("shl,shld->shd", p, vb.to(torch.float32))
        acc = torch.where(run, acc * corr + part, acc)
        l_run = torch.where(run, l_new, l_run)
        m_run = torch.where(run, m_new, m_run)
    return torch.where(l_run > 0, acc / torch.clamp_min(l_run, 1e-20), 0.0)


def decode_attention(q, k, v, k_scale, v_scale, positions, *, block_l: int = 256,
                     g_kv: Optional[int] = None) -> torch.Tensor:
    """Grouped decode attention (the JAX package's decode_attention, the
    `_kernel` behind TPUSERVE_DECODE_ATTN=grouped).

    q [S, H, hd] (f32 or bf16), already scaled by 1/sqrt(hd); k/v [S, L,
    Hkv, hd] int8, bf16 or f32, the last three dims contiguous (a window
    view of a longer cache is taken in place: slots may be any 16-byte
    multiple apart); k_scale/v_scale [S, L, Hkv] f32 or bf16, any strides
    (a transposed view of the head-major scale cache), or None for a float
    cache; positions [S] int (-1 = inactive); `block_l` the online-softmax
    block; `g_kv` the kv heads one block serves (or TPUSERVE_ATTN_GKV; the
    port's default is 1, where the JAX package's is 16 // rep). Returns
    [S, H, hd] f32. CUDA tensors launch csrc/decode_attention_grouped.cu;
    CPU tensors take the plain version."""
    global grouped_launches
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, k_scale, v_scale, positions, block_l=block_l,
                                      g_kv=g_kv)
    from tpuserve_torch import kernels

    g = _grouped_geometry(q, k, v, k_scale, v_scale, block_l, g_kv)
    s_dim, n_heads, n_kv = g["s_dim"], g["n_heads"], g["n_kv"]
    kind, nq = _kernel_kind(k.dtype, 8, n_kv, g["rep"], g["hd"])
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError("grouped decode attention kernel: q must be contiguous f32 or bf16")
    quantized = g["quantized"]
    tensors = [q, k, v, positions] + ([k_scale, v_scale] if quantized else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("grouped decode attention kernel: all inputs must be on one device")
    esz = k.element_size()
    if (k.stride()[1:] != (n_kv * _HD, _HD, 1) or v.stride() != k.stride()
            or (k.stride(0) * esz) % 16 or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("grouped decode attention kernel: k/v must be [S, L, Hkv, hd] views "
                         "with contiguous rows, 16-byte aligned slots and equal strides")
    sc_bf16, ss = 0, (0, 0, 0)
    if quantized:
        if k_scale.dtype != v_scale.dtype or k_scale.dtype not in (torch.float32,
                                                                    torch.bfloat16):
            raise ValueError("grouped decode attention kernel: scales must be f32 or bf16")
        if k_scale.stride() != v_scale.stride():
            raise ValueError("grouped decode attention kernel: k and v scales differ in strides")
        sc_bf16, ss = int(k_scale.dtype == torch.bfloat16), k_scale.stride()
    if g["block_l"] > _GROUPED_MAX_BL:
        raise ValueError(f"grouped decode attention kernel: block_l {g['block_l']} > "
                         f"{_GROUPED_MAX_BL}")
    if positions.shape != (s_dim,):
        raise ValueError("grouped decode attention: positions must be [S]")
    pos32 = positions.to(torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    null = 0
    rc = kernels.lib().tpuserve_decode_attention_grouped(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else null, v_scale.data_ptr() if quantized else null,
        pos32.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), sc_bf16,
        s_dim, n_heads, n_kv, g["l_max"], g["block_l"], g["g_kv"], k.stride(0), *ss,
        kind, nq, kernels.stream_of(q))
    kernels.check(rc, "decode_attention_grouped")
    grouped_launches += 1
    return out


# ---------------------------------------------------------------- candidates
_MULTI_MAX_C = 16          # candidates per slot the multi kernel takes
_MULTI_GROUP = 16          # query rows the kernel accumulates P@V for at once
_SMEM_LIMIT = 227 * 1024   # shared memory one block may use on the H100


def multi_smem_bytes(rows: int, block_l: int) -> int:
    """Dynamic shared memory of the multi kernel for `rows` = C * (query
    heads per block): q [rows, hd] f32, the P@V cross-warp reduction
    [4 warps, group, hd] and the accumulators [rows, hd] f32, scores/P
    [rows, bl] f32, the block's V scales [2, bl] f32, P codes [rows, bl]
    int8. csrc/decode_attention_multi.cu lays it out so."""
    return rows * _HD * 4 + 4 * _MULTI_GROUP * _HD * 4 + rows * _HD * 4 \
        + rows * block_l * 4 + 2 * block_l * 4 + rows * block_l


def check_multi_kernel(cands: int, nq: int, block_l: int = _BLOCK_L) -> None:
    """Raise ValueError unless the multi kernel takes `cands` candidates of
    `nq` query heads per block over blocks of `block_l` rows."""
    if not 1 <= cands <= _MULTI_MAX_C:
        raise ValueError(f"multi decode attention kernel: {cands} candidates, "
                         f"takes 1..{_MULTI_MAX_C}")
    smem = multi_smem_bytes(cands * nq, block_l)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"multi decode attention kernel: {smem} bytes of shared memory for "
                         f"{cands} candidates x {nq} heads, block {block_l}")


def decode_attention_wide_cache_multi_plain(q, k_full, v_full, k_scale_l, v_scale_l, positions,
                                            layer: int, *, window: Optional[int] = None,
                                            block_l: Optional[int] = None) -> torch.Tensor:
    """The multi kernel's algorithm in plain PyTorch (any device): the flat
    algorithm over C*H candidate-major query rows, q quantized per (slot,
    candidate, head), row (s, c) masked past positions[s] + c. Returns
    [S, C, H, hd] f32."""
    s_dim, cands, n_heads, hd = q.shape
    g = _geometry(q[:, 0], k_full, k_scale_l, window, block_l, pack=False)
    out = _attend_plain(q.reshape(s_dim, cands * n_heads, hd), k_full, v_full, k_scale_l,
                        v_scale_l, positions, layer, g, cands=cands)
    return out.reshape(s_dim, cands, n_heads, hd)


def decode_attention_wide_cache_multi(q, k_full, v_full, k_scale_l, v_scale_l, positions,
                                      layer: int, *, window: Optional[int] = None,
                                      block_l: Optional[int] = None) -> torch.Tensor:
    """Speculative-verification attention over the flat cache, in place at
    `layer`: q [S, C, H, hd] (f32 or bf16; C candidates per slot, scaled by
    1/sqrt(hd) and RoPE'd at their own positions, their K/V already written
    at positions[s] .. positions[s] + C - 1); positions [S] = candidate 0's
    position (-1 = inactive); the rest as decode_attention_wide_cache.
    Callers guarantee max(positions) + C <= window. Returns [S, C, H, hd]
    f32; candidate 0 of an inactive slot is 0, its other candidates are
    garbage for the caller to mask. CUDA tensors launch the kernel (1 <= C
    <= 16); CPU tensors take the plain version."""
    global multi_launches
    if not q.is_cuda:
        return decode_attention_wide_cache_multi_plain(q, k_full, v_full, k_scale_l, v_scale_l,
                                                       positions, layer, window=window,
                                                       block_l=block_l)
    from tpuserve_torch import kernels

    if q.dim() != 4:
        raise ValueError("multi decode attention expects q [S, C, H, hd]")
    s_dim, cands, n_heads, hd = q.shape
    check_multi_kernel(cands, 1)   # C first: _geometry reads candidate 0
    g = _geometry(q[:, 0], k_full, k_scale_l, window, block_l, pack=False)
    n_kv = g["n_kv"]
    kind, nq = _kernel_kind(k_full.dtype, g["kv_bits"], n_kv, g["rep"], hd)
    _check_inputs(q, [q, k_full, v_full, positions]
                  + ([k_scale_l, v_scale_l] if g["quantized"] else []),
                  k_full, v_full, g["block_l"], nq)
    if k_full.data_ptr() % 16 or v_full.data_ptr() % 16:   # rows are read in 16-byte vectors
        raise ValueError("multi decode attention kernel: k and v caches must be 16-byte aligned")
    check_multi_kernel(cands, nq, g["block_l"])
    if not 0 <= int(layer) < g["n_layers"]:
        raise ValueError(f"layer {layer} out of range")
    if positions.shape != (s_dim,):
        raise ValueError("multi decode attention: positions must be [S]")
    sc_bf16 = 0
    if g["quantized"]:
        want = (s_dim, n_kv, g["l_max"])
        if tuple(k_scale_l.shape) != want or tuple(v_scale_l.shape) != want:
            raise ValueError(f"multi decode attention kernel: scales must be {want}")
        if k_scale_l.dtype != v_scale_l.dtype or k_scale_l.dtype not in (torch.float32,
                                                                          torch.bfloat16):
            raise ValueError("multi decode attention kernel: scales must be f32 or bf16")
        sc_bf16 = int(k_scale_l.dtype == torch.bfloat16)
    pos32 = positions if positions.dtype == torch.int32 else positions.to(torch.int32)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    null = 0
    rc = kernels.lib().tpuserve_decode_attention_multi(
        q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
        k_scale_l.data_ptr() if g["quantized"] else null,
        v_scale_l.data_ptr() if g["quantized"] else null,
        pos32.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), sc_bf16,
        s_dim, cands, n_heads, n_kv, g["l_max"], int(layer), g["win"], g["block_l"],
        k_full.shape[-1], kind, nq, kernels.stream_of(q))
    kernels.check(rc, "decode_attention_multi")
    multi_launches += 1
    return out


# ---------------------------------------------------------------- paged pools
def _paged_window(k_pool, page_table, window) -> Tuple[int, int]:
    """(page_size, window) of a paged call; the window is a whole number of
    pages and at most the table's width."""
    if k_pool.dim() != 4:
        raise ValueError("paged decode attention expects flat pools [n_layers, n_pages, ps, W]")
    if page_table.dim() != 2:
        raise ValueError("page_table must be [S, P]")
    ps = k_pool.shape[2]
    l_virt = page_table.shape[1] * ps
    win = l_virt if window is None else min(int(window), l_virt)
    if win <= 0 or win % ps:
        raise ValueError(f"paged decode attention: window {win} is not a multiple of "
                         f"page_size {ps}")
    return ps, win


def decode_attention_wide_paged_plain(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                                      page_table, positions, layer: int, *,
                                      window: Optional[int] = None) -> torch.Tensor:
    """The paged kernel's algorithm in plain PyTorch (any device): the
    slot's pages gathered into a [S, win, Wst] window, the scale pages into
    [S, Hkv, win], then the flat algorithm with one page per online-softmax
    block. Returns [S, H, hd] f32."""
    ps, win = _paged_window(k_pool, page_table, window)
    s_dim, _, hd = q.shape
    cols = page_table[:, :win // ps].to(device=q.device, dtype=torch.long)  # [S, win/ps]
    k = k_pool[layer][cols].reshape(1, s_dim, win, k_pool.shape[-1])
    v = v_pool[layer][cols].reshape(1, s_dim, win, v_pool.shape[-1])
    ks = vs = None
    if k_scale_pool is not None:
        n_kv = k_pool.shape[-1] * (2 if k_pool.dtype == torch.uint8 else 1) // hd

        def window_scales(pool):  # [S, win/ps, hp, ps] -> [S, Hkv, win]
            return pool[layer][cols].permute(0, 2, 1, 3).reshape(s_dim, -1, win)[:, :n_kv]

        ks, vs = window_scales(k_scale_pool), window_scales(v_scale_pool)
    g = _geometry(q, k, ks, win, ps, pack=False)
    return _attend_plain(q, k, v, ks, vs, positions, 0, g)


def decode_attention_wide_paged(q, k_pool, v_pool, k_scale_pool, v_scale_pool, page_table,
                                positions, layer: int, *,
                                window: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a paged pool, pages read in place through the
    page table (the JAX package's decode_attention_wide_paged with scale
    pools).

    q [S, H, hd] (f32 or bf16), already scaled by 1/sqrt(hd); k_pool/v_pool
    [n_layers, n_pages, ps, Wst]; k_scale_pool/v_scale_pool [n_layers,
    n_pages, pad8(Hkv), ps] f32 or None; page_table [S, P] int32 (pool page
    ids; its rows may be strided, as a column slice is); positions [S] int
    (-1 = inactive); `window` a multiple of ps. Returns [S, H, hd] f32.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global paged_launches
    if not q.is_cuda:
        return decode_attention_wide_paged_plain(q, k_pool, v_pool, k_scale_pool,
                                                 v_scale_pool, page_table, positions,
                                                 layer, window=window)
    from tpuserve_torch import kernels

    ps, win = _paged_window(k_pool, page_table, window)
    s_dim, n_heads, hd = q.shape
    n_layers, n_pages, _, w_store = k_pool.shape
    kv_bits = 4 if k_pool.dtype == torch.uint8 else 8
    w = w_store * (2 if kv_bits == 4 else 1)
    n_kv = w // hd
    if n_kv == 0 or n_heads % n_kv:
        raise ValueError(f"paged decode attention: {n_heads} heads over W={w}")
    kind, nq = _kernel_kind(k_pool.dtype, kv_bits, n_kv, n_heads // n_kv, hd)
    quantized = k_scale_pool is not None
    if quantized != (kind in (0, 1, 4)) or quantized != (v_scale_pool is not None):
        raise ValueError("paged decode attention: int8/int4 pools take scale pools, "
                         "float pools none")
    if kv_bits == 4 and (w // 2) % 128:
        raise ValueError(f"packed int4 KV needs (n_kv_heads*head_dim)/2 % 128 == 0, got W={w}")
    _check_inputs(q, [q, k_pool, v_pool, positions]
                  + ([k_scale_pool, v_scale_pool] if quantized else []), k_pool, v_pool, ps, nq)
    if (page_table.device != q.device or page_table.dtype != torch.int32
            or page_table.shape[0] != s_dim or page_table.stride(1) != 1):
        raise ValueError("paged decode attention: page_table must be int32 [S, P] on the "
                         "card with unit column stride")
    if positions.shape != (s_dim,) or positions.dtype != torch.int32:
        raise ValueError("paged decode attention: positions must be int32 [S]")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"layer {layer} out of range")
    hp = 0
    if quantized:
        hp = k_scale_pool.shape[2]
        want = (n_layers, n_pages, hp, ps)
        if (tuple(k_scale_pool.shape) != want or tuple(v_scale_pool.shape) != want
                or hp < n_kv):
            raise ValueError(f"paged decode attention: scale pools must be "
                             f"[n_layers, n_pages, >= {n_kv}, ps]")
        if k_scale_pool.dtype != torch.float32 or v_scale_pool.dtype != torch.float32:
            raise ValueError("paged decode attention: scale pools must be float32")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    null = 0
    rc = kernels.lib().tpuserve_decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale_pool.data_ptr() if quantized else null,
        v_scale_pool.data_ptr() if quantized else null,
        positions.data_ptr(), page_table.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), s_dim, n_heads, n_kv, n_pages, ps, hp, int(layer),
        win, page_table.stride(0), w_store, kind, nq, kernels.stream_of(q))
    kernels.check(rc, "decode_attention_paged")
    paged_launches += 1
    return out
