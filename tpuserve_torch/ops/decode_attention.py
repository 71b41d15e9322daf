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
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuserve_torch.quant.core import true_div

launches = 0  # CUDA kernel launches (the plain version does not count)

_NEG_INF = -1e30
_HD = 128          # head_dim the CUDA kernel is written for
_KERNEL_NQ = (1, 2, 4, 8)
_BLOCK_L = 128     # L rows per online-softmax block (the TPU kernel's default)


def _quantize_q(q: torch.Tensor):
    """Per-(slot, head) symmetric int8: [S, H, hd] -> int8 + scale [S, H, 1]."""
    qf = q.to(torch.float32)
    absmax = qf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(true_div(absmax, 127.0), 1e-10)
    qi = torch.clamp(torch.round(qf / scale), -127, 127).to(torch.int8)
    return qi, scale


def _geometry(q, k_full, k_scale_l, window, block_l):
    """Shapes and the L blocking, chosen as the JAX entry point chooses them."""
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
    if win == l_max and kv_bits == 8:
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
    g = _geometry(q, k_full, k_scale_l, window, block_l)
    s_dim, m_dim, hd, n_kv, rep = g["s_dim"], g["n_heads"], g["hd"], g["n_kv"], g["rep"]
    bl, win = g["block_l"], g["win"]
    dev = q.device
    pos = positions.to(device=dev, dtype=torch.int64)
    kv_int8 = g["kv_int8"]
    if kv_int8:
        qc, qs = _quantize_q(q)                  # [S, M, hd] int8, [S, M, 1]
        qd = qc.to(torch.float64)                # integer dots are exact in f64
        qsum = qd.sum(dim=-1, keepdim=True)      # [S, M, 1]
        ks = k_scale_l[:, :, :win].to(torch.float32).repeat_interleave(rep, dim=1)
        vs = v_scale_l[:, :, :win].to(torch.float32).repeat_interleave(rep, dim=1)
    else:
        cdt = torch.float32 if k_full.dtype == torch.float32 else torch.bfloat16
        qd = q.to(cdt).to(torch.float32)
    kv_head = torch.arange(m_dim, device=dev) // rep  # query head -> kv head

    def heads(block):  # [S, bl, Wst] -> [S, Hkv, bl, hd] (codes or values)
        if g["kv_bits"] == 4:
            p32 = block.to(torch.int32)
            block = torch.cat([p32 & 15, p32 >> 4], dim=-1)  # biased nibbles
        return block.reshape(s_dim, bl, n_kv, hd).permute(0, 2, 1, 3)

    m_run = torch.full((s_dim, m_dim, 1), _NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((s_dim, m_dim, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((s_dim, m_dim, hd), dtype=torch.float32, device=dev)
    for j in range(win // bl):
        l0 = j * bl
        run = (l0 <= pos).view(s_dim, 1, 1)      # blocks past pos are skipped
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
        s = s + torch.where(lpos <= pos.view(s_dim, 1, 1), 0.0, _NEG_INF)
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
    from tpuserve_torch import kernels

    g = _geometry(q, k_full, k_scale_l, window, block_l)
    hd, n_kv, rep = g["hd"], g["n_kv"], g["rep"]
    if hd != _HD:
        raise ValueError(f"decode attention kernel: head_dim must be {_HD}, got {hd}")
    if g["kv_bits"] == 4:
        kind, nq = 1, 2 * rep
        if n_kv % 2:
            raise ValueError("decode attention kernel: packed int4 needs an even n_kv_heads")
    elif k_full.dtype == torch.int8:
        kind, nq = 0, rep
    elif k_full.dtype == torch.bfloat16:
        kind, nq = 2, rep
    elif k_full.dtype == torch.float32:
        kind, nq = 3, rep
    else:
        raise ValueError(f"decode attention kernel: unsupported cache dtype {k_full.dtype}")
    if nq not in _KERNEL_NQ:
        raise ValueError(f"decode attention kernel: {nq} query heads per block unsupported")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode attention kernel: unsupported q dtype {q.dtype}")
    tensors = [q, k_full, v_full, positions] + ([k_scale_l, v_scale_l] if g["quantized"] else [])
    for t in tensors:
        if t.device != q.device:
            raise ValueError("decode attention kernel: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("decode attention kernel: inputs must be contiguous")
    if k_full.shape != v_full.shape or k_full.dtype != v_full.dtype:
        raise ValueError("decode attention kernel: k and v caches differ")
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
    smem = nq * g["block_l"] * 5
    if smem > 160 * 1024:
        raise ValueError(f"decode attention kernel: block of {g['block_l']} rows too large")
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
    launches += 1
    return out
