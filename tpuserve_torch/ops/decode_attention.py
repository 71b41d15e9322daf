"""Single-token GQA decode attention over the flat multi-layer KV cache
(PyTorch port of tpuserve/ops/decode_attention.py::decode_attention_wide_cache).

The cache is read in place: k/v [n_layers, S, L, W] (W = Hkv*hd; int8,
bf16 or f32) or packed int4 uint8 [n_layers, S, L, W/2] (global split-half:
byte d holds W-position d in its low nibble and W/2 + d in its high
nibble), at a layer offset. Scales are this layer's [S, Hkv, L] (bf16 or
f32, head-major). For tensors on the card the wrapper launches a CUDA
kernel: the Hopper core of csrc/decode_attention_hopper.cu, which serves
the flat, paged, prebuilt-Q_wide and multi-candidate entries for every
cache.
For tensors on the CPU it runs the plain version below, which follows the
kernel's (and the TPU kernel's) algorithm step by step:

- q quantized to int8 per (slot, head) (`_quantize_q`); int32 score dots,
  then  s * q_scale * k_scale ; int4 adds the  -8*sum(q)  fold;
- positions past positions[s] masked with -1e30; online softmax over
  block_l blocks with  m_safe = max(m, -5e29) ; blocks wholly past
  positions[s] are skipped (inactive slots, positions = -1, give zeros);
- v_scale folded into P, P requantized to int8 per row and block
  (pscale = max(pmax/127, 1e-20)), int32 P@V;
- bf16/f32 caches: plain f32 dots, P rounded to bf16 for a bf16 cache.

The core splits an int8 or int4 slot's window over blocks of the grid
where the grid is small (`split_plan`; never a float cache's): each run of
whole block_l blocks starts its own online softmax and the runs' (m, l,
acc) are merged in order. The requant points
do not move; the plain versions take the same plan, so only the order of
f32 sums (and a P code at a rounding tie) can differ from one online
softmax over the window.

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
blocks run while they hold a row <= positions[s] + C - 1.

`decode_attention_wide` (the JAX package's entry of the same name,
`_wide_kernel` with a prebuilt Q_wide) is the flat kernel's function over
a contiguous [S, L, Hkv, hd] cache: a one-layer view, never packed.

TPUSERVE_ATTN_BLOCK_L (read per call where block_l is None, as the JAX
package reads it when it traces) sets the flat and multi entries' block_l,
default 128, clipped to the window and halved until it divides it; the
paged entry keeps one page a block. TPUSERVE_ATTN_DYNSKIP (read per call;
default "1" for the flat and multi kernels, "0" for the grouped one): "1"
skips a slot's blocks past its position, anything else reads and masks
them, as the TPU kernels' index maps do. Outputs are the same either way.

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
csrc/decode_attention_grouped_hopper.cu for every window (int8, bf16, f32),
with the core's window split (`_grouped_plan`). `decode_attention_packed`,
the port's route for the decode step over a packed int4 cache, runs the
same Hopper kernel on the packed window and its head-major scales in
place; its plain version is unpack_kv_codes followed by
decode_attention_plain.
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
_BLOCK_L_ENV = "TPUSERVE_ATTN_BLOCK_L"   # L rows per online-softmax block, default 128
_DYNSKIP_ENV = "TPUSERVE_ATTN_DYNSKIP"
_READ_ALL = 16     # added to a kernel's launch code: read and mask past a slot (attention_common.cuh)
_UNPACK_ENV = "TPUSERVE_INT4_UNPACK"
# cache kinds of the launch codes (attention_common.cuh)
_KV_INT8, _KV_INT4, _KV_BF16, _KV_F32 = 0, 1, 2, 3
_CACHE_KINDS = {"int8": _KV_INT8, "int4": _KV_INT4, "bf16": _KV_BF16, "f32": _KV_F32}
# the Hopper kernels' ring (csrc/attention_hopper.cuh): tiles of 64 rows, a
# row of one kv unit + 16 bytes (int8/int4 144, bf16 272, f32 528), then 4
# staged scale rows of 68 words
_CORE_TR, _CORE_SC_W = 64, 68
_ROW_B = {_KV_BF16: 272, _KV_F32: 528}
_CORE_RG = 32          # query rows one block serves (a row group)
_CORE_SPLIT_FILL = 4   # blocks an SM should have before the window is split
_H100_SMS = 132        # the plan of a CPU call is the H100's
_CORE_COUNTERS = {}    # device index -> int32 counters a (slot, unit, row group), zero between calls
_CORE_MAX_COUNTERS = 1 << 16


def default_block_l() -> int:
    """The flat and multi entries' block_l when the caller gives none:
    TPUSERVE_ATTN_BLOCK_L, read per call as the JAX package reads it when it
    traces, else the TPU kernel's default 128."""
    return int(os.environ.get(_BLOCK_L_ENV, "128"))


def dynskip(grouped: bool = False) -> bool:
    """TPUSERVE_ATTN_DYNSKIP, read per call with the JAX package's defaults:
    on ("1") for the flat and multi kernels, off ("0") for the grouped one.
    On, a slot's blocks past its position are skipped; off, they are read
    and masked, which gives the same output (an A/B of the bytes read)."""
    return os.environ.get(_DYNSKIP_ENV, "0" if grouped else "1") == "1"


def int4_unpack_noop() -> bool:
    """Whether TPUSERVE_INT4_UNPACK is "noop" (anything else, and unset,
    is the JAX package's default "cur": unpack the nibbles)."""
    return os.environ.get(_UNPACK_ENV, "cur") == "noop"


def split_plan(units: int, s_dim: int, n_blocks: int, sms: int):
    """(splits, blocks per split) of the Hopper core: split a slot's window
    of `n_blocks` block_l blocks over more blocks of the grid until it holds
    about _CORE_SPLIT_FILL blocks an SM (units * S without a split), never
    below one whole block a split. It does not count row groups, so a
    multi-candidate call splits as the flat calls at its positions do. The
    plain versions take the same plan, so the CPU tests run the merge."""
    ctas = max(1, units * s_dim)
    want = max(1, min(n_blocks, (_CORE_SPLIT_FILL * sms) // ctas))
    bps = -(-n_blocks // want)
    return -(-n_blocks // bps), bps


def core_rows(cands: int, nq: int):
    """(row groups, padded rows of a group) of the Hopper core for `cands`
    candidates of `nq` query heads a kv unit: groups of up to 32 rows,
    padded to the mma's 8, 16 or 32."""
    rows = cands * nq
    rmax = min(rows, _CORE_RG)
    return -(-rows // _CORE_RG), (8 if rmax <= 8 else 16 if rmax <= 16 else 32)


def _stage_bytes(kind: int) -> int:
    """A ring stage of the Hopper kernels for a cache kind (stage_b)."""
    return _CORE_TR * _ROW_B.get(kind, 144) + 4 * _CORE_SC_W * 4


def core_smem_bytes(rp: int, block_l: int, pages: int = 0, kind: int = _KV_INT4) -> int:
    """Dynamic shared memory of one block of the Hopper core (its
    smem_bytes) for a cache `kind`: the cp.async ring (a V tile is
    transposed within its stage; 2 stages for a bf16 cache with up to 8
    rows, 3 for an int8 one with up to 8 and for f32, else 4), q codes
    (float: q's values), scores and P f32, P codes (bf16: P bf16; f32:
    none), the block's V scales, eight per-row statistics and flags, four
    per-warp partials a row and, paged, the `pages` page ids of a split."""
    blp = -(-block_l // _CORE_TR) * _CORE_TR
    if kind == _KV_BF16 and rp == 8:
        stages = 2
    else:
        stages = 3 if (kind == _KV_INT8 and rp == 8) or kind == _KV_F32 else 4
    p_row = {_KV_BF16: 2 * (blp + 8), _KV_F32: 0}.get(kind, blp + 16)
    return (stages * _stage_bytes(kind) + rp * _ROW_B.get(kind, 144) + rp * (blp + 4) * 4
            + rp * p_row + 2 * blp * 4 + 24 * rp * 4 + pages * 4)


def _plan_sms(device) -> int:
    if torch.device(device).type == "cuda":
        from tpuserve_torch import kernels
        return kernels.sm_count(device)
    return _H100_SMS


def _core_plan(g, device):
    """The Hopper core's (splits, blocks per split) for a geometry `g`;
    (1, n_blocks) for the float caches: a run of whole blocks would round P
    to bf16 at its own running max, and a float cache's flat, paged and
    multi entries are held to the TPU kernel's one online softmax over the
    window."""
    n_blocks = g["win"] // g["block_l"]
    if not g["kv_int8"]:
        return 1, n_blocks
    units = g["n_kv"] // 2 if g["kv_bits"] == 4 else g["n_kv"]
    return split_plan(units, g["s_dim"], n_blocks, _plan_sms(device))


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
    block_l = min(default_block_l() if block_l is None else int(block_l), win)
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
    g = _geometry(q, k_full, k_scale_l, window, block_l)
    return _attend_plain(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer, g,
                         skip=dynskip(), splits=_core_plan(g, q.device)[0])


def _attend_plain(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer, g,
                  cands: int = 1, skip: bool = True, splits: int = 1):
    """q [S, C*H, hd] rows candidate-major (C = `cands`): row c*H + h is
    candidate c's head h and sees cache rows <= positions[s] + c. `skip`
    (TPUSERVE_ATTN_DYNSKIP) skips a slot's blocks past its last row; without
    it they run, wholly masked. The window's blocks are cut into `splits`
    runs of whole blocks (the Hopper core's split_plan); each run's online
    softmax starts afresh, and the runs' (m, l, acc) are merged in order."""
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

    def fresh():
        return (torch.full((s_dim, m_dim, 1), _NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros((s_dim, m_dim, 1), dtype=torch.float32, device=dev),
                torch.zeros((s_dim, m_dim, hd), dtype=torch.float32, device=dev))

    n_blocks = win // bl
    bps = -(-n_blocks // splits)
    parts = []
    for z in range(splits):
        m_run, l_run, acc = fresh()
        for j in range(z * bps, min(n_blocks, (z + 1) * bps)):
            l0 = j * bl
            run = (l0 <= pos + cands - 1).view(s_dim, 1, 1)  # blocks past the last row skipped
            if not skip:
                run = torch.ones_like(run)
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
        parts.append((m_run, l_run, acc))
    return _merge_runs(parts)


def _merge_runs(parts):
    """The window's runs' online-softmax states (m, l, acc) merged in
    split order, as the Hopper kernels' last split does (one run: an exact
    identity), then out = acc / max(l, 1e-20) where l > 0, else 0."""
    m_run = torch.full_like(parts[0][0], _NEG_INF)
    l_run, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m_z, l_z, a_z in parts:
        m_new = torch.maximum(m_run, m_z)
        m_safe = torch.clamp_min(m_new, _NEG_INF / 2)
        corr, c_z = torch.exp(m_run - m_safe), torch.exp(m_z - m_safe)
        l_run = l_run * corr + l_z * c_z
        acc = acc * corr + a_z * c_z
        m_run = m_new
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


def _check_inputs(q, tensors, k, v):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode attention kernel: unsupported q dtype {q.dtype}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("decode attention kernel: all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError("decode attention kernel: inputs must be contiguous")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("decode attention kernel: k and v caches differ")


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
                       _geometry(q, k_full, k_scale_l, window, block_l), dynskip())
    launches += 1
    return out


def _launch_flat(q, k_full, v_full, k_scale_l, v_scale_l, positions, layer, g, skip: bool):
    """Check the inputs and launch the flat kernel, the Hopper core at
    C = 1, over the geometry `g` (`skip`: the kernel's dynskip flag)."""
    n_kv = g["n_kv"]
    kind, nq = _kernel_kind(k_full.dtype, g["kv_bits"], n_kv, g["rep"], g["hd"])
    _check_inputs(q, [q, k_full, v_full, positions]
                  + ([k_scale_l, v_scale_l] if g["quantized"] else []), k_full, v_full)
    if not 0 <= int(layer) < g["n_layers"]:
        raise ValueError(f"layer {layer} out of range")
    sc_bf16 = _check_scales(k_scale_l, v_scale_l, g) if g["quantized"] else 0
    pos32 = positions if positions.dtype == torch.int32 else positions.to(torch.int32)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    code = kind if skip else kind + _READ_ALL
    _launch_core(q, k_full, v_full, k_scale_l, v_scale_l, pos32, None, out, g, 1, nq, layer,
                 code, sc_bf16)
    return out


def _check_scales(k_scale_l, v_scale_l, g, what="decode attention kernel") -> int:
    """Raise unless the scales are this layer's [S, Hkv, L] f32 or bf16;
    return whether they are bf16."""
    want = (g["s_dim"], g["n_kv"], g["l_max"])
    if tuple(k_scale_l.shape) != want or tuple(v_scale_l.shape) != want:
        raise ValueError(f"{what}: scales must be {want}")
    if k_scale_l.dtype != v_scale_l.dtype or k_scale_l.dtype not in (torch.float32,
                                                                      torch.bfloat16):
        raise ValueError(f"{what}: scales must be f32 or bf16")
    return int(k_scale_l.dtype == torch.bfloat16)


def _core_counters(device) -> torch.Tensor:
    idx = torch.device(device).index or 0
    if idx not in _CORE_COUNTERS:
        _CORE_COUNTERS[idx] = torch.zeros(_CORE_MAX_COUNTERS, dtype=torch.int32, device=device)
    return _CORE_COUNTERS[idx]


def _launch_core(q, k, v, ks, vs, pos32, table, out, g, cands, nq, layer, code, sc_bf16,
                 n_pages=0, hp=0):
    """Launch the Hopper core (csrc/decode_attention_hopper.cu) over `g`:
    the split plan, its workspace and counters, one launch. ks/vs are None
    for a float cache."""
    from tpuserve_torch import kernels

    splits, bps = _core_plan(g, q.device)
    units = g["n_kv"] // 2 if g["kv_bits"] == 4 else g["n_kv"]
    groups, rp = core_rows(cands, nq)
    kind = code & ~_READ_ALL
    smem = core_smem_bytes(rp, g["block_l"], bps if table is not None else 0,
                           kind=_KV_INT4 if kind == 4 else kind)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode attention kernel: {smem} bytes of shared memory for "
                         f"{cands * nq} rows, block {g['block_l']}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:   # rows are copied in 16-byte pieces
        raise ValueError("decode attention kernel: k and v must be 16-byte aligned")
    ws = cnt = None
    if splits > 1:
        n_cnt = g["s_dim"] * units * groups
        if n_cnt > _CORE_MAX_COUNTERS:
            raise ValueError("decode attention kernel: too many (slot, unit) pairs to split")
        ws = torch.empty(n_cnt * splits * rp * (_HD + 2), dtype=torch.float32, device=q.device)
        cnt = _core_counters(q.device)
    rc = kernels.lib().tpuserve_decode_attention_core(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if ks is None else ks.data_ptr(),
        0 if vs is None else vs.data_ptr(),
        pos32.data_ptr(), 0 if table is None else table.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), 0 if cnt is None else cnt.data_ptr(),
        int(q.dtype == torch.bfloat16), sc_bf16, g["s_dim"], cands, g["n_heads"], g["n_kv"],
        g["l_max"], int(layer), g["win"], g["block_l"], k.shape[-1] * k.element_size(),
        n_pages, hp,
        0 if table is None else table.stride(0), code, nq, splits, bps, kernels.stream_of(q))
    kernels.check(rc, "decode_attention_core")


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
    return _attend_plain(q, kf, vf, k_scale, v_scale, positions, 0, g, skip=False)


def decode_attention_wide(q, k, v, k_scale, v_scale, positions, *,
                          block_l: int = 256) -> torch.Tensor:
    """The JAX package's decode_attention_wide (`_wide_kernel` with a
    prebuilt Q_wide), the flat kernel's function over a contiguous cache:
    q [S, H, hd] (f32 or bf16, scaled by 1/sqrt(hd)); k/v [S, L, Hkv, hd]
    int8, bf16 or f32; k_scale/v_scale [S, Hkv, L] (f32 or bf16) or None;
    positions [S] (-1 = inactive). L is read in blocks of `block_l`
    (clipped to L, halved until it divides L), never in the multi-slot
    packed form, which this entry never takes, and every block is read (the
    TPU kernel's block maps here are static: no per-slot skip). Returns [S,
    H, hd] f32. CUDA tensors launch the flat kernel (the Hopper core) on a
    one-layer view; CPU tensors take the plain version."""
    global wide_launches
    if not q.is_cuda:
        return decode_attention_wide_plain(q, k, v, k_scale, v_scale, positions,
                                           block_l=block_l)
    kf, vf, g = _wide_flat(q, k, v, k_scale, v_scale, block_l)
    out = _launch_flat(q, kf, vf, k_scale, v_scale, positions, 0, g, skip=False)
    wide_launches += 1
    return out


# ---------------------------------------------------------------- grouped
def unpack_kv_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of models.llama.pack_kv_codes: uint8 [..., W/2] -> int8 [...,
    W]. Three byte-wide passes: the low and high nibbles into the two
    halves, then the -8 offset, which wraps mod 256 into the int8 codes'
    bytes."""
    half = packed.shape[-1]
    out = torch.empty(packed.shape[:-1] + (2 * half,), dtype=torch.uint8, device=packed.device)
    torch.bitwise_and(packed, 15, out=out[..., :half])
    torch.bitwise_right_shift(packed, 4, out=out[..., half:])
    return out.sub_(8).view(torch.int8)


def _grouped_geometry(q, k, v, k_scale, v_scale, block_l: int):
    """Shapes, the L blocking and the window split of the grouped entry,
    chosen as the JAX package's decode_attention chooses them."""
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
    return _grouped_dims(q, l_max, n_kv, k.dtype == torch.int8, quantized, block_l)


def _grouped_dims(q, l_max: int, n_kv: int, kv_int8: bool, quantized: bool, block_l: int):
    """The grouped geometry of checked shapes: block_l halved until it
    divides L, and the window split."""
    s_dim, n_heads, hd = q.shape
    bl = max(1, min(int(block_l), l_max))
    while l_max % bl:
        bl //= 2
    g = dict(s_dim=s_dim, n_heads=n_heads, hd=hd, l_max=l_max, n_kv=n_kv,
             rep=n_heads // n_kv, quantized=quantized, kv_int8=kv_int8, block_l=bl)
    g["splits"], g["bps"] = _grouped_plan(g, q.device)
    return g


def _grouped_plan(g, device):
    """The grouped Hopper kernel's (splits, blocks per split): split_plan
    over the Hkv kv heads of S slots, for every route (int8, packed int4,
    bf16, f32) alike and whatever g_kv, so that neither changes a value."""
    n_blocks = g["l_max"] // g["block_l"]
    return split_plan(g["n_kv"], g["s_dim"], n_blocks, _plan_sms(device))


def decode_attention_plain(q, k, v, k_scale, v_scale, positions, *, block_l: int = 256,
                           g_kv: Optional[int] = None) -> torch.Tensor:
    """The grouped kernel's algorithm in plain PyTorch (any device), step
    for step as the TPU's `_kernel`: int8 q per (slot, head) and integer
    score dots for an int8 cache (q's own values for a float cache), then
    s * k_scale * q_scale; positions past positions[s] masked with -1e30;
    online softmax over `block_l` blocks (m_safe = max(m, -5e29)), blocks
    wholly past positions[s] skipped under TPUSERVE_ATTN_DYNSKIP=1 (read
    and masked by default: the same values); P * v_scale rounded to bf16 (unless
    the cache is f32) and P@V on V's values with f32 accumulation, no P
    requant; out = acc / max(l, 1e-20) where l > 0, else 0. Every cache
    takes the Hopper kernel's window split (`_grouped_plan`): each run of
    whole blocks starts its own online softmax and the runs' (m, l, acc)
    are merged in order, so P is rounded to bf16 at the run's max. `g_kv`
    only splits the TPU's work (its masked head pairs add exact zeros): it
    changes no value and is not read here. Returns [S, H, hd] f32."""
    g = _grouped_geometry(q, k, v, k_scale, v_scale, block_l)
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

    def fresh():
        return (torch.full((s_dim, n_heads, 1), _NEG_INF, dtype=torch.float32, device=dev),
                torch.zeros((s_dim, n_heads, 1), dtype=torch.float32, device=dev),
                torch.zeros((s_dim, n_heads, hd), dtype=torch.float32, device=dev))

    skip = dynskip(grouped=True)
    n_blocks, bps = l_max // bl, g["bps"]
    parts = []
    for z in range(g["splits"]):
        m_run, l_run, acc = fresh()
        for l0 in range(z * bps * bl, min(n_blocks, (z + 1) * bps) * bl, bl):
            run = (l0 <= pos) | (not skip)
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
        parts.append((m_run, l_run, acc))
    return _merge_runs(parts)


def grouped_smem_bytes(nq: int, block_l: int, kind: int = _KV_INT8) -> int:
    """Dynamic shared memory of one block of the grouped Hopper kernel (its
    grouped_smem) for nq query rows a unit of a cache `kind`: a 3-stage
    cp.async ring, q (padded to the mma's 8 or 16 rows: int8 codes, a bf16
    window's three bf16 pieces, f32 values), scores f32 and P bf16 of the
    block's nq rows (f32: P in the score rows), its V scales, six per-row
    statistics and two per-warp partials a padded row."""
    rp = 8 if nq <= 8 else 16
    blp = -(-block_l // _CORE_TR) * _CORE_TR
    q_row = {_KV_BF16: 3 * 272, _KV_F32: 528}.get(kind, 144)
    p_rows = 0 if kind == _KV_F32 else nq * (blp + 8) * 2
    return (3 * _stage_bytes(kind) + rp * q_row + nq * (blp + 4) * 4 + p_rows + 2 * blp * 4
            + 6 * rp * 4 + 2 * 4 * rp * 4)


def _launch_grouped_hopper(q, k, v, ks, vs, pos32, g, kind, nq, row_stride, what):
    """Launch csrc/decode_attention_grouped_hopper.cu over the window k/v
    (int8, bf16 or f32 [S, L, Hkv, hd] or packed [S, L, Hkv*hd/2] views with
    contiguous rows; `row_stride` in bytes) and head-major scales ks/vs [S,
    Hkv, L] (unit stride along L; None for an unscaled float window); kind
    0 int8, 1 packed int4, 2 bf16, 3 f32."""
    from tpuserve_torch import kernels

    s_dim, n_kv = g["s_dim"], g["n_kv"]
    units = n_kv // 2 if kind == _KV_INT4 else n_kv
    rp = 8 if nq <= 8 else 16
    smem = grouped_smem_bytes(nq, g["block_l"], kind)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what}: {smem} bytes of shared memory for {nq} query heads a kv "
                         f"unit, block {g['block_l']}")
    if (k.stride(0) * k.element_size()) % 16 or row_stride % 16 or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError(f"{what}: k/v slots and rows must be 16-byte aligned")
    if ks is not None and (ks.stride() != vs.stride() or ks.stride(2) != 1):
        raise ValueError(f"{what}: the scales must be [S, Hkv, L] views of one layout with "
                         "unit stride along L")
    splits, bps = g["splits"], g["bps"]
    ws = cnt = None
    if splits > 1:
        n_cnt = s_dim * units
        if n_cnt > _CORE_MAX_COUNTERS:
            raise ValueError(f"{what}: too many (slot, unit) pairs to split")
        ws = torch.empty(n_cnt * splits * rp * (_HD + 2), dtype=torch.float32, device=q.device)
        cnt = _core_counters(q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    code = kind if dynskip(grouped=True) else kind + _READ_ALL
    scaled = ks is not None
    rc = kernels.lib().tpuserve_decode_attention_grouped_hopper(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr() if scaled else 0,
        vs.data_ptr() if scaled else 0, pos32.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), 0 if cnt is None else cnt.data_ptr(),
        k.stride(0) * k.element_size(), ks.stride(0) if scaled else 0,
        ks.stride(1) if scaled else 0, int(q.dtype == torch.bfloat16),
        int(scaled and ks.dtype == torch.bfloat16), s_dim, g["n_heads"], n_kv, g["l_max"],
        g["block_l"], row_stride, code, nq, splits, bps, kernels.stream_of(q))
    kernels.check(rc, "decode_attention_grouped_hopper")
    return out


def _check_grouped_call(q, positions, tensors, what):
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous f32 or bf16")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: all inputs must be on one device")
    if positions.shape != (q.shape[0],):
        raise ValueError("grouped decode attention: positions must be [S]")


def _check_scale_dtypes(k_scale, v_scale, what):
    if k_scale.dtype != v_scale.dtype or k_scale.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: scales must be f32 or bf16")


def decode_attention(q, k, v, k_scale, v_scale, positions, *, block_l: int = 256,
                     g_kv: Optional[int] = None) -> torch.Tensor:
    """Grouped decode attention (the JAX package's decode_attention, the
    `_kernel` behind TPUSERVE_DECODE_ATTN=grouped).

    q [S, H, hd] (f32 or bf16), already scaled by 1/sqrt(hd); k/v [S, L,
    Hkv, hd] int8, bf16 or f32, the last three dims contiguous (a window
    view of a longer cache is taken in place: slots may be any 16-byte
    multiple apart); k_scale/v_scale [S, L, Hkv] f32 or bf16, any strides
    (a transposed view of the head-major scale cache is read in place,
    other layouts are copied head-major first), or None for a float
    cache; positions [S] int (-1 = inactive); `block_l` the online-softmax
    block; `g_kv`, the TPU kernel's kv heads a grid step (TPUSERVE_ATTN_GKV
    there), is taken for the JAX package's signature and changes nothing:
    the Hopper kernel takes one kv unit a block (a block that walked g_kv
    units in turn shrank the grid to Hkv / g_kv * S blocks). Returns
    [S, H, hd] f32. CUDA tensors launch csrc/decode_attention_grouped_hopper.cu
    (int8, bf16 and f32 windows); CPU tensors take the plain version."""
    global grouped_launches
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, k_scale, v_scale, positions, block_l=block_l,
                                      g_kv=g_kv)
    what = "grouped decode attention kernel"
    g = _grouped_geometry(q, k, v, k_scale, v_scale, block_l)
    n_kv = g["n_kv"]
    kind, nq = _kernel_kind(k.dtype, 8, n_kv, g["rep"], g["hd"])
    quantized = g["quantized"]
    _check_grouped_call(q, positions, [q, k, v, positions] + ([k_scale, v_scale] if quantized
                                                               else []), what)
    esz = k.element_size()
    if (k.stride()[1:] != (n_kv * _HD, _HD, 1) or v.stride() != k.stride()
            or (k.stride(0) * esz) % 16 or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("grouped decode attention kernel: k/v must be [S, L, Hkv, hd] views "
                         "with contiguous rows, 16-byte aligned slots and equal strides")
    if quantized:
        _check_scale_dtypes(k_scale, v_scale, what)
        if k_scale.stride() != v_scale.stride():
            raise ValueError("grouped decode attention kernel: k and v scales differ in strides")
    pos32 = positions.to(torch.int32).contiguous()
    ks = vs = None
    if quantized:
        ks, vs = k_scale.transpose(1, 2), v_scale.transpose(1, 2)    # [S, Hkv, L]
        if ks.stride(2) != 1:   # other layouts are copied head-major
            ks, vs = ks.contiguous(), vs.contiguous()
    out = _launch_grouped_hopper(q, k, v, ks, vs, pos32, g, kind, nq, n_kv * _HD * esz, what)
    grouped_launches += 1
    return out


def _packed_views(k, v, k_scale, v_scale, n_kv):
    """The packed route's operands as the public entry's: k/v unpacked to
    int8 codes [S, L, Hkv, hd], scales as [S, L, Hkv] views."""
    s_dim, l_max = k.shape[:2]
    k8, v8 = (unpack_kv_codes(t).view(s_dim, l_max, n_kv, _HD) for t in (k, v))
    return k8, v8, k_scale.transpose(1, 2), v_scale.transpose(1, 2)


def _check_packed(q, k, v, k_scale, v_scale):
    if k.dim() != 3 or k.dtype != torch.uint8 or k.shape != v.shape or v.dtype != torch.uint8:
        raise ValueError("packed grouped decode attention: k/v must be packed int4 uint8 "
                         "[S, L, Hkv*hd/2] of one shape")
    s_dim, l_max, w_half = k.shape
    n_kv = 2 * w_half // _HD
    if q.dim() != 3 or q.shape[0] != s_dim or q.shape[2] != _HD or n_kv < 2 \
            or 2 * w_half != n_kv * _HD or n_kv % 2:
        raise ValueError(f"packed grouped decode attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not fit (head_dim {_HD}, an even n_kv_heads)")
    want = (s_dim, n_kv, l_max)
    if k_scale is None or tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(f"packed grouped decode attention: scales must be {want}")
    return n_kv


def decode_attention_packed_plain(q, k, v, k_scale, v_scale, positions, *, block_l: int = 256,
                                  g_kv: Optional[int] = None) -> torch.Tensor:
    """The packed route in plain PyTorch (any device): the window unpacked
    to int8 codes by unpack_kv_codes, then decode_attention_plain over it
    with the scales as [S, L, Hkv] views. [S, H, hd] f32."""
    n_kv = _check_packed(q, k, v, k_scale, v_scale)
    return decode_attention_plain(q, *_packed_views(k, v, k_scale, v_scale, n_kv), positions,
                                  block_l=block_l, g_kv=g_kv)


def decode_attention_packed(q, k, v, k_scale, v_scale, positions, *, block_l: int = 256,
                            g_kv: Optional[int] = None) -> torch.Tensor:
    """Grouped decode attention over a packed int4 window, read in place:
    the decode step's route under TPUSERVE_DECODE_ATTN=grouped for a packed
    int4 cache (the JAX package unpacks the window in XLA and calls
    decode_attention; the values are those of unpack_kv_codes followed by
    decode_attention, up to the order of f32 sums).

    q [S, H, hd] (f32 or bf16), scaled by 1/sqrt(hd); k/v packed uint8 [S,
    L, Hkv*hd/2] (global split-half, see models.llama.pack_kv_codes) with
    contiguous rows, slots any 16-byte multiple apart (a window view of a
    layer of the flat cache); k_scale/v_scale the head-major [S, Hkv, L]
    f32 or bf16 scales (a window view of the scale cache); positions [S]
    int (-1 = inactive); block_l and g_kv as decode_attention. Returns [S,
    H, hd] f32. CUDA tensors launch csrc/decode_attention_grouped_hopper.cu,
    which decodes the nibbles itself; CPU tensors take the plain version."""
    global grouped_launches
    if not q.is_cuda:
        return decode_attention_packed_plain(q, k, v, k_scale, v_scale, positions,
                                             block_l=block_l, g_kv=g_kv)
    what = "packed grouped decode attention kernel"
    n_kv = _check_packed(q, k, v, k_scale, v_scale)
    s_dim, l_max, w_half = k.shape
    n_heads = q.shape[1]
    if n_heads % n_kv:
        raise ValueError(f"{what}: {n_heads} heads over {n_kv} kv heads")
    g = _grouped_dims(q, l_max, n_kv, True, True, block_l)   # the unpacked window's
    nq = 2 * g["rep"]
    if nq > 16:
        raise ValueError(f"{what}: {nq} query heads per kv head pair unsupported")
    _check_grouped_call(q, positions, [q, k, v, k_scale, v_scale, positions], what)
    _check_scale_dtypes(k_scale, v_scale, what)
    if k.stride(2) != 1 or k.stride(1) != w_half or v.stride() != k.stride():
        raise ValueError(f"{what}: k/v must be [S, L, W/2] views with contiguous rows and "
                         "equal strides")
    pos32 = positions.to(torch.int32).contiguous()
    out = _launch_grouped_hopper(q, k, v, k_scale, v_scale, pos32, g, 1, nq, w_half, what)
    grouped_launches += 1
    return out


# ---------------------------------------------------------------- candidates
_MULTI_MAX_C = 16          # candidates per slot the multi kernel takes
_SMEM_LIMIT = 227 * 1024   # shared memory one block may use on the H100


def check_multi_kernel(cands: int, nq: int, block_l: Optional[int] = None,
                       cache: str = "int8") -> None:
    """Raise ValueError unless the multi kernel (the Hopper core) takes
    `cands` candidates of `nq` query heads per block over blocks of
    `block_l` rows (None: the entry's default, TPUSERVE_ATTN_BLOCK_L or 128)
    of a `cache` ("int8", "int4", "bf16" or "f32")."""
    block_l = default_block_l() if block_l is None else block_l
    if not 1 <= cands <= _MULTI_MAX_C:
        raise ValueError(f"multi decode attention kernel: {cands} candidates, "
                         f"takes 1..{_MULTI_MAX_C}")
    smem = core_smem_bytes(core_rows(cands, nq)[1], block_l, kind=_CACHE_KINDS[cache])
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
                        v_scale_l, positions, layer, g, cands=cands, skip=dynskip(),
                        splits=_core_plan(g, q.device)[0])
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
    garbage for the caller to mask. CUDA tensors launch the Hopper core
    (1 <= C <= 16; every cache, a float one never split); CPU tensors take
    the plain version."""
    global multi_launches
    if not q.is_cuda:
        return decode_attention_wide_cache_multi_plain(q, k_full, v_full, k_scale_l, v_scale_l,
                                                       positions, layer, window=window,
                                                       block_l=block_l)
    if q.dim() != 4:
        raise ValueError("multi decode attention expects q [S, C, H, hd]")
    s_dim, cands, n_heads, hd = q.shape
    check_multi_kernel(cands, 1)   # C first: _geometry reads candidate 0
    g = _geometry(q[:, 0], k_full, k_scale_l, window, block_l, pack=False)
    n_kv = g["n_kv"]
    kind, nq = _kernel_kind(k_full.dtype, g["kv_bits"], n_kv, g["rep"], hd)
    _check_inputs(q, [q, k_full, v_full, positions]
                  + ([k_scale_l, v_scale_l] if g["quantized"] else []), k_full, v_full)
    cache = {_KV_INT8: "int8", _KV_BF16: "bf16", _KV_F32: "f32"}.get(kind, "int4")
    check_multi_kernel(cands, nq, g["block_l"], cache=cache)
    if not 0 <= int(layer) < g["n_layers"]:
        raise ValueError(f"layer {layer} out of range")
    if positions.shape != (s_dim,):
        raise ValueError("multi decode attention: positions must be [S]")
    sc_bf16 = _check_scales(k_scale_l, v_scale_l, g, "multi decode attention kernel") \
        if g["quantized"] else 0
    pos32 = positions if positions.dtype == torch.int32 else positions.to(torch.int32)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    code = kind if dynskip() else kind + _READ_ALL
    _launch_core(q, k_full, v_full, k_scale_l, v_scale_l, pos32, None, out, g, cands, nq, layer,
                 code, sc_bf16)
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
    return _attend_plain(q, k, v, ks, vs, positions, 0, g,
                         splits=_core_plan(g, q.device)[0])


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
                  + ([k_scale_pool, v_scale_pool] if quantized else []), k_pool, v_pool)
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
    g = dict(s_dim=s_dim, n_heads=n_heads, n_kv=n_kv, kv_bits=kv_bits, kv_int8=quantized,
             rep=n_heads // n_kv, win=win, block_l=ps, l_max=ps)
    _launch_core(q, k_pool, v_pool, k_scale_pool, v_scale_pool, positions, page_table, out, g, 1,
                 nq, layer, kind, 0, n_pages=n_pages, hp=hp)
    paged_launches += 1
    return out
