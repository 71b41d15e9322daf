"""Probes of the decode-attention diagnostic ladder (PyTorch port of the
Pallas kernels in scripts/sweep_attention.py; run by
tpuserve_torch.scripts.sweep_attention).

Each probe streams an int8 K/V cache [S, L, Hkv, 128] in one of the
attention's access patterns and computes a function of every byte it reads
(the TPU probes write a last-block leftover of no meaning instead):

- `dma_bound` (dma_bound.kern): the cache as [S, L*Hkv, 128], one block per
  64 positions x all heads of a slot; int32 column sums [128] over every K
  and V row;
- `dma_wide` (dma_wide.kern, 2-D and 3-D): the same bytes as rows of
  [S*L, Hkv*128], blocks of 16 rows in one grid dimension or in (row
  block, slot) order; the same column sums;
- `dot_only` (dot_only.kern): out[s, m] = sum over every row r of
  bf16(1e-6 * (qi[s, m] . k[s, r])) * bf16(v[s, r]), f32 accumulation: the
  attention's two dots over all L*Hkv rows, no softmax, no head matching;
  both dots on the tensor cores behind a cp.async ring.

`diag_copy` (scripts/diag_bw.py::copy_kernel, port of its modes pcopy,
pcopy4d and pdyn; run by tpuserve_torch.scripts.diag_bw) streams int8 K/V
[S, L, Hkv, hd], hd any multiple of 16 up to 256, in blocks of `block_l`
positions, and returns int32 column sums [hd] over every row segment it
reads (the TPU kernel returns the last block's):

- `pcopy`: contiguous blocks of block_l x Hkv rows of the [S, L*Hkv, hd]
  view, grid (L/block_l, S);
- `pcopy4d`: strided blocks (block_l, g, hd) of [S, L, Hkv, hd], runs of
  g*hd bytes at a stride of Hkv*hd, grid (L/block_l, Hkv/g, S);
- `pdyn`: pcopy, but block j of a slot reads nothing past its live block
  max(positions[s], 0) // block_l (the TPU clamps the block index there,
  and its pipeline skips the repeated fetch).

Those grids are the TPU's. The card's grid is not (`diag_copy_plan`): each
TPU block is cut into CTAs of consecutive rows, so that the card holds
several CTAs an SM whatever block_l is.

For CUDA tensors each wrapper launches its kernel in csrc/attention_probes.cu
(see the note there); for CPU tensors it runs the plain version.
"""

from __future__ import annotations

import torch

dma_bound_launches = 0
dma_wide_launches = 0
dot_only_launches = 0
diag_copy_launches = 0

_HD = 128
_POSITIONS = 64    # positions of a dma_bound block (the TPU probe's)
_WIDE_ROWS = 16    # rows of a dma_wide block: 64 KB of K and of V at Hkv = 32
_DOT_TILE = 64     # cache rows of a dot_only tile
_DOT_Q = 32        # query rows of a dot_only block
_MAX_HD = 256      # widest row segment diag_copy takes
_CTA_BYTES = 64 * 1024  # bytes of one of K, V a diag_copy CTA reads at most
_CTAS_PER_SM = 2        # diag_copy CTAs an SM the plan keeps at least, where rows allow
_SMS = 132              # the H100's SMs: the plan's default
COPY_MODES = ("pcopy", "pcopy4d", "pdyn")


def _check_cache(k, v):
    if k.dim() != 4 or k.shape[-1] != _HD:
        raise ValueError(f"attention probes take k/v [S, L, Hkv, {_HD}], got {tuple(k.shape)}")
    if k.shape != v.shape or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError("attention probes take int8 k and v of one shape")


def colsum_plain(k, v) -> torch.Tensor:
    """What dma_bound and dma_wide compute, in plain PyTorch: int32 column
    sums [128] over every 128-byte row segment of k and of v."""
    _check_cache(k, v)
    return (k.reshape(-1, _HD).sum(dim=0, dtype=torch.int32)
            + v.reshape(-1, _HD).sum(dim=0, dtype=torch.int32))


def _launch_colsum(k, v, chunk_bytes: int, slot_bytes: int, chunks_x: int, slots: int,
                   by_slot: bool) -> torch.Tensor:
    from tpuserve_torch import kernels

    if not (k.is_contiguous() and v.is_contiguous()) or k.device != v.device:
        raise ValueError("attention probes: k and v must be contiguous on one device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("attention probes: k and v must be 16-byte aligned")
    if chunk_bytes % (_HD * 16):
        raise ValueError(f"attention probes: a block of {chunk_bytes} bytes is not a multiple "
                         f"of {_HD * 16}")
    out = torch.zeros(_HD, dtype=torch.int32, device=k.device)
    rc = kernels.lib().tpuserve_probe_colsum(k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                             chunk_bytes, slot_bytes, chunks_x, slots,
                                             int(by_slot), kernels.stream_of(k))
    kernels.check(rc, "probe_colsum")
    return out


def dma_bound(k, v) -> torch.Tensor:
    """Column sums [128] int32 over k/v [S, L, Hkv, 128] int8, streamed as
    [S, L*Hkv, 128] in blocks of 64 positions x all heads of a slot."""
    global dma_bound_launches
    _check_cache(k, v)
    if not k.is_cuda:
        return colsum_plain(k, v)
    s_dim, l_max, n_kv, _ = k.shape
    pos = min(_POSITIONS, l_max)
    if l_max % pos:
        raise ValueError(f"dma_bound: L={l_max} is not a multiple of {pos}")
    out = _launch_colsum(k, v, pos * n_kv * _HD, l_max * n_kv * _HD, l_max // pos, s_dim, True)
    dma_bound_launches += 1
    return out


def dma_wide(k, v, three_d: bool = False) -> torch.Tensor:
    """Column sums [128] int32 over k/v [S, L, Hkv, 128] int8, streamed as
    rows of [S*L, Hkv*128] in blocks of 16 rows (the TPU probe's 256-row
    blocks would give 64 blocks for 132 SMs): one grid dimension (2-D), or
    (row block, slot) with blocks inside a slot (3-D)."""
    global dma_wide_launches
    _check_cache(k, v)
    if not k.is_cuda:
        return colsum_plain(k, v)
    s_dim, l_max, n_kv, _ = k.shape
    rows = min(_WIDE_ROWS, l_max)
    if l_max % rows:
        raise ValueError(f"dma_wide: L={l_max} is not a multiple of {rows}")
    w = n_kv * _HD
    if three_d:
        out = _launch_colsum(k, v, rows * w, l_max * w, l_max // rows, s_dim, True)
    else:
        out = _launch_colsum(k, v, rows * w, 0, s_dim * l_max // rows, 1, False)
    dma_wide_launches += 1
    return out


def probe_q(q: torch.Tensor) -> torch.Tensor:
    """dot_only's query codes: clip(round(q * 64), +-127) as int8."""
    return torch.clamp(torch.round(q.to(torch.float32) * 64), -127, 127).to(torch.int8)


def dot_only_plain(qi, k, v) -> torch.Tensor:
    """dot_only in plain PyTorch: qi [S, M, 128] int8, k/v [S, L, Hkv, 128]
    int8 -> [S, M, 128] f32."""
    _check_cache(k, v)
    s_dim = k.shape[0]
    kf = k.reshape(s_dim, -1, _HD)
    vf = v.reshape(s_dim, -1, _HD)
    d = torch.einsum("smd,srd->smr", qi.to(torch.float64), kf.to(torch.float64))  # exact
    p = (d.to(torch.float32) * 1e-6).to(torch.bfloat16).to(torch.float32)
    return torch.einsum("smr,srd->smd", p, vf.to(torch.float32))


def dot_only_tiles_per_block(s_dim: int, m: int, rows: int, sms: int) -> int:
    """64-row tiles a block of the dot_only kernel takes: a slot's rows cut
    into as many runs as two blocks an SM allow in one wave (the kernel's
    shared memory holds two), given S x ceil(M / 32) (slot, query group)
    pairs."""
    tiles = rows // _DOT_TILE
    runs = max(1, min(tiles, (2 * sms) // (s_dim * -(-m // _DOT_Q))))
    return -(-tiles // runs)


def dot_only(qi, k, v) -> torch.Tensor:
    """The attention's two dots without softmax: qi [S, M, 128] int8 (see
    probe_q), k/v [S, L, Hkv, 128] int8 -> [S, M, 128] f32. The kernel
    streams the L*Hkv rows of a slot in 64-row tiles (L*Hkv a multiple of
    64), 32 query rows a block."""
    global dot_only_launches
    _check_cache(k, v)
    if qi.dim() != 3 or qi.shape[0] != k.shape[0] or qi.shape[2] != _HD or qi.dtype != torch.int8:
        raise ValueError(f"dot_only: qi must be int8 [S, M, {_HD}], got {tuple(qi.shape)}")
    if not k.is_cuda:
        return dot_only_plain(qi, k, v)
    from tpuserve_torch import kernels

    s_dim, l_max, n_kv, _ = k.shape
    m = qi.shape[1]
    rows = l_max * n_kv
    if rows % _DOT_TILE:
        raise ValueError(f"dot_only: L*Hkv={rows} is not a multiple of {_DOT_TILE}")
    if not (qi.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("dot_only: inputs must be contiguous")
    if len({qi.device, k.device, v.device}) != 1:
        raise ValueError("dot_only: inputs must be on one device")
    if qi.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("dot_only: inputs must be 16-byte aligned")
    out = torch.zeros((s_dim, m, _HD), dtype=torch.float32, device=k.device)
    tpb = dot_only_tiles_per_block(s_dim, m, rows, kernels.sm_count(k.device))
    rc = kernels.lib().tpuserve_probe_dot_only(qi.data_ptr(), k.data_ptr(), v.data_ptr(),
                                               out.data_ptr(), s_dim, m, rows, tpb,
                                               kernels.stream_of(k))
    kernels.check(rc, "probe_dot_only")
    dot_only_launches += 1
    return out


# ---------------------------------------------------------------- diag_bw
def _check_copy(k, v, mode: str, block_l: int, g: int, positions):
    if mode not in COPY_MODES:
        raise ValueError(f"diag_copy: unknown mode {mode!r}; known: {', '.join(COPY_MODES)}")
    if k.dim() != 4 or k.shape != v.shape or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError("diag_copy takes int8 k and v [S, L, Hkv, hd] of one shape")
    s_dim, l_max, n_kv, hd = k.shape
    if hd <= 0 or hd % 16 or hd > _MAX_HD:
        raise ValueError(f"diag_copy: hd={hd} must be a multiple of 16 up to {_MAX_HD}")
    if block_l <= 0 or l_max % block_l:
        raise ValueError(f"diag_copy: block_l={block_l} does not divide L={l_max}")
    if mode == "pcopy4d" and (g <= 0 or n_kv % g):
        raise ValueError(f"diag_copy: g={g} does not divide Hkv={n_kv}")
    if mode == "pdyn" and (positions is None or positions.shape != (s_dim,)):
        raise ValueError("diag_copy: pdyn takes positions [S]")


def diag_copy_plain(k, v, mode: str, block_l: int, g: int = 1, positions=None) -> torch.Tensor:
    """What diag_copy computes, in plain PyTorch: int32 column sums [hd] of
    every row segment of k and v that the mode reads (pdyn: the blocks of
    each slot up to its live one)."""
    _check_copy(k, v, mode, block_l, g, positions)
    s_dim, l_max, _, hd = k.shape
    if mode != "pdyn":
        return (k.reshape(-1, hd).sum(dim=0, dtype=torch.int32)
                + v.reshape(-1, hd).sum(dim=0, dtype=torch.int32))
    live = torch.div(positions.to(k.device).long().clamp_min(0), block_l, rounding_mode="floor")
    read = (torch.arange(l_max, device=k.device) // block_l)[None, :] <= live[:, None]  # [S, L]
    keep = read[:, :, None, None]
    return (torch.where(keep, k, 0).sum(dim=(0, 1, 2), dtype=torch.int32)
            + torch.where(keep, v, 0).sum(dim=(0, 1, 2), dtype=torch.int32))


def diag_copy(k, v, mode: str, block_l: int, g: int = 1, positions=None) -> torch.Tensor:
    """copy_kernel of scripts/diag_bw.py in the form of `mode` (see the
    module's note): int32 column sums [hd] over k/v [S, L, Hkv, hd] int8,
    blocks of `block_l` positions, `g` kv heads a block (pcopy4d), slots
    limited by `positions` [S] int32 (pdyn)."""
    global diag_copy_launches
    _check_copy(k, v, mode, block_l, g, positions)
    if not k.is_cuda:
        return diag_copy_plain(k, v, mode, block_l, g, positions)
    from tpuserve_torch import kernels

    _, l_max, n_kv, hd = k.shape
    if not (k.is_contiguous() and v.is_contiguous()) or k.device != v.device:
        raise ValueError("diag_copy: k and v must be contiguous on one device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("diag_copy: k and v must be 16-byte aligned")
    pos = 0
    if mode == "pdyn":
        if positions.device != k.device or positions.dtype != torch.int32:
            raise ValueError("diag_copy: pdyn takes int32 positions on the card")
        positions = positions.contiguous()
        pos = positions.data_ptr()
    row, run, group_stride = _copy_layout(k.shape, mode, g)
    rpc, cpb, _ = diag_copy_plan(k.shape, mode, block_l, g, kernels.sm_count(k.device))
    out = torch.zeros(hd, dtype=torch.int32, device=k.device)
    rc = kernels.lib().tpuserve_probe_colsum_strided(
        k.data_ptr(), v.data_ptr(), out.data_ptr(), pos, l_max * row, group_stride,
        block_l * row, row, block_l, run, hd, block_l,
        *diag_copy_tpu_grid(k.shape, mode, block_l, g), rpc, cpb, kernels.stream_of(k))
    kernels.check(rc, f"diag_copy {mode}")
    diag_copy_launches += 1
    return out


def _copy_layout(k_shape, mode: str, g: int):
    """(bytes of a position, bytes of a run, bytes between groups): a
    pcopy4d block reads (block_l, g, hd) runs of g*hd bytes, the others
    (block_l*Hkv, hd) blocks that are contiguous."""
    _, _, n_kv, hd = k_shape
    row = n_kv * hd
    return (row, g * hd, g * hd) if mode == "pcopy4d" else (row, row, 0)


def diag_copy_tpu_grid(k_shape, mode: str, block_l: int, g: int = 1):
    """The TPU kernel's grid for a cache of `k_shape` [S, L, Hkv, hd]:
    (blocks along L, kv-head groups, slots)."""
    s_dim, l_max, n_kv, _ = k_shape
    return (l_max // block_l, n_kv // g if mode == "pcopy4d" else 1, s_dim)


def diag_copy_plan(k_shape, mode: str, block_l: int, g: int = 1, sms: int = _SMS):
    """How the card's grid cuts the TPU's (csrc/attention_probes.cu::
    colsum_strided_kernel): (rows a CTA, CTAs a TPU block, CUDA grid). A
    TPU block's block_l runs go to cpb CTAs of rpc consecutive runs each
    (the last one the rest): at most _CTA_BYTES of K (and as many of V) a
    CTA, and no more rows than keep _CTAS_PER_SM CTAs an SM over the whole
    grid; CTA x of the grid reads TPU block x // cpb, rows (x % cpb) * rpc
    on."""
    bx, groups, slots = diag_copy_tpu_grid(k_shape, mode, block_l, g)
    run = _copy_layout(k_shape, mode, g)[1]
    want = block_l * bx * groups * slots // (_CTAS_PER_SM * sms)
    rpc = max(1, min(block_l, _CTA_BYTES // run, want))
    cpb = -(-block_l // rpc)
    rpc = -(-block_l // cpb)          # the rows spread evenly over the CTAs
    cpb = -(-block_l // rpc)
    return rpc, cpb, (bx * cpb, groups, slots)


def diag_copy_grid(k_shape, mode: str, block_l: int, g: int = 1, sms: int = _SMS):
    """The kernel's CUDA grid for a cache of `k_shape` [S, L, Hkv, hd]
    (diag_copy_plan's; the TPU's is diag_copy_tpu_grid)."""
    return diag_copy_plan(k_shape, mode, block_l, g, sms)[2]
