"""Fused dequant+matmul — the hot op of the quantized serving path
(PyTorch port of tpuserve/ops/quant_matmul.py).

Computes x[B, K] @ dequant(W)[K, N] where W is INT8 [K, N] or packed INT4
[K//2, N] with group-wise scales [G, N] (tpuserve_torch.quant.core
conventions). For a tensor on the card the wrapper launches the CUDA kernel
in csrc/quant_matmul.cu; for a tensor on the CPU it runs the kernel's plain
PyTorch version below, which repeats the kernel's arithmetic (the bf16
kernel folds the -8 into its code conversion instead, which gives the same
exact products and differs only in the order of f32 sums):

- int4: per group, the raw nibbles stay biased in [0, 15] and the -8 is
  folded as  x.lo + x.hi - 8*rowsum(x) , then scaled in f32;
- int8: per group  x.w , scaled in f32;
- f32 x: x split into three bf16 pieces (split_x), each piece's exact
  products with the codes (int4: code - 8) summed per group in f32, the
  three sums added, each group scaled and added in group order;
- W4A8 (int4 weights, act_bits 8): x is quantized to int8 per row, the
  per-group dots are integer with the -8 fold in int32, and the per-row
  activation scale multiplies the f32 output.

bf16 activations take the Hopper kernel for every group (`bf16_route`):
groups of a multiple of 16 values whose stages tile 64 weight rows as
they are, the groups those stages cannot tile (48, 80, 96, 112, ...) in
stages cut along the groups (`stage_plan`, counted in
`odd_group_launches`), and the groups of no multiple of 16 in masked k16
steps (`masked_group`, counted in `group_route_launches`). W4A8 takes the
Hopper int8 kernel for every even group (`w4a8_route`): k32 steps for
groups of a multiple of 32 (`w4a8_launches`), masked ones for the rest
(`w4a8_route_launches`). f32 activations take the bf16 route's kernel
for every group the bf16 route takes, as three bf16 pieces (`split_x`,
counted in `split_launches`; the matmul in `f32_launches`).

Leading dims of x are flattened into the batch and restored.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuserve_torch.quant.core import QTensor, quantize_activation, unpack_int4

launches = 0  # CUDA kernel launches (the plain version does not count)
# of those, bf16 activations on the Hopper kernel in masked k16 steps
# (groups of no multiple of 16 values; see masked_group)
group_route_launches = 0
# bf16 activations on the Hopper kernel in stages cut along odd groups
odd_group_launches = 0
# W4A8 on the Hopper int8 kernel: groups of a multiple of 32, and the
# others in masked k32 steps
w4a8_launches = 0
w4a8_route_launches = 0
quantize_launches = 0  # the row quantization kernel (quantize_rows), every W4A8 call
stage_launches = 0     # the bf16 x gather of the masked steps (stage_x)
# f32 activations on the Hopper kernel as three bf16 pieces (every group),
# and the kernel that splits them (split_x)
f32_launches = 0
split_launches = 0
PIECES = 3             # bf16 pieces of an f32 x


def _group_size(qt: QTensor) -> int:
    k = qt.orig_shape[0]
    return qt.group_size if qt.group_size > 0 else k


def quant_matmul_plain(x: torch.Tensor, qt: QTensor, *, out_dtype=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (any device)."""
    k, n = qt.orig_shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != K {k}")
    lead = x.shape[:-1]
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    gs = _group_size(qt)
    groups = k // gs
    scale = qt.scale.to(torch.float32)
    if qt.bits == 4 and qt.act_bits == 8:
        xq, sx = quantize_activation(x2)
        codes = unpack_int4(qt.q, gs).to(torch.int32) + 8             # biased [0, 15]
        xg = xq.reshape(-1, groups, gs).to(torch.float64)
        wg = codes.reshape(groups, gs, n).to(torch.float64)
        dots = torch.einsum("bgk,gkn->bgn", xg, wg)                    # exact integers
        rsum = xg.sum(dim=2, keepdim=True)
        part = (dots - 8.0 * rsum).to(torch.float32)
        # the groups added one after another in f32, as the kernel adds them
        # within a K split (a split adds its partial sums in split order)
        out = torch.zeros_like(part[:, 0])
        for g in range(groups):
            out = out + part[:, g] * scale[g]
        return (out * sx).to(out_dtype).reshape(*lead, n)
    if x2.dtype == torch.float32:
        # the kernel's f32 route: exact products of each bf16 piece with the
        # codes, summed per group in f32, the pieces added in order, the
        # groups scaled and added in order
        xg = split_x_plain(x2).float().reshape(PIECES, -1, groups, gs)
        codes = unpack_int4(qt.q, gs) if qt.bits == 4 else qt.q
        wg = codes.reshape(groups, gs, n).to(torch.float32)
        part = torch.einsum("bgk,gkn->bgn", xg[0], wg)
        for piece in xg[1:]:
            part = part + torch.einsum("bgk,gkn->bgn", piece, wg)
        out = torch.zeros_like(part[:, 0])
        for g in range(groups):
            out = out + part[:, g] * scale[g]
        return out.to(out_dtype).reshape(*lead, n)
    xf = x2.to(torch.float32)
    xg = xf.reshape(-1, groups, gs)
    if qt.bits == 4:
        codes = unpack_int4(qt.q, gs).to(torch.int32) + 8
        wg = codes.reshape(groups, gs, n).to(torch.float32)
        part = torch.einsum("bgk,gkn->bgn", xg, wg) - 8.0 * xg.sum(dim=2, keepdim=True)
    else:
        wg = qt.q.reshape(groups, gs, n).to(torch.float32)
        part = torch.einsum("bgk,gkn->bgn", xg, wg)
    out = (part * scale[None]).sum(dim=1)
    return out.to(out_dtype).reshape(*lead, n)


def _gather(x2: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x2[:, index], a zero where index == K: the plain version of the
    masked steps' x layout."""
    return torch.nn.functional.pad(x2, (0, 1)).index_select(1, index.to(x2.device).long())


def quantize_rows(x2: torch.Tensor, index: Optional[torch.Tensor] = None):
    """W4A8's activations, x [B, K] -> (int8 [B, K], f32 scales [B, 1]):
    quantize_activation's function, by the row kernel
    (csrc/quant_matmul.cu::quantize_rows_kernel, bitwise the same codes and
    scales) for a tensor on the card, by quantize_activation itself (the
    plain version) for one on the CPU. With `index` (stage_index) the codes
    come out in the masked steps' layout, [B, len(index)]."""
    global quantize_launches
    if not x2.is_cuda:
        q, sx = quantize_activation(x2)
        return (q if index is None else _gather(q, index)), sx
    from tpuserve_torch import kernels

    if x2.dtype not in (torch.bfloat16, torch.float32):
        x2 = x2.to(torch.float32)  # exact, as quantize_activation's cast
    x2 = x2.contiguous()
    b, k = x2.shape
    w = k if index is None else index.numel()
    q = torch.empty((b, w), dtype=torch.int8, device=x2.device)
    sx = torch.empty((b, 1), dtype=torch.float32, device=x2.device)
    rc = kernels.lib().tpuserve_quantize_rows(
        x2.data_ptr(), q.data_ptr(), sx.data_ptr(), b, k, int(x2.dtype == torch.bfloat16),
        0 if index is None else index.data_ptr(), w, kernels.stream_of(x2))
    kernels.check(rc, "quantize_rows")
    quantize_launches += 1
    return q, sx


def split_x_plain(x2: torch.Tensor) -> torch.Tensor:
    """f32 x [..] -> bf16 [3, ..]: hi, mid, lo, each the top 16 bits of what
    is left of x (csrc/quant_matmul.cu::split_x_kernel, bitwise). Every
    difference is exact in f32, so hi + mid + lo == x for every finite x
    of magnitude >= 2^-110 and for zeros (a zero difference keeps x's sign,
    so -0.0 stays -0.0); below 2^-110 the bits under bf16's finest step,
    2^-133, are dropped."""
    sign = x2.view(torch.int32) & -(2 ** 31)
    w = x2
    pieces = []
    for _ in range(PIECES):
        t = (w.view(torch.int32) & -65536).view(torch.float32)     # & 0xFFFF0000
        pieces.append(t.to(torch.bfloat16))              # exact: its low 16 bits are 0
        rest = w - t
        w = torch.where(rest == 0, sign.view(torch.float32), rest)
    return torch.stack(pieces)


def split_x(x2: torch.Tensor, index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 x [B, K] as three bf16 pieces [3, B, K] (split_x_plain), or with
    `index` (stage_index) each piece in the masked steps' layout, [3, B,
    len(index)]: csrc/quant_matmul.cu::split_x_kernel for a tensor on the
    card, split_x_plain (and `_gather`) for one on the CPU."""
    global split_launches
    if not x2.is_cuda:
        pieces = split_x_plain(x2)
        return pieces if index is None else torch.stack([_gather(t, index) for t in pieces])
    from tpuserve_torch import kernels

    b, k = x2.shape
    w = k if index is None else index.numel()
    out = torch.empty((PIECES, b, w), dtype=torch.bfloat16, device=x2.device)
    rc = kernels.lib().tpuserve_split_x(x2.data_ptr(), 0 if index is None else index.data_ptr(),
                                        out.data_ptr(), b, k, w, kernels.stream_of(x2))
    kernels.check(rc, "split_x")
    split_launches += 1
    return out


def stage_x(x2: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """bf16 x [B, K] in the masked steps' layout, [B, len(index)] (x2[:,
    index], a zero where index == K): csrc/quant_matmul.cu::stage_x_kernel
    for a tensor on the card, `_gather` (its plain version) for one on the
    CPU."""
    global stage_launches
    if not x2.is_cuda:
        return _gather(x2, index)
    from tpuserve_torch import kernels

    b, k = x2.shape
    out = torch.empty((b, index.numel()), dtype=x2.dtype, device=x2.device)
    rc = kernels.lib().tpuserve_stage_x(x2.data_ptr(), index.data_ptr(), out.data_ptr(), b, k,
                                        index.numel(), kernels.stream_of(x2))
    kernels.check(rc, "stage_x")
    stage_launches += 1
    return out


def _check_launchable(x2: torch.Tensor, qt: QTensor) -> None:
    k, n = qt.orig_shape
    gs = _group_size(qt)
    if qt.q.device != x2.device or qt.scale.device != x2.device:
        raise ValueError("quant_matmul: x and the weight must be on the same device")
    if qt.bits == 4:
        if gs % 2 != 0:
            raise ValueError(f"quant_matmul kernel: int4 groups must be even, got {gs}")
        if qt.act_bits == 8:
            w4a8_route(gs)
        if qt.q.dtype != torch.uint8 or tuple(qt.q.shape) != (k // 2, n):
            raise ValueError("quant_matmul kernel: int4 weight must be uint8 [K/2, N]")
    elif qt.bits == 8:
        if qt.q.dtype != torch.int8 or tuple(qt.q.shape) != (k, n):
            raise ValueError("quant_matmul kernel: int8 weight must be int8 [K, N]")
    else:
        raise ValueError(f"quant_matmul kernel: unsupported bits {qt.bits}")
    if gs <= 0 or k % gs != 0:
        raise ValueError(f"cannot group K={k} by group_size={gs}")


# ---------------------------------------------------------------- bf16, Hopper
_BATCH_TILES = (16, 32, 64, 72, 128)  # wgmma N widths the bf16 kernel is built for
_A8_TILES = (16, 32, 64, 80, 128)     # and the int8 one (integer wgmma has no n72)
_STAGE_ROWS = 64       # weight rows a ring stage holds
_RING_BYTES = 232448 - 1024 - 256 - 2 * 8 * 8  # the ring's shared memory (hop::prepare)
_COUNTERS = {}         # device index -> int32 per-tile counters, zero between calls
_STAGE_X = {}          # (bits, K, gs, device) -> stage_index
_MAX_TILES = 1 << 16


def stage_plan(bits: int, k: int, gs: int):
    """The Hopper kernels' stages of K for int`bits` weights in groups of
    gs values (csrc/quant_matmul.cu::plan_stages): (gr, spg, total), either
    gr whole groups a stage where a group's weight rows (gs/2 int4, gs
    int8) fit in the 64 a stage holds, or spg stages (pieces of at most 64
    rows) a group; total stages."""
    rpg = gs // 2 if bits == 4 else gs
    groups = k // gs
    if rpg <= _STAGE_ROWS:
        gr = _STAGE_ROWS // rpg
        return gr, 1, -(-groups // gr)
    spg = -(-rpg // _STAGE_ROWS)
    return 1, spg, groups * spg


def odd_group(bits: int, gs: int) -> bool:
    """Whether the 64-row stage and the group's rows divide neither each
    other (int4 48, 80, 96, 112, 144, ...; int8 48, 80, 96, ...): the stages
    are then cut along the groups (stage_plan), counted in
    odd_group_launches."""
    rpg = gs // 2 if bits == 4 else gs
    return _STAGE_ROWS % rpg != 0 and rpg % _STAGE_ROWS != 0


def hopper_group_ok(bits: int, gs: int) -> bool:
    """Whether the Hopper kernels take this group size: any positive group,
    even for int4 weights (groups of no multiple of 16 values in masked
    steps)."""
    return gs > 0 and (bits != 4 or gs % 2 == 0)


def masked_group(gs: int, a8: bool = False) -> bool:
    """Whether a k-step (16 values for bf16 x, 32 for W4A8's int8 x) may
    cross the end of a group of gs values: the Hopper kernels then issue
    such a step once for each group it touches, the values of the others
    masked (csrc/quant_matmul.cu, the GS = -2 and A8_MASKED instances)."""
    return gs % (32 if a8 else 16) != 0


def bf16_route(bits: int, gs: int) -> str:
    """The kernel that serves bf16 activations for int`bits` weights in
    groups of `gs` values of K: "wgmma" (qmm_wgmma_kernel) for every group
    hopper_group_ok takes. Raises on any other."""
    if bits not in (4, 8) or not hopper_group_ok(bits, gs):
        raise ValueError(f"quant_matmul kernel: no kernel takes int{bits} groups of {gs}")
    return "wgmma"


def w4a8_route(gs: int) -> str:
    """The kernel that serves W4A8 (int4 weights, int8 x) in groups of gs:
    "wgmma" (qmm_a8_kernel, int8 wgmma) for every even group, as the JAX
    package takes every even int4 group. Raises on any other."""
    if gs > 0 and gs % 2 == 0:
        return "wgmma"
    raise ValueError(f"quant_matmul kernel: unsupported W4A8 group size {gs}")


def ring_stages(bits: int, k: int, gs: int, rows: int, nwg_n: int, pieces: int = 1) -> int:
    """Ring stages the kernel's shared memory holds (csrc/quant_matmul.cu::
    hop::prepare) for bf16 x in `pieces` pieces when a block covers `rows`
    batch rows with nwg_n column warpgroups: per stage the weight boxes,
    each piece's x boxes (int4 weights: two of rows * 128 bytes) and the
    scale boxes, rounded up to 1 KB; at most 8. The kernel refuses fewer
    than 2."""
    gr = stage_plan(bits, k, gs)[0]
    xbox = rows * 128
    stage = nwg_n * _STAGE_ROWS * 64 + pieces * (2 if bits == 4 else 1) * xbox + nwg_n * gr * 256
    return min(8, _RING_BYTES // (-(-stage // 1024) * 1024))


def hopper_plan(b: int, k: int, n: int, bits: int, sms: int, block_k: Optional[int] = None,
                gs: int = 128, a8: bool = False, pieces: int = 1):
    """The Hopper kernels' launch for x [b, k] and a [k, n] weight in groups
    of gs: (batch tile, column warpgroups, batch warpgroups, stages per
    split, splits). The batch tile is wgmma's N; one block covers up to 256
    rows, so the weights are read once for b <= 256. K splits (in the same
    launch) as far as the grid still fits one wave of one block per SM;
    `block_k` (the K range one block walks: a multiple of the stage's K, or
    of the group where the stages cut odd groups into pieces) sets the
    split instead. a8 (W4A8, qmm_a8_kernel): the int8 batch tiles, and a
    split ends only where a group does, so that every group's int32 sum is
    whole before its scale. pieces 3 (f32 x as three bf16 pieces): a stage
    holds three times x's boxes, so a block covers at most 128 rows (fewer
    where two stages of 128 would not fit) and the weights are read once
    for b <= 128."""
    tiles = _A8_TILES if a8 else _BATCH_TILES
    if pieces > 1:
        nwg_b, per = 1, min(b, 128)
        while per > 16 and ring_stages(bits, k, gs, next(t for t in tiles if t >= per), 2,
                                       pieces) < 2:
            per = -(-per // 2)
    elif b <= 128:
        nwg_b, per = 1, b
    else:
        nwg_b, per = 2, -(-min(b, 256) // 2)
    bt = next(t for t in tiles if t >= per)
    nwg_n = 2 if nwg_b == 1 else 1
    gr, spg, total = stage_plan(bits, k, gs)
    if block_k is not None:
        if spg == 1:                      # gr whole groups a stage
            unit, unit_stages = gr * gs, 1
        elif not odd_group(bits, gs):     # every stage 64 rows of one group
            unit, unit_stages = _STAGE_ROWS * (2 if bits == 4 else 1), 1
        else:                             # a group's spg pieces
            unit, unit_stages = gs, spg
        if block_k <= 0 or block_k % unit:
            raise ValueError(f"quant_matmul: block_k {block_k} is not a multiple of {unit}")
        sps = min(total, block_k // unit * unit_stages)
    else:
        n_tiles = -(-n // (64 * nwg_n)) * -(-b // (bt * nwg_b))
        # one wave: a block fills an SM's shared memory
        want = max(1, min(total, sms // n_tiles))
        sps = -(-total // want)
    if a8 and spg > 1:
        sps = -(-sps // spg) * spg
    return bt, nwg_n, nwg_b, sps, -(-total // sps)


def _counters(device) -> torch.Tensor:
    idx = torch.device(device).index or 0
    if idx not in _COUNTERS:
        _COUNTERS[idx] = torch.zeros(_MAX_TILES, dtype=torch.int32, device=device)
    return _COUNTERS[idx]


def stage_x_index(bits: int, k: int, gs: int) -> torch.Tensor:
    """The x layout of the masked steps: for every x position of every
    stage (stage_plan's), the K value it holds, or k for a zero. A stage
    has 128 positions, two boxes of 64 (int8 weights: one box of 64): whole
    groups' values in order from position 0, or a piece's values that meet
    its low nibbles from 0 and (int4) its high ones from 64. So every box
    starts 16 bytes aligned, as TMA reads it, wherever the stage starts in
    K; the kernel reads the values in its own order."""
    rpg = gs // 2 if bits == 4 else gs
    gr, spg, total = stage_plan(bits, k, gs)
    idx = torch.full((total, 128 if bits == 4 else 64), k, dtype=torch.long)
    if spg == 1:
        span = gr * gs
        ks = torch.arange(total)[:, None] * span + torch.arange(span)[None]
        idx[:, :span] = torch.where(ks < k, ks, k)
    else:
        t = torch.arange(total)[:, None]
        r = torch.arange(_STAGE_ROWS)[None]
        grp, pc = t // spg, t % spg
        valid = r < rpg - pc * _STAGE_ROWS
        lo = grp * gs + pc * _STAGE_ROWS + r
        idx[:, :_STAGE_ROWS] = torch.where(valid, lo, k)
        if bits == 4:
            idx[:, _STAGE_ROWS:] = torch.where(valid, lo + rpg, k)
    return idx.reshape(-1)


def stage_index(bits: int, k: int, gs: int, device) -> torch.Tensor:
    """stage_x_index as int32 on `device`, made once a shape."""
    key = (bits, k, gs, str(device))
    if key not in _STAGE_X:
        _STAGE_X[key] = stage_x_index(bits, k, gs).to(torch.int32).to(device)
    return _STAGE_X[key]


def _launch_hopper(x2, q, scale, out, qt, gs, block_k, row_scale=None, pieces=1):
    """qmm_wgmma_kernel (bf16 x into bf16 out; pieces 3: f32 x as split_x's
    three bf16 pieces [3, B, ..] into f32 out), or qmm_a8_kernel (row_scale
    given: W4A8, int8 x, its row scales multiplied into the f32 or bf16
    out), K split in the same launch; x [B, K], or for a masked group
    already in the masked steps' layout (stage_x, quantize_rows or split_x
    with stage_index)."""
    a8 = row_scale is not None
    from tpuserve_torch import kernels

    b, k = out.shape[0], qt.orig_shape[0]
    n_pad = out.shape[1]
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # TMA reads x rows from a 16-byte aligned base
    if q.data_ptr() % 16 or scale.data_ptr() % 16:
        q, scale = q.clone(), scale.clone()
    bt, nwg_n, nwg_b, sps, splits = hopper_plan(b, k, n_pad, qt.bits, kernels.sm_count(x2.device),
                                                block_k, gs, a8, pieces)
    ws = cnt = None
    if splits > 1:
        if -(-n_pad // (64 * nwg_n)) * -(-b // (bt * nwg_b)) > _MAX_TILES:
            raise ValueError("quant_matmul kernel: too many output tiles to split K")
        ws = torch.empty((splits, b, n_pad), dtype=torch.float32, device=x2.device)
        cnt = _counters(x2.device)
    ptrs = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            0 if ws is None else ws.data_ptr(), 0 if cnt is None else cnt.data_ptr())
    if a8:
        rc = kernels.lib().tpuserve_quant_matmul_a8(
            *ptrs[:3], row_scale.data_ptr(), *ptrs[3:], b, k, n_pad, gs,
            int(out.dtype == torch.bfloat16), bt, nwg_n, nwg_b, sps, splits,
            kernels.stream_of(x2))
    else:
        rc = kernels.lib().tpuserve_quant_matmul_bf16(
            *ptrs, b, k, n_pad, gs, qt.bits, bt, nwg_n, nwg_b, sps, splits, pieces,
            kernels.stream_of(x2))
    kernels.check(rc, "quant_matmul")


def quant_matmul(x: torch.Tensor, qt: QTensor, *, out_dtype=None,
                 block_k: Optional[int] = None) -> torch.Tensor:
    """x [.., K] @ dequant(qt) [K, N] via the fused kernel (CUDA tensors) or
    its plain version (CPU tensors). `block_k` (as in the JAX package's
    quant_matmul) is the K range one block walks, which sets the K split;
    None lets the wrapper choose. It changes no value beyond the order of
    f32 sums, and the plain version ignores it."""
    global launches, group_route_launches, odd_group_launches, w4a8_launches
    global w4a8_route_launches, f32_launches
    if not x.is_cuda:
        return quant_matmul_plain(x, qt, out_dtype=out_dtype)
    k, n = qt.orig_shape
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != K {k}")
    lead = x.shape[:-1]
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    b = x2.shape[0]
    _check_launchable(x2, qt)
    act_int8 = qt.bits == 4 and qt.act_bits == 8
    gs = _group_size(qt)
    if not act_int8 and x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul kernel: unsupported activation dtype {x2.dtype}")
    masked = masked_group(gs, act_int8)
    index = stage_index(qt.bits, k, gs, x2.device) if masked else None
    if act_int8:
        x2, sx = quantize_rows(x2, index)
    x2 = x2.contiguous()
    q, scale = qt.q.contiguous(), qt.scale.to(torch.float32).contiguous()
    n_pad = -(-n // 16) * 16  # the kernels load weight rows in 16-byte pieces
    if n_pad != n:
        q = torch.nn.functional.pad(q, (0, n_pad - n))
        scale = torch.nn.functional.pad(scale, (0, n_pad - n))
    if act_int8:
        # W4A8 on int8 wgmma writes out_dtype's bf16 itself, the row scale in
        out = torch.empty((b, n_pad), dtype=torch.bfloat16 if out_dtype == torch.bfloat16
                          else torch.float32, device=x2.device)
        _launch_hopper(x2, q, scale, out, qt, gs, block_k, sx)
        if masked:
            w4a8_route_launches += 1
        else:
            w4a8_launches += 1
    elif x2.dtype == torch.bfloat16:
        out = torch.empty((b, n_pad), dtype=torch.bfloat16, device=x2.device)
        _launch_hopper(stage_x(x2, index) if masked else x2, q, scale, out, qt, gs, block_k)
        if masked:
            group_route_launches += 1
        elif odd_group(qt.bits, gs):
            odd_group_launches += 1
    else:
        # f32 x: three bf16 pieces on the same kernel, f32 out
        out = torch.empty((b, n_pad), dtype=torch.float32, device=x2.device)
        _launch_hopper(split_x(x2, index), q, scale, out, qt, gs, block_k, pieces=PIECES)
        f32_launches += 1
    launches += 1
    if n_pad != n:
        out = out[:, :n]
    return out.to(out_dtype).reshape(*lead, n)
