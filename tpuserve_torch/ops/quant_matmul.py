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
- W4A8 (int4 weights, act_bits 8): x is quantized to int8 per row, the
  per-group dots are integer with the -8 fold in int32, and the per-row
  activation scale multiplies the f32 output.

bf16 activations take the Hopper kernel where its stages tile the group
(`hopper_group_ok`); any other group (48, 80, 96, 112, ...) takes the
CUDA-core kernel on x cast to f32, the same function (`bf16_route`, chosen
by shape before the launch, counted in `group_route_launches`).

Leading dims of x are flattened into the batch and restored.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpuserve_torch.quant.core import QTensor, quantize_activation, unpack_int4

launches = 0  # CUDA kernel launches (the plain version does not count)
# of those, bf16 activations served by the CUDA-core kernel on x cast to f32
# (the group sizes the Hopper kernel's stages cannot tile; see bf16_route)
group_route_launches = 0


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
        out = (part * scale[None]).sum(dim=1)
        return (out * sx).to(out_dtype).reshape(*lead, n)
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


def _check_launchable(x2: torch.Tensor, qt: QTensor) -> None:
    k, n = qt.orig_shape
    gs = _group_size(qt)
    if qt.q.device != x2.device or qt.scale.device != x2.device:
        raise ValueError("quant_matmul: x and the weight must be on the same device")
    if qt.bits == 4:
        if gs % 2 != 0:
            raise ValueError(f"quant_matmul kernel: int4 groups must be even, got {gs}")
        if qt.act_bits == 8:
            half = gs // 2
            if gs % 8 != 0 or half % min(half, 64) != 0:
                raise ValueError(f"quant_matmul kernel: unsupported W4A8 group size {gs}")
        if qt.q.dtype != torch.uint8 or tuple(qt.q.shape) != (k // 2, n):
            raise ValueError("quant_matmul kernel: int4 weight must be uint8 [K/2, N]")
    elif qt.bits == 8:
        if qt.q.dtype != torch.int8 or tuple(qt.q.shape) != (k, n):
            raise ValueError("quant_matmul kernel: int8 weight must be int8 [K, N]")
    else:
        raise ValueError(f"quant_matmul kernel: unsupported bits {qt.bits}")
    if gs <= 0 or k % gs != 0:
        raise ValueError(f"cannot group K={k} by group_size={gs}")


def _k_splits(b: int, n: int, groups: int, sms: int):
    """(groups per split, splits) of the CUDA-core kernels (f32 and W4A8
    activations): split K by whole scale groups until the grid holds ~4
    blocks per SM (64-column tiles of 16 or 64 rows, 4 warps)."""
    tiles = -(-n // 64) * -(-b // (16 if b <= 16 else 64))
    want = max(1, min(groups, -(-4 * sms // tiles)))
    gps = -(-groups // want)
    return gps, -(-groups // gps)


# ---------------------------------------------------------------- bf16, Hopper
_BATCH_TILES = (16, 32, 64, 72, 128)  # wgmma N widths the kernel is built for
_COUNTERS = {}         # device index -> int32 per-tile counters, zero between calls
_MAX_TILES = 1 << 16


def _stage_k(bits: int) -> int:
    """Values of K one ring stage of the Hopper kernel holds: 64 packed rows."""
    return 128 if bits == 4 else 64


def hopper_group_ok(bits: int, gs: int) -> bool:
    """Whether the Hopper kernel takes this group size: a multiple of 16 that
    divides, or is a multiple of, its stage's 128 (int4) or 64 (int8) values
    of K, so that every stage holds whole groups or lies in one."""
    sk = _stage_k(bits)
    return gs % 16 == 0 and (gs % sk == 0 or sk % gs == 0)


def bf16_route(bits: int, gs: int) -> str:
    """The kernel that serves bf16 activations for int`bits` weights in
    groups of `gs` values of K, chosen by shape before any launch: "wgmma"
    (qmm_wgmma_kernel) where hopper_group_ok, else "cuda_core"
    (qmm_f32_kernel on x cast to f32, the same function: bf16 values are
    exact in f32, and the kernel takes any group, int4 any even one).
    Raises on a group neither takes."""
    if bits not in (4, 8) or gs <= 0 or (bits == 4 and gs % 2):
        raise ValueError(f"quant_matmul kernel: no kernel takes int{bits} groups of {gs}")
    return "wgmma" if hopper_group_ok(bits, gs) else "cuda_core"


def hopper_plan(b: int, k: int, n: int, bits: int, sms: int, block_k: Optional[int] = None):
    """The Hopper kernel's launch for x [b, k] and a [k, n] weight:
    (batch tile, column warpgroups, batch warpgroups, stages per split,
    splits). The batch tile is wgmma's N; one block covers up to 256 rows,
    so the weights are read once for b <= 256. K splits (in the same
    launch) as far as the grid still fits one wave of one block per SM;
    `block_k` (the K range one block walks, a multiple of the stage) sets
    the split instead."""
    if b <= 128:
        nwg_b, per = 1, b
    else:
        nwg_b, per = 2, -(-min(b, 256) // 2)
    bt = next(t for t in _BATCH_TILES if t >= per)
    nwg_n = 2 if nwg_b == 1 else 1
    sk = _stage_k(bits)
    total = -(-k // sk)
    if block_k is not None:
        if block_k <= 0 or block_k % sk:
            raise ValueError(f"quant_matmul: block_k {block_k} is not a multiple of {sk}")
        sps = min(total, block_k // sk)
    else:
        tiles = -(-n // (64 * nwg_n)) * -(-b // (bt * nwg_b))
        # one wave: a block fills an SM's shared memory
        want = max(1, min(total, sms // tiles))
        sps = -(-total // want)
    return bt, nwg_n, nwg_b, sps, -(-total // sps)


def _counters(device) -> torch.Tensor:
    idx = torch.device(device).index or 0
    if idx not in _COUNTERS:
        _COUNTERS[idx] = torch.zeros(_MAX_TILES, dtype=torch.int32, device=device)
    return _COUNTERS[idx]


def _launch_hopper(x2, q, scale, out, qt, gs, block_k):
    from tpuserve_torch import kernels

    b, k = x2.shape
    n_pad = out.shape[1]
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # TMA reads x rows from a 16-byte aligned base
    if q.data_ptr() % 16 or scale.data_ptr() % 16:
        q, scale = q.clone(), scale.clone()
    bt, nwg_n, nwg_b, sps, splits = hopper_plan(b, k, n_pad, qt.bits, kernels.sm_count(x2.device),
                                                block_k)
    ws = cnt = None
    if splits > 1:
        if -(-n_pad // (64 * nwg_n)) * -(-b // (bt * nwg_b)) > _MAX_TILES:
            raise ValueError("quant_matmul kernel: too many output tiles to split K")
        ws = torch.empty((splits, b, n_pad), dtype=torch.float32, device=x2.device)
        cnt = _counters(x2.device)
    rc = kernels.lib().tpuserve_quant_matmul_bf16(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), 0 if cnt is None else cnt.data_ptr(),
        b, k, n_pad, gs, qt.bits, bt, nwg_n, nwg_b, sps, splits, kernels.stream_of(x2))
    kernels.check(rc, "quant_matmul")


def _launch_cuda_core(x2, q, scale, out, bits, gs, x_kind, block_k):
    """qmm_f32_kernel (x_kind 0, f32 x) or qmm_w4a8_kernel (x_kind 2), K
    split by whole scale groups into a workspace reduced in split order."""
    from tpuserve_torch import kernels

    b, k = x2.shape
    n_pad = out.shape[1]
    groups = k // gs
    if block_k is None:
        gps, splits = _k_splits(b, n_pad, groups, kernels.sm_count(x2.device))
    else:
        if block_k <= 0 or block_k % gs:
            raise ValueError(f"quant_matmul: block_k {block_k} is not a multiple of the "
                             f"group size {gs}")
        gps = min(groups, block_k // gs)
        splits = -(-groups // gps)
    ws = torch.empty((splits, b, n_pad), dtype=torch.float32, device=x2.device) \
        if splits > 1 else None
    rc = kernels.lib().tpuserve_quant_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, k, n_pad, gs, bits, x_kind, gps, splits, 0 if ws is None else ws.data_ptr(),
        kernels.stream_of(x2))
    kernels.check(rc, "quant_matmul")


def quant_matmul(x: torch.Tensor, qt: QTensor, *, out_dtype=None,
                 block_k: Optional[int] = None) -> torch.Tensor:
    """x [.., K] @ dequant(qt) [K, N] via the fused kernel (CUDA tensors) or
    its plain version (CPU tensors). `block_k` (as in the JAX package's
    quant_matmul) is the K range one block walks, which sets the K split;
    None lets the wrapper choose. It changes no value beyond the order of
    f32 sums, and the plain version ignores it."""
    global launches, group_route_launches
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
    sx = None
    if act_int8:
        x2, sx = quantize_activation(x2)
        x_kind = 2
    elif x2.dtype == torch.bfloat16:
        x_kind = 1
    elif x2.dtype == torch.float32:
        x_kind = 0
    else:
        raise ValueError(f"quant_matmul kernel: unsupported activation dtype {x2.dtype}")
    x2 = x2.contiguous()
    q, scale = qt.q.contiguous(), qt.scale.to(torch.float32).contiguous()
    n_pad = -(-n // 16) * 16  # the kernels load weight rows in 16-byte pieces
    if n_pad != n:
        q = torch.nn.functional.pad(q, (0, n_pad - n))
        scale = torch.nn.functional.pad(scale, (0, n_pad - n))
    gs = _group_size(qt)
    out = torch.empty((b, n_pad), dtype=torch.float32 if x_kind != 1 else torch.bfloat16,
                      device=x2.device)
    route = bf16_route(qt.bits, gs) if x_kind == 1 else "cuda_core"
    if route == "wgmma":
        _launch_hopper(x2, q, scale, out, qt, gs, block_k)
    elif x_kind == 1:   # a group the Hopper kernel's stages cannot tile
        out = torch.empty((b, n_pad), dtype=torch.float32, device=x2.device)
        _launch_cuda_core(x2.to(torch.float32), q, scale, out, qt.bits, gs, 0, block_k)
        group_route_launches += 1
    else:
        _launch_cuda_core(x2, q, scale, out, qt.bits, gs, x_kind, block_k)
    launches += 1
    if n_pad != n:
        out = out[:, :n]
    if act_int8:
        out = out * sx
    return out.to(out_dtype).reshape(*lead, n)
