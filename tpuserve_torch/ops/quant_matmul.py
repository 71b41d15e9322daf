"""Fused dequant+matmul — the hot op of the quantized serving path
(PyTorch port of tpuserve/ops/quant_matmul.py).

Computes x[B, K] @ dequant(W)[K, N] where W is INT8 [K, N] or packed INT4
[K//2, N] with group-wise scales [G, N] (tpuserve_torch.quant.core
conventions). For a tensor on the card the wrapper launches the CUDA kernel
in csrc/quant_matmul.cu; for a tensor on the CPU it runs the kernel's plain
PyTorch version below, which repeats the kernel's arithmetic:

- int4: per group, the raw nibbles stay biased in [0, 15] and the -8 is
  folded as  x.lo + x.hi - 8*rowsum(x) , then scaled in f32;
- int8: per group  x.w , scaled in f32;
- W4A8 (int4 weights, act_bits 8): x is quantized to int8 per row, the
  per-group dots are integer with the -8 fold in int32, and the per-row
  activation scale multiplies the f32 output.

Leading dims of x are flattened into the batch and restored.
"""

from __future__ import annotations

import torch

from tpuserve_torch.quant.core import QTensor, quantize_activation, unpack_int4

launches = 0  # CUDA kernel launches (the plain version does not count)


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
        half = gs // 2
        chunk = min(half, 64)
        if gs % 8 != 0 or half % chunk != 0:
            raise ValueError(f"quant_matmul kernel: unsupported int4 group size {gs}")
        if qt.q.dtype != torch.uint8 or tuple(qt.q.shape) != (k // 2, n):
            raise ValueError("quant_matmul kernel: int4 weight must be uint8 [K/2, N]")
    elif qt.bits == 8:
        chunk = min(gs, 128)
        if gs % chunk != 0:
            raise ValueError(f"quant_matmul kernel: unsupported int8 group size {gs}")
        if qt.q.dtype != torch.int8 or tuple(qt.q.shape) != (k, n):
            raise ValueError("quant_matmul kernel: int8 weight must be int8 [K, N]")
    else:
        raise ValueError(f"quant_matmul kernel: unsupported bits {qt.bits}")
    if k % gs != 0:
        raise ValueError(f"cannot group K={k} by group_size={gs}")


def _k_splits(b: int, n: int, groups: int, sms: int, tensor_cores: bool):
    """(groups per split, splits): split K by whole scale groups until the
    grid fills the card: ~2 blocks per SM for the tensor-core kernel
    (128x64 tiles, 8 warps), ~4 for the CUDA-core one (64-column tiles of
    16 or 64 rows, 4 warps)."""
    if tensor_cores:
        tiles, per_sm = -(-n // 128) * -(-b // 64), 2
    else:
        tiles, per_sm = -(-n // 64) * -(-b // (16 if b <= 16 else 64)), 4
    want = max(1, min(groups, -(-per_sm * sms // tiles)))
    gps = -(-groups // want)
    return gps, -(-groups // gps)


def quant_matmul(x: torch.Tensor, qt: QTensor, *, out_dtype=None) -> torch.Tensor:
    """x [.., K] @ dequant(qt) [K, N] via the fused kernel (CUDA tensors) or
    its plain version (CPU tensors)."""
    global launches
    if not x.is_cuda:
        return quant_matmul_plain(x, qt, out_dtype=out_dtype)
    from tpuserve_torch import kernels

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
    n_pad = -(-n // 16) * 16  # the kernel loads weight rows in 16-byte pieces
    if n_pad != n:
        q = torch.nn.functional.pad(q, (0, n_pad - n))
        scale = torch.nn.functional.pad(scale, (0, n_pad - n))
    out = torch.empty((b, n_pad), dtype=torch.float32 if x_kind != 1 else torch.bfloat16,
                      device=x2.device)
    gs = _group_size(qt)
    tensor_cores = x_kind == 1  # bf16 activations multiply on the tensor cores
    if tensor_cores and gs % 16:
        raise ValueError(f"quant_matmul kernel: bf16 activations need group_size % 16 == 0, "
                         f"got {gs}")
    if tensor_cores and x2.data_ptr() % 16:
        x2 = x2.clone()  # the tensor-core kernel loads x rows in 16-byte pieces
    gps, splits = _k_splits(b, n_pad, k // gs, kernels.sm_count(x2.device), tensor_cores)
    ws = torch.empty((splits, b, n_pad), dtype=torch.float32, device=x2.device) \
        if splits > 1 else None
    rc = kernels.lib().tpuserve_quant_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, k, n_pad, gs, qt.bits, x_kind, gps, splits, 0 if ws is None else ws.data_ptr(),
        kernels.stream_of(x2))
    kernels.check(rc, "quant_matmul")
    launches += 1
    if n_pad != n:
        out = out[:, :n]
    if act_int8:
        out = out * sx
    return out.to(out_dtype).reshape(*lead, n)
