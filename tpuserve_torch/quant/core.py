"""Weight-only quantization: symmetric INT8 and packed INT4 with group-wise
scales (PyTorch port of tpuserve/quant/core.py).

Representation, byte-compatible with the JAX package:
- INT8: values stored as int8 [K, N]; scales f32 [K/gs, N].
- INT4: two nibbles packed per uint8 along K -> [K//2, N]. Nibble layout is
  **split-half per group**: within each scale group of gs rows, packed row
  r holds element r in the low nibble and element r + gs/2 in the high
  nibble (offset-8 encoding, values in [-8, 7]). The CUDA kernel unpacks a
  group into two contiguous halves that pair with the matching halves of x.

`qmatmul` routes to the fused dequant+matmul kernel
(tpuserve_torch/ops/quant_matmul.py), which runs its CUDA kernel for tensors
on the card and its plain PyTorch version for tensors on the CPU, or under
TPUSERVE_QMATMUL=xla to dequantize-then-matmul.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass
class QTensor:
    """A quantized 2-D weight [K, N] (contraction dim first).

    `act_bits` = 8 requests dynamic per-token INT8 activation quantization
    at matmul time (W8A8, or W4A8 through the fused kernel); 0 = bf16
    activations. `act_fp8` rounds activations through float8 e4m3 first.
    """

    q: torch.Tensor      # int8 [K, N] or uint8 [K//2, N] (packed int4)
    scale: torch.Tensor  # f32 [num_groups, N]
    bits: int
    group_size: int      # along K; 0 means one group (per-channel only)
    orig_shape: Tuple[int, int]
    act_bits: int = 0
    act_fp8: bool = False

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, q=self.q.to(device), scale=self.scale.to(device))


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with c taken in x's dtype and one IEEE division per element, as
    JAX divides an array by a Python scalar. (On CUDA, PyTorch divides by a
    Python scalar as a multiply by its reciprocal, which can land an ulp
    away and tip a quantizer's rounding; a bf16 x would also see c at full
    precision, where JAX rounds it to bf16.)"""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _group_count(k: int, group_size: int) -> int:
    if group_size <= 0 or group_size >= k:
        return 1
    if k % group_size != 0:
        raise ValueError(f"contraction dim {k} not divisible by group_size {group_size}")
    return k // group_size


def quantize(w: torch.Tensor, bits: int = 8, group_size: int = 128,
             clip_search: Optional[bool] = None) -> QTensor:
    """Symmetric weight quantization of a [K, N] matrix with per-(group,
    column) scales. clip_search (default: on for int4, off for int8)
    grid-searches a per-(group, column) clip ratio minimizing the weight
    reconstruction error, as the JAX package does."""
    w = w.to(torch.float32)
    if w.dim() != 2:
        raise ValueError(f"quantize expects a 2-D weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    groups = _group_count(k, group_size)
    gs = k // groups
    wg = w.reshape(groups, gs, n)
    qmax = {8: 127.0, 4: 7.0}[bits]
    absmax = wg.abs().amax(dim=1, keepdim=True)  # [groups, 1, n]
    if clip_search is None:
        clip_search = bits <= 4
    if clip_search:
        cands = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7)
        errs = []
        for a in cands:
            s = torch.clamp_min(true_div(absmax * a, qmax), 1e-8)
            qv = torch.clamp(torch.round(wg / s), -qmax - 1, qmax)
            errs.append(((qv * s - wg) ** 2).sum(dim=1, keepdim=True))
        best = torch.argmin(torch.stack(errs), dim=0)  # [groups, 1, n]
        alpha = torch.tensor(cands, dtype=torch.float32, device=w.device)[best]
        scale = torch.clamp_min(true_div(absmax * alpha, qmax), 1e-8)
    else:
        scale = torch.clamp_min(true_div(absmax, qmax), 1e-8)
    q = torch.clamp(torch.round(wg / scale), -qmax - 1, qmax).to(torch.int8)
    q = q.reshape(k, n)
    scale = scale.reshape(groups, n)
    if bits == 4:
        q = pack_int4(q, gs)
    return QTensor(q=q, scale=scale, bits=bits, group_size=gs if groups > 1 else 0,
                   orig_shape=(k, n))


def pack_int4(q: torch.Tensor, gs: int) -> torch.Tensor:
    """int8 codes [K, N] in [-8, 7] -> packed uint8 [K//2, N], split-half
    per group (inverse of `unpack_int4`)."""
    k, n = q.shape
    if gs % 2 != 0:
        raise ValueError("INT4 packing requires an even group size")
    groups = k // gs
    un = (q.to(torch.int32) + 8).to(torch.uint8)  # offset-8 -> [0, 15]
    ug = un.reshape(groups, gs, n)
    lo = ug[:, : gs // 2, :]
    hi = ug[:, gs // 2:, :]
    return (lo | (hi << 4)).reshape(k // 2, n).contiguous()


def unpack_int4(packed: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """uint8 [K//2, N] -> int8 [K, N] (inverse of the split-half-per-group
    pack). `group_size` is rows of the *unpacked* group; 0 = one group."""
    k2, n = packed.shape
    k = 2 * k2
    gs = group_size if group_size > 0 else k
    groups = k // gs
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    lo = lo.reshape(groups, gs // 2, n)
    hi = hi.reshape(groups, gs // 2, n)
    return torch.cat([lo, hi], dim=1).reshape(k, n)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    k, n = qt.orig_shape
    q = unpack_int4(qt.q, qt.group_size) if qt.bits == 4 else qt.q
    groups = qt.scale.shape[0]
    gs = k // groups
    deq = q.reshape(groups, gs, n).to(torch.float32) * qt.scale.float()[:, None, :]
    return deq.reshape(k, n).to(dtype)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric INT8: x [.., K] -> (int8 values,
    f32 scales [.., 1])."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(true_div(absmax, 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


# W8A8 contractions by path: torch._int_mm on the card, float64 where
# _int_mm does not take the shape or the tensors lie on the CPU
w8a8_int_mm_calls = 0
w8a8_float64_calls = 0


def int_mm_rows(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """torch._int_mm(xq [B, K], q [K, N]) -> int32 [B, N], the rows padded
    with zeros to 17 where B <= 16 (_int_mm takes more than 16 rows); K and
    N must be multiples of 8. On the card q in K-major strides (q.t()
    contiguous, as quantize_param_tree stores W8A8 codes) takes _int_mm's
    fast layout; row-major codes are about ten times slower there."""
    b = xq.shape[0]
    if b <= 16:
        xq = torch.cat([xq, xq.new_zeros((17 - b, xq.shape[1]))])
    return torch._int_mm(xq, q)[:b]


def _w8a8_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Dynamic-INT8 activations x INT8 weights, scales applied on the f32
    output. Requires per-channel weight scales (group_size 0). The JAX
    package leaves this path to XLA, so it has no kernel. On the card x is
    quantized by the row kernel (ops.quant_matmul.quantize_rows, bitwise
    quantize_activation) and the integer contraction is torch._int_mm
    (int_mm_rows) where K and N are multiples of 8, as _int_mm needs;
    elsewhere, and on the CPU (the plain version), it runs in float64,
    which is exact here (|sum| < 2^53). Both give the same int32 sums, so
    the same bits; each path is counted (w8a8_int_mm_calls,
    w8a8_float64_calls)."""
    global w8a8_int_mm_calls, w8a8_float64_calls
    if qt.bits != 8 or qt.group_size != 0:
        raise ValueError(
            "int8 activations require int8 weights with per-channel scales (group_size=0)")
    k, n = qt.q.shape
    if x.is_cuda and k % 8 == 0 and n % 8 == 0:
        from tpuserve_torch.ops.quant_matmul import quantize_rows

        xq, sx = quantize_rows(x.reshape(-1, k))
        acc = int_mm_rows(xq, qt.q)
        sx = sx.reshape(*x.shape[:-1], 1)
        acc = acc.reshape(*x.shape[:-1], n)
        w8a8_int_mm_calls += 1
    else:
        xq, sx = quantize_activation(x)
        acc = torch.matmul(xq.to(torch.float64), qt.q.to(torch.float64))
        w8a8_float64_calls += 1
    out = acc.to(torch.float32) * sx * qt.scale[0][None, :].to(torch.float32)
    return out.to(x.dtype)


def _w4a8_matmul_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Reference for INT4 weights x dynamic-INT8 activations: per-group
    integer contraction (exact in float64) so the (group, column) weight
    scales apply exactly."""
    k, n = qt.orig_shape
    lead = x.shape[:-1]
    xq, sx = quantize_activation(x.reshape(-1, k))
    w = unpack_int4(qt.q, qt.group_size)
    groups = qt.scale.shape[0]
    gs = k // groups
    xg = xq.reshape(-1, groups, gs).to(torch.float64)
    wg = w.reshape(groups, gs, n).to(torch.float64)
    acc = torch.einsum("tgk,gkn->tgn", xg, wg)
    out = (acc.to(torch.float32) * qt.scale.float()[None, :, :]).sum(dim=1)
    out = out * sx
    return out.to(x.dtype).reshape(*lead, n)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """Round activations through float8 e4m3 (dynamic per-token scale into
    the e4m3 range, round, rescale). Returns bf16 carrying fp8-resolution
    values."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = true_div(torch.clamp_min(absmax, 1e-8), 448.0)  # e4m3 max normal
    x8 = (xf / scale).to(torch.float8_e4m3fn)
    return (x8.to(torch.float32) * scale).to(torch.bfloat16)


def qmatmul_mode() -> str:
    """TPUSERVE_QMATMUL, read per call as the JAX package reads it: "xla"
    sends qmatmul to dequantize-then-matmul; anything else (default
    "pallas") to the fused kernel."""
    return os.environ.get("TPUSERVE_QMATMUL", "pallas").lower()


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x [.., K] @ dequant(qt) [K, N] -> [.., N].

    W8A8 (int8 weights, act_bits 8) is plain PyTorch, as it is plain XLA in
    the JAX package. Everything else goes through the fused kernel
    (`ops.quant_matmul`): its CUDA kernel for a tensor on the card, its
    plain version for a tensor on the CPU. Under TPUSERVE_QMATMUL=xla, on
    either device, it takes the JAX qmatmul's other branches instead: W4A8
    through `_w4a8_matmul_ref`, the rest as `dequantize` to bf16 (f32 for f32
    activations) and one `torch.matmul` with f32 accumulation, cast to x's
    dtype."""
    from tpuserve_torch.ops.quant_matmul import quant_matmul

    xla = qmatmul_mode() == "xla"
    if qt.act_bits == 8:
        if qt.bits == 8:
            return _w8a8_matmul(x, qt)
        return _w4a8_matmul_ref(x, qt) if xla else quant_matmul(x, qt)
    if qt.act_fp8:
        x = fp8_round(x)
    if not xla:
        return quant_matmul(x, qt)
    w = dequantize(qt, dtype=torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32)
    return torch.matmul(x, w.to(x.dtype))


# ------------------------------------------------------------------ experts
@dataclasses.dataclass
class QExperts:
    """A stack of E quantized expert weights [E, K, N] (MoE layers), stored
    stacked as the JAX package stores them. `expert(e)` hands one expert to
    every 2-D path (the quant-matmul kernel, W8A8, fp8 rounding) as an
    ordinary QTensor whose q and scale are views of the stack, no copy."""

    q: torch.Tensor      # int8 [E, K, N] or uint8 [E, K//2, N] (packed int4)
    scale: torch.Tensor  # f32 [E, groups, N]
    bits: int
    group_size: int
    orig_shape: Tuple[int, int, int]  # (E, K, N)
    act_bits: int = 0
    act_fp8: bool = False

    @property
    def n_experts(self) -> int:
        return self.orig_shape[0]

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QExperts":
        return dataclasses.replace(self, q=self.q.to(device), scale=self.scale.to(device))

    def expert(self, e: int) -> QTensor:
        return QTensor(q=self.q[e], scale=self.scale[e], bits=self.bits,
                       group_size=self.group_size, orig_shape=self.orig_shape[1:],
                       act_bits=self.act_bits, act_fp8=self.act_fp8)


def quantize_experts(w: torch.Tensor, bits: int = 8, group_size: int = 128,
                     clip_search: Optional[bool] = None) -> QExperts:
    """Quantize a stacked expert weight [E, K, N]: each expert on its own
    (its own clip search and scales), the results stacked."""
    if w.dim() != 3:
        raise ValueError(f"quantize_experts expects [E, K, N], got {tuple(w.shape)}")
    qts = [quantize(w[e], bits=bits, group_size=group_size, clip_search=clip_search)
           for e in range(w.shape[0])]
    return QExperts(q=torch.stack([t.q for t in qts]), scale=torch.stack([t.scale for t in qts]),
                    bits=bits, group_size=qts[0].group_size, orig_shape=tuple(w.shape))


def quantize_param_tree(
    params: Dict[str, torch.Tensor],
    bits: int,
    group_size: int = 128,
    predicate=None,
    act_bits: int = 0,
    act_fp8: bool = False,
) -> Dict[str, object]:
    """Quantize every eligible 2-D weight and stacked 3-D MoE expert weight
    in a flat param dict (see the JAX package for the selection rules)."""
    if act_bits == 8:
        if bits not in (4, 8):
            raise ValueError("int8 activations require int8 or int4 weights")
        if act_fp8:
            raise ValueError("choose one of int8 or fp8 activations")
        if bits == 8:
            group_size = 0  # W8A8: scale must factorize per column

    def default_pred(name: str, arr) -> bool:
        if arr.dim() not in (2, 3):
            return False
        k = arr.shape[-2]
        if group_size > 0 and k % group_size != 0 and k > group_size:
            return False
        if bits == 4 and k % 2 != 0:
            return False
        lname = name.lower()
        if arr.dim() == 3:  # stacked MoE experts [E, K, N]
            return "moe" in lname or "expert" in lname
        return any(t in lname for t in ("kernel", "weight", "w_", "proj", "embed_out"))

    pred = predicate or default_pred
    out: Dict[str, object] = {}
    for name, arr in params.items():
        if not pred(name, arr):
            out[name] = arr
            continue
        k = arr.shape[-2]
        gs = group_size if (group_size > 0 and k % group_size == 0 and k > group_size) else 0
        qt = (quantize_experts if arr.dim() == 3 else quantize)(arr, bits=bits, group_size=gs)
        if act_bits or act_fp8:
            qt = dataclasses.replace(qt, act_bits=act_bits, act_fp8=act_fp8)
        if act_bits == 8 and bits == 8:
            # W8A8 codes in K-major strides (same shape and values), each
            # expert's too: torch._int_mm's fast layout on the card
            qt.q = qt.q.transpose(-1, -2).contiguous().transpose(-1, -2)
        out[name] = qt
    return out
