"""GPTQ: calibrated, error-compensated weight quantization (PyTorch port of
tpuserve/quant/gptq.py).

Round-to-nearest quantizes each weight in isolation; GPTQ (Frantar et al.,
2022) minimizes the output error ||(W - Q) X||_F layer by layer: the rows of
W (the K axis) are quantized in order, and each row's rounding error is
propagated into the rows not yet quantized through the inverse Hessian
H^-1 = (X X^T + lambda I)^-1 of the layer's calibration activations.

The output is the port's `QTensor` (the same group scales and split-half
int4 packing as `quant.core.quantize`), so every serving path takes GPTQ
weights unchanged. LoRC (`lorc_factors`) adds a rank-r, Hessian-weighted
factorization of the residual, applied at serving time by
`models.llama._lorc`.

Everything runs in torch.float64 on the device of the weight (cuSOLVER on
the card, LAPACK on the CPU), in the JAX package's order: the row loop is
sequential, as the algorithm is (each group's scale comes from the
error-updated rows when the loop enters the group); only the work inside a
row is vectorised. On the card that loop launches a few kernels a row.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import torch

from tpuserve_torch.quant.core import QTensor, _group_count, dequantize, pack_int4, true_div

_CLIP = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7)  # quant.core's clip grid

log = logging.getLogger("tpuserve_torch.quant")


def _f64(x, device=None) -> torch.Tensor:
    """A float64 copy of a tensor or array on `device` (default: its own)."""
    t = torch.as_tensor(x)
    return t.to(device=device or t.device, dtype=torch.float64).clone()


def gptq_quantize(w, h, bits: int = 4, group_size: int = 128,
                  percdamp: float = 0.01, block: int = 128,
                  n_samples: Optional[int] = None,
                  act_order: bool = True) -> QTensor:
    """Quantize one [K, N] weight given the calibration Hessian H [K, K]
    (the sum over calibration tokens of x x^T). The QTensor lies on the
    weight's device.

    Group scales come from the error-updated rows when the row loop enters
    each group, with quant.core's clip search at 4 bits. act_order sorts the
    rows inside each group by descending Hessian diagonal (the group layout
    is unchanged). Inputs never activated are frozen to 0. `n_samples`
    below K (a rank-deficient H) shrinks H toward its diagonal by
    1 - n_samples / K, pulling the propagation toward round-to-nearest."""
    w = _f64(w)
    dev = w.device
    if w.dim() != 2:
        raise ValueError(f"gptq_quantize expects a 2-D weight, got {tuple(w.shape)}")
    k, n = w.shape
    h = _f64(h, dev)
    if tuple(h.shape) != (k, k):
        raise ValueError(f"Hessian shape {tuple(h.shape)} != ({k}, {k})")

    qmax = {8: 127.0, 4: 7.0}[bits]
    groups = _group_count(k, group_size)
    gs = k // groups

    # dead inputs (never activated in calibration): freeze to 0
    diag = torch.diagonal(h).clone()
    dead = diag <= 0
    idx = torch.nonzero(dead).flatten()
    h[idx, idx] = 1.0
    w[dead] = 0.0

    # act-order within each scale group: high-energy rows first
    perm = torch.arange(k, device=dev)
    if act_order:
        d0 = torch.diagonal(h).reshape(groups, gs)
        order = torch.argsort(-d0, dim=1, stable=True)
        perm = (order + torch.arange(groups, device=dev)[:, None] * gs).reshape(k)
        w = w[perm]
        h = h[perm][:, perm]
        diag = diag[perm]
        dead = dead[perm]

    if n_samples is not None and n_samples < k:
        alpha = 1.0 - n_samples / k
        h = (1.0 - alpha) * h + alpha * torch.diag(torch.diagonal(h))
    live = diag[~dead]
    damp = percdamp * float(live.mean()) if live.numel() else 1.0
    ar = torch.arange(k, device=dev)
    h[ar, ar] += max(damp, 1e-10)

    # U upper-triangular with U^T U = H^-1
    hinv = torch.linalg.inv(h)
    hinv = (hinv + hinv.T) / 2.0
    u = torch.linalg.cholesky(hinv).T

    q_codes = torch.zeros((k, n), dtype=torch.int8, device=dev)
    scale = torch.zeros((groups, n), dtype=torch.float64, device=dev)
    lo = -qmax - 1

    for i1 in range(0, k, block):
        i2 = min(i1 + block, k)
        err_blk = torch.zeros((i2 - i1, n), dtype=torch.float64, device=dev)
        for i in range(i1, i2):
            g = i // gs
            if i % gs == 0:
                # scale from the error-updated rows of this group; MSE clip
                # search on quant.core's grid at 4 bits (whole-group
                # tensor ops, once a group)
                wg = w[i:i + gs]
                absmax = wg.abs().amax(dim=0)
                best = torch.clamp_min(true_div(absmax, qmax), 1e-8)
                if bits <= 4:
                    best_err = None
                    for a in _CLIP:
                        s_c = torch.clamp_min(true_div(absmax * a, qmax), 1e-8)
                        qv = torch.clamp(torch.round(wg / s_c), lo, qmax)
                        err_c = ((qv * s_c - wg) ** 2).sum(dim=0)
                        if best_err is None:
                            best_err, best = err_c, s_c
                        else:
                            take = err_c < best_err
                            best_err = torch.where(take, err_c, best_err)
                            best = torch.where(take, s_c, best)
                scale[g] = best
            qi = torch.clamp(torch.round(w[i] / scale[g]), lo, qmax)
            q_codes[i] = qi.to(torch.int8)
            err = (w[i] - qi * scale[g]) / u[i, i]
            if i + 1 < i2:
                w[i + 1:i2] -= torch.outer(u[i, i + 1:i2], err)
            err_blk[i - i1] = err
        if i2 < k:
            w[i2:] -= u[i1:i2, i2:].T @ err_blk

    if act_order:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(k, device=dev)
        q_codes = q_codes[inv]  # back to the original row order

    q = pack_int4(q_codes, gs) if bits == 4 else q_codes
    return QTensor(q=q, scale=scale.to(torch.float32), bits=bits,
                   group_size=gs if groups > 1 else 0, orig_shape=(k, n))


def lorc_factors(w, qt: QTensor, h, r: int, dtype=None):
    """Rank-r Hessian-weighted factorization of the quantization residual
    (LoRC): minimize ||L^T (R - A B)||_F over A [K, r], B [r, N], where
    R = W - dq(Wq) and H = L L^T. Serving adds (x @ A) @ B
    (models.llama._lorc). Returns (A, B) in `dtype` (default bf16) on the
    weight's device. The SVD's signs are arbitrary: only A @ B is defined."""
    w = _f64(w)
    dev = w.device
    k = w.shape[0]
    resid = w - dequantize(qt.to(dev)).to(torch.float64)
    h = _f64(h, dev)
    d = torch.diagonal(h).clone()
    d[d <= 0] = 1.0
    ar = torch.arange(k, device=dev)
    h[ar, ar] = d * (1.0 + 1e-6)
    h += 1e-8 * float(d.mean()) * torch.eye(k, dtype=torch.float64, device=dev)
    l = torch.linalg.cholesky((h + h.T) / 2.0)
    u, s, vt = torch.linalg.svd(l.T @ resid, full_matrices=False)
    r = min(r, s.shape[0])
    # A = L^-T U_r S_r (a solve, not an inverse)
    a = torch.linalg.solve(l.T, u[:, :r] * s[:r][None, :])
    b = vt[:r, :]
    dt = torch.bfloat16 if dtype is None else dtype
    return a.to(dt), b.to(dt)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def collect_and_quantize_llama(params: Dict, p, tokens,
                               bits: int = 4, group_size: int = 128,
                               percdamp: float = 0.01,
                               quantize_lm_head: bool = True,
                               act_scale: bool = False,
                               lowrank_r: int = 0,
                               progress=None,
                               timings: Optional[List[Dict]] = None) -> Dict:
    """Sequentially GPTQ-quantize a Llama param dict on the device of its
    embedding.

    Layer by layer: (1) run the block forward in f32 with the current params
    (earlier layers already quantized), recording each projection's input
    Hessian through the `mm` hook; (2) optionally fold an AWQ-style
    activation scale; (3) GPTQ-quantize the layer's 2-D kernels, and with
    lowrank_r > 0 store LoRC factors under `{name}@lorc_a/_b`; (4) advance
    the activations through the quantized block (`_mm_direct`: a QTensor
    with f32 x takes the quant-matmul's f32 route). Then lm_head. `tokens`
    [B, L] int calibration batch.

    MoE expert stacks are left unquantized (callers quantize them by RTN).
    A warning is logged below 2x the largest contraction dim of tokens.
    `timings`, if given, receives one dict a layer (and one for lm_head)
    with the seconds of collection, GPTQ and LoRC (synchronized on the
    card)."""
    from tpuserve_torch.models import llama as L
    from tpuserve_torch.models.layers import rms_norm

    dev = params["embed/weight"].device
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
    b, seq = tokens.shape
    n_samples = b * seq
    k_max = max(p.dim, p.ffn_dim, p.n_heads * p.head_dim)
    if n_samples < 2 * k_max:
        log.warning(
            "gptq: %d calibration tokens < 2x max contraction dim %d — "
            "Hessians are under-determined; expect RTN-level (not better) "
            "accuracy. Provide a larger calibration sample.",
            n_samples, k_max)
    x = params["embed/weight"][tokens].to(torch.float32)
    positions = torch.arange(seq, device=dev)[None, :]
    cos, sin = L.rope_cos_sin(positions, p.head_dim, p.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    mask = positions[:, :, None] >= positions[:, None, :]

    def attn_fn(q, k_, v):
        q = L.apply_rope(q.reshape(b, seq, p.n_heads, p.head_dim), cos, sin)
        k_ = L.apply_rope(k_.reshape(b, seq, p.n_kv_heads, p.head_dim), cos, sin)
        v = v.reshape(b, seq, p.n_kv_heads, p.head_dim)
        return L._attention_prefill(q, k_, v, mask).reshape(b, seq, -1)

    out = dict(params)

    def hessian_of(inp) -> torch.Tensor:
        xf = inp.to(torch.float64).reshape(-1, inp.shape[-1])
        return xf.T @ xf

    def fold_act_scale(norm_name: str, kernel_names, hs: Dict) -> None:
        """AWQ-style activation-aware scaling: scale input row r of every
        kernel fed by `norm_name` by s_r = rms(x_r)^0.5 (geomean 1) and fold
        1/s into the norm's scale. Exact in real arithmetic; applied only
        when every consumer of the norm is among the recorded kernels."""
        ks = [kn for kn in kernel_names if kn in hs]
        if len(ks) != len(kernel_names) or not ks:
            return
        d = torch.sqrt(torch.clamp_min(torch.diagonal(hs[ks[0]]), 1e-12))
        s = torch.sqrt(d)
        s = s / torch.exp(torch.mean(torch.log(s)))
        sj = s.to(torch.float32)
        for kn in ks:
            out[kn] = (out[kn].to(torch.float32) * sj[:, None]).to(out[kn].dtype)
            hs[kn] = hs[kn] / torch.outer(s, s)
        sc = f"{norm_name}/scale"
        out[sc] = (out[sc].to(torch.float32) / sj).to(out[sc].dtype)

    def quantize_all(hs: Dict, tag: str, t_collect: float) -> None:
        t_gptq = t_lorc = 0.0
        for name, h in hs.items():
            w = out[name].to(torch.float32)
            t0 = time.monotonic()
            out[name] = gptq_quantize(w, h, bits=bits, group_size=group_size,
                                      percdamp=percdamp, n_samples=n_samples)
            _sync(dev)
            t1 = time.monotonic()
            if lowrank_r > 0:
                out[f"{name}@lorc_a"], out[f"{name}@lorc_b"] = lorc_factors(
                    w, out[name], h, lowrank_r)
                _sync(dev)
            t_gptq += t1 - t0
            t_lorc += time.monotonic() - t1
            if progress:
                progress(name)
        if timings is not None:
            timings.append({"layer": tag, "collect_s": t_collect, "gptq_s": t_gptq,
                            "lorc_s": t_lorc})

    for l in range(p.n_layers):
        pre = f"layers.{l}"
        hs: Dict[str, torch.Tensor] = {}

        def rec_mm(prm, name, inp):
            if name.endswith("kernel") and getattr(prm[name], "ndim", 0) == 2:
                hcur = hessian_of(inp)
                hs[name] = hs[name] + hcur if name in hs else hcur
            return L._mm_direct(prm, name, inp)

        t0 = time.monotonic()
        L._forward_block(out, pre, x, p, attn_fn, mm=rec_mm)
        if act_scale:
            fold_act_scale(f"{pre}/attn_norm",
                           (f"{pre}/wq/kernel", f"{pre}/wk/kernel", f"{pre}/wv/kernel"), hs)
            fold_act_scale(f"{pre}/mlp_norm", (f"{pre}/w_gate/kernel", f"{pre}/w_up/kernel"), hs)
        _sync(dev)
        t_collect = time.monotonic() - t0
        quantize_all(hs, pre, t_collect)
        t0 = time.monotonic()
        x = L._forward_block(out, pre, x, p, attn_fn, mm=L._mm_direct)
        _sync(dev)
        if timings is not None:
            timings[-1]["collect_s"] += time.monotonic() - t0  # the advance pass

    if quantize_lm_head and "lm_head/kernel" in out:
        t0 = time.monotonic()
        hs = {"lm_head/kernel": hessian_of(rms_norm(out, "final_norm", x, p.rms_eps))}
        if act_scale:
            fold_act_scale("final_norm", ("lm_head/kernel",), hs)
        _sync(dev)
        quantize_all(hs, "lm_head", time.monotonic() - t0)
    return out
