"""Kernels of the int4 nibble-unpack microbenchmark (PyTorch port of the
Pallas kernels in scripts/unpack_microbench.py; run by
tpuserve_torch.scripts.unpack_microbench).

Every variant reads one int8 stream x [N, W2] in blocks of `blr` rows (a
multiple of 128 that divides N) and differs only in what it computes on a
block. q is int8 [M, W2], `seed` an integer added once a block. The output
is int64 [M, 128], exact:

- `stream_raw` (_k_stream_raw): out[0, 0] = sum of every byte of x +
  n_blocks * seed, the rest 0;
- `dot_raw` (_k_dot_raw): s[m, r] = q[m] . x[r];
- `unpack_cur` (_k_unpack_cur), `unpack_hi` (_k_unpack_hi), `unpack_i8`
  (_k_unpack_i8): s[m, r] = q[m] . lo_r + q[m] . hi_r - 8 * sum(q[m]),
  lo = b & 15 and hi = b >> 4 (arithmetic) of every byte b of row r, each
  reached by its own instruction mix (csrc/unpack_probes.cu); the three are
  equal, since b = 16 * hi + lo exactly.

The dot variants fold every row: out[m, c] = sum over rows r = c (mod
128) of s[m, r] + n_blocks * seed. The TPU kernels add s[:, :128] of each
block, which is the same function at 128-row blocks; at larger blocks their
rows past 128 feed nothing, where here every byte reaches the output.

For CUDA tensors each wrapper launches its kernel (one template in
csrc/unpack_probes.cu, see the note there); for CPU tensors it runs the
plain version, which follows the TPU kernel's body with exact integer dots.
"""

from __future__ import annotations

import torch

VARIANTS = ("stream_raw", "dot_raw", "unpack_cur", "unpack_hi", "unpack_i8")
launches = dict.fromkeys(VARIANTS, 0)   # kernel launches per variant

_FOLD = 128                # residues of the fold: the TPU's 128 output lanes
_CHUNK = 64                # bytes of a row the kernel reads per step
_KERNEL_M = (16, 32)       # query rows the kernel takes
_SMEM_Q = 200 * 1024       # q's bytes the kernel holds in shared memory
_PLAIN_ROWS = 16384        # rows of x the plain version widens at a time


def _check(x, q, blr: int):
    if x.dim() != 2 or q.dim() != 2 or x.dtype != torch.int8 or q.dtype != torch.int8:
        raise ValueError("unpack probes take int8 x [N, W2] and int8 q [M, W2]")
    n, w2 = x.shape
    if q.shape[1] != w2:
        raise ValueError(f"unpack probes: q {tuple(q.shape)} and x {tuple(x.shape)} differ in W2")
    if blr <= 0 or blr % _FOLD or n % blr:
        raise ValueError(f"unpack probes: blocks of {blr} rows must be a multiple of {_FOLD} "
                         f"that divides N={n}")


def unpack_probe_plain(variant: str, x, q, seed: int = 0, blr: int = 256) -> torch.Tensor:
    """The variant's function in plain PyTorch (any device), step for step
    as its TPU kernel's body, with exact dots (float64 sums of products
    below 2^53). Returns int64 [M, 128]."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown unpack probe {variant!r}; known: {', '.join(VARIANTS)}")
    _check(x, q, blr)
    n, _ = x.shape
    m = q.shape[0]
    n_blocks = n // blr
    out = torch.zeros((m, _FOLD), dtype=torch.int64, device=x.device)
    if variant == "stream_raw":
        out[0, 0] = x.sum(dtype=torch.int64) + n_blocks * int(seed)
        return out
    qd = q.to(torch.float64)
    qsum = q.to(torch.int64).sum(dim=1, keepdim=True)             # [M, 1]

    def dot(b):  # q . b for every row of b: [M, rows], exact
        return (qd @ b.to(torch.float64).T).to(torch.int64)

    for r0 in range(0, n, _PLAIN_ROWS):
        b = x[r0:r0 + _PLAIN_ROWS]
        if variant == "dot_raw":
            s = dot(b)
        elif variant == "unpack_cur":
            p32 = b.to(torch.int32)
            s = dot((p32 & 15).to(torch.int8)) + dot((p32 >> 4).to(torch.int8)) - 8 * qsum
        elif variant == "unpack_hi":
            h = (b.to(torch.int32) >> 4).to(torch.int8)
            d_b, d_h = dot(b), dot(h)
            s = d_b - 16 * d_h + d_h - 8 * qsum
        else:  # unpack_i8: the nibble ops at 8-bit width
            s = dot(b & 15) + dot(b >> 4) - 8 * qsum
        out += s.reshape(m, -1, _FOLD).sum(dim=1)
    return out + n_blocks * int(seed)


def _launch(variant: str, x, q, seed: int, blr: int) -> torch.Tensor:
    from tpuserve_torch import kernels

    n, w2 = x.shape
    m = q.shape[0]
    if m not in _KERNEL_M:
        raise ValueError(f"unpack probe kernel: M={m} query rows, takes {_KERNEL_M}")
    if w2 % _CHUNK or m * w2 > _SMEM_Q:
        raise ValueError(f"unpack probe kernel: W2={w2} must be a multiple of {_CHUNK} with "
                         f"M*W2 <= {_SMEM_Q}")
    if q.device != x.device or not (x.is_contiguous() and q.is_contiguous()):
        raise ValueError("unpack probe kernel: x and q must be contiguous on one device")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("unpack probe kernel: x and q must be 16-byte aligned")
    out = torch.zeros((m, _FOLD), dtype=torch.int64, device=x.device)
    rc = kernels.lib().tpuserve_unpack_probe(
        x.data_ptr(), q.data_ptr(), out.data_ptr(), n, w2, m, VARIANTS.index(variant),
        (n // blr) * int(seed), kernels.sm_count(x.device), kernels.stream_of(x))
    kernels.check(rc, f"unpack_probe {variant}")
    return out


def _probe(variant: str, x, q, seed: int, blr: int) -> torch.Tensor:
    _check(x, q, blr)
    if not x.is_cuda:
        return unpack_probe_plain(variant, x, q, seed, blr)
    out = _launch(variant, x, q, seed, blr)
    launches[variant] += 1
    return out


def stream_raw(x, q, seed: int = 0, blr: int = 256) -> torch.Tensor:
    """out[0, 0] = sum of every byte of x + n_blocks * seed (q is unread)."""
    return _probe("stream_raw", x, q, seed, blr)


def dot_raw(x, q, seed: int = 0, blr: int = 256) -> torch.Tensor:
    """The raw bytes' dots with q, every row folded into 128 residues."""
    return _probe("dot_raw", x, q, seed, blr)


def unpack_cur(x, q, seed: int = 0, blr: int = 256) -> torch.Tensor:
    """The nibble dots, each byte widened to 32 bits, & 15 and >> 4, narrowed."""
    return _probe("unpack_cur", x, q, seed, blr)


def unpack_hi(x, q, seed: int = 0, blr: int = 256) -> torch.Tensor:
    """The nibble dots from the raw byte's dot and the high nibble's."""
    return _probe("unpack_hi", x, q, seed, blr)


def unpack_i8(x, q, seed: int = 0, blr: int = 256) -> torch.Tensor:
    """The nibble dots, nibbles cut four bytes an instruction."""
    return _probe("unpack_i8", x, q, seed, blr)


PROBES = {"stream_raw": stream_raw, "dot_raw": dot_raw, "unpack_cur": unpack_cur,
          "unpack_hi": unpack_hi, "unpack_i8": unpack_i8}
