"""Each CUDA kernel of tpuserve_torch against its plain PyTorch version, on
the card. Every test here is marked `gpu` and skips without a card.

This file imports torch and tpuserve_torch only (the machine with the card
has no JAX), so it runs there without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: quant-matmul's kernel and plain version sum the same exact
products in another order (f32: a few ulps of the output; bf16 output: one
bf16 rounding of nearly equal sums). Decode attention shares every
requantization point with its plain version and its integer dots are exact;
where exp() of a score differs by an ulp between the kernel's expf and
PyTorch's exp, a P code can round the other way (one P step is pmax/127 of
one V row over the row sum): 2e-3 of the output range.
"""

import numpy as np
import pytest
import torch

from tpuserve_torch.device import smoke
from tpuserve_torch.ops import decode_attention as da
from tpuserve_torch.ops import quant_matmul as qm
from tpuserve_torch.quant.core import QTensor, quantize

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qt(bits, gs, k, n, act_bits, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=g) * 0.05
    qt = quantize(w, bits=bits, group_size=gs)
    qt.act_bits = act_bits
    return qt.to(device)


@pytest.mark.parametrize("bits,gs,act_bits", [
    (4, 128, 0), (4, 0, 0), (8, 128, 0), (8, 256, 0), (8, 0, 0), (4, 128, 8), (4, 32, 0),
    (4, 16, 0), (8, 32, 0)])
@pytest.mark.parametrize("b", [1, 37, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul(cuda, bits, gs, act_bits, b, dtype):
    k, n = 512, 208  # N not a multiple of the 64-column tile
    qt = _qt(bits, gs, k, n, act_bits, cuda)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    out = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == dtype and out.shape == ref.shape == (b, n)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


def test_quant_matmul_pads_n(cuda):
    qt = _qt(4, 128, 256, 100, 0, cuda)  # N % 16 != 0: the wrapper pads
    x = torch.randn((3, 256), device=cuda)
    out, ref = qm.quant_matmul(x, qt), qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert out.shape == (3, 100)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _cache(kind, s, hkv, l, n_layers, device, scale_dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = hkv * 128
    if kind == "int8":
        k, v = (torch.randint(-127, 128, (n_layers, s, l, w), generator=g, dtype=torch.int8)
                for _ in range(2))
    elif kind == "int4":
        k, v = (torch.randint(0, 256, (n_layers, s, l, w // 2), generator=g,
                              dtype=torch.int32).to(torch.uint8) for _ in range(2))
    else:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        k, v = (torch.randn((n_layers, s, l, w), generator=g).to(dt) for _ in range(2))
    ks = vs = None
    if kind in ("int8", "int4"):
        ks, vs = ((torch.rand((s, hkv, l), generator=g) + 0.5).mul(0.01).to(scale_dtype)
                  for _ in range(2))
    to = lambda t: None if t is None else t.to(device)
    return to(k), to(v), to(ks), to(vs)


@pytest.mark.parametrize("kind,h,hkv,l,window,block_l,scale_dtype", [
    ("int8", 32, 32, 256, None, None, torch.bfloat16),   # Llama-2-7B decode shape
    ("int4", 32, 32, 256, None, None, torch.bfloat16),
    ("bf16", 32, 32, 256, 128, None, None),
    ("int8", 8, 2, 64, None, None, torch.float32),       # packed case, rep 4
    ("int8", 8, 2, 256, None, None, torch.float32),      # packed case, one P requant per row
    ("int4", 4, 2, 64, 32, 16, torch.float32),           # int4 pair x rep 2
    ("f32", 4, 2, 64, None, 16, None),
    ("f32", 4, 4, 64, None, None, None),                  # packed, float cache
])
def test_decode_attention(cuda, kind, h, hkv, l, window, block_l, scale_dtype):
    s, n_layers, layer = 8, 2, 1
    k, v, ks, vs = _cache(kind, s, hkv, l, n_layers, cuda,
                          scale_dtype=scale_dtype or torch.float32)
    win = window or l
    g = torch.Generator().manual_seed(2)
    q = (torch.randn((s, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    pos = torch.randint(0, win, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[3], pos[5] = -1, win - 1, 0
    pos = pos.to(cuda)
    for qdt in (torch.float32, torch.bfloat16):
        args = (q.to(qdt), k, v, ks, vs, pos, layer)
        out = da.decode_attention_wide_cache(*args, window=window, block_l=block_l)
        ref = da.decode_attention_wide_cache_plain(*args, window=window, block_l=block_l)
        torch.cuda.synchronize()
        assert torch.all(out[1] == 0)
        err = (out - ref).abs().max().item()
        assert err <= 2e-3 * ref.abs().max().item() + 1e-6, (qdt, err)


def test_vector_add(cuda):
    for n in (1, 1000, 1_000_003):
        a, b = torch.randn(n, device=cuda), torch.randn(n, device=cuda)
        assert torch.equal(smoke.vector_add(a, b), a + b)
    assert smoke.run_smoke_test(device="cuda")
