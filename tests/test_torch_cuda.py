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


def _pools(kind, s, hkv, ps, n_pages, n_layers, device, seed=0):
    """Random paged pools [n_layers, n_pages, ps, W] and f32 scale pools
    [n_layers, n_pages, pad8(Hkv), ps] (None for bf16)."""
    g = torch.Generator().manual_seed(seed)
    w = hkv * 128
    shape = (n_layers, n_pages, ps, w // 2 if kind == "int4" else w)
    if kind == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8) for _ in range(2))
    elif kind == "int4":
        k, v = (torch.randint(0, 256, shape, generator=g, dtype=torch.int32).to(torch.uint8)
                for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g).to(torch.bfloat16) for _ in range(2))
    ks = vs = None
    if kind != "bf16":
        hp = (hkv + 7) // 8 * 8
        ks, vs = ((torch.rand((n_layers, n_pages, hp, ps), generator=g) + 0.5) * 0.01
                  for _ in range(2))
    to = lambda t: None if t is None else t.to(device)
    return to(k), to(v), to(ks), to(vs)


@pytest.mark.parametrize("kind,h,hkv,ps,n_cols,window", [
    ("int8", 32, 32, 128, 2, None),     # Llama-2-7B paged decode shape
    ("int4", 32, 32, 128, 2, None),
    ("bf16", 32, 32, 128, 2, None),
    ("int8", 8, 2, 16, 6, 64),          # window shorter than the table
    ("int4", 4, 2, 16, 4, None),
])
def test_decode_attention_paged(cuda, kind, h, hkv, ps, n_cols, window):
    """The paged kernel against its plain version, and against the flat
    kernel on the same KV laid out contiguously (the pages are shuffled);
    with block_l = ps the two kernels run the same blocks in the same
    order, so they agree to f32 rounding (tolerance 1e-6, expected 0)."""
    s, n_layers, layer = 8, 2, 1
    n_pages = s * n_cols + 1
    k, v, ks, vs = _pools(kind, s, hkv, ps, n_pages, n_layers, cuda)
    g = torch.Generator().manual_seed(3)
    table = (1 + torch.randperm(n_pages - 1, generator=g)).view(s, n_cols).to(torch.int32)
    win = window or n_cols * ps
    pos = torch.randint(0, win, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[2], pos[3], pos[4] = -1, win - 1, ps - 1, ps
    table, pos = table.to(cuda), pos.to(cuda)
    # the flat cache holds one junk page past the window, so the flat side
    # runs its L-blocked form, as the paged kernel does
    idx = table[:, :win // ps].long()
    fk, fv = (torch.cat([t[:, idx].reshape(n_layers, s, win, -1),
                         t[:, :1].expand(-1, s, -1, -1)], dim=2).contiguous() for t in (k, v))
    fks = fvs = None
    if ks is not None:
        fks, fvs = (torch.cat([sc[layer][idx].permute(0, 2, 1, 3).reshape(s, -1, win)[:, :hkv],
                               sc[layer][idx][:, 0, :hkv]], dim=2).contiguous()
                    for sc in (ks, vs))
    q = (torch.randn((s, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    for qdt in (torch.float32, torch.bfloat16):
        args = (q.to(qdt), k, v, ks, vs, table, pos, layer)
        out = da.decode_attention_wide_paged(*args, window=window)
        ref = da.decode_attention_wide_paged_plain(*args, window=window)
        flat = da.decode_attention_wide_cache(q.to(qdt), fk, fv, fks, fvs, pos, layer,
                                              window=win, block_l=ps)
        torch.cuda.synchronize()
        assert torch.all(out[1] == 0)
        err = (out - ref).abs().max().item()
        assert err <= 2e-3 * ref.abs().max().item() + 1e-6, (qdt, err)
        assert (out - flat).abs().max().item() <= 1e-6, qdt


def test_decode_attention_paged_refuses(cuda):
    """The paged wrapper raises, and never runs the plain version, on what
    the kernel does not take."""
    k, v, ks, vs = _pools("int8", 2, 2, 16, 5, 1, cuda)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    q = torch.randn((2, 4, 128), device=cuda)
    with pytest.raises(ValueError, match="multiple of page_size"):
        da.decode_attention_wide_paged(q, k, v, ks, vs, table, pos, 0, window=24)
    with pytest.raises(ValueError, match="float32"):
        da.decode_attention_wide_paged(q, k, v, ks.to(torch.bfloat16), vs.to(torch.bfloat16),
                                       table, pos, 0)
    with pytest.raises(ValueError, match="page_table"):
        da.decode_attention_wide_paged(q, k, v, ks, vs, table.long(), pos, 0)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention_wide_paged(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                       v[..., :64].contiguous(), ks, vs, table, pos, 0)
    before = da.paged_launches
    da.decode_attention_wide_paged(q, k, v, ks, vs, table, pos, 0)
    torch.cuda.synchronize()
    assert da.paged_launches == before + 1


@pytest.mark.parametrize("kind,h,hkv,win,block_l,cands,scale_dtype", [
    ("int8", 32, 32, 512, None, 9, torch.bfloat16),   # Llama-2-7B verify shape
    ("int4", 32, 32, 512, None, 9, torch.bfloat16),
    ("int8", 32, 32, 256, None, 1, torch.float32),
    ("int4", 32, 32, 256, None, 2, torch.float32),
    ("int8", 8, 2, 256, 64, 5, torch.float32),        # rep 4
    ("int4", 8, 2, 128, 32, 9, torch.float32),        # rep 4: 8 heads per block x 9
    ("int4", 8, 2, 64, 16, 2, torch.bfloat16),
    ("bf16", 4, 4, 256, None, 2, None),
    ("bf16", 8, 2, 128, 32, 9, None),
    ("f32", 4, 4, 128, None, 1, None),
    ("f32", 8, 2, 128, 32, 5, None),
])
def test_decode_attention_multi(cuda, kind, h, hkv, win, block_l, cands, scale_dtype):
    """The multi-candidate kernel against its plain version, and each row c
    against the flat kernel at positions + c on the same KV. The cache
    holds 64 junk rows past the window, so the flat side runs its L-blocked
    form, as the multi kernel always does; the two then run the same blocks
    over the same bytes with the same arithmetic, and a block past a row's
    horizon changes nothing: they agree to f32 rounding (tolerance 1e-6 of
    the range, expected 0)."""
    s, n_layers, layer = 8, 2, 1
    k, v, ks, vs = _cache(kind, s, hkv, win + 64, n_layers, cuda,
                          scale_dtype=scale_dtype or torch.float32)
    g = torch.Generator().manual_seed(4)
    q = (torch.randn((s, cands, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    pos = torch.randint(0, win - cands + 1, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[3], pos[5] = -1, win - cands, 0
    pos = pos.to(cuda)
    live = pos >= 0
    for qdt in (torch.float32, torch.bfloat16):
        args = (q.to(qdt), k, v, ks, vs, pos, layer)
        before = da.multi_launches
        out = da.decode_attention_wide_cache_multi(*args, window=win, block_l=block_l)
        ref = da.decode_attention_wide_cache_multi_plain(*args, window=win, block_l=block_l)
        torch.cuda.synchronize()
        assert da.multi_launches == before + 1
        assert out.shape == (s, cands, h, 128) and torch.all(out[1, 0] == 0)
        err = (out - ref)[live].abs().max().item()
        assert err <= 2e-3 * ref[live].abs().max().item() + 1e-6, (qdt, err)
        for c in range(cands):
            flat = da.decode_attention_wide_cache(q[:, c].to(qdt).contiguous(), k, v, ks, vs,
                                                  pos + c, layer, window=win, block_l=block_l)
            torch.cuda.synchronize()
            flat_err = (out[:, c] - flat)[live].abs().max().item()
            assert flat_err <= 1e-6 * flat[live].abs().max().item() + 1e-7, (qdt, c, flat_err)


def test_decode_attention_multi_refuses(cuda):
    """The multi wrapper raises, and never runs the plain version, on what
    the kernel does not take."""
    k, v, ks, vs = _cache("int4", 2, 2, 128, 1, cuda)
    pos = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    q = torch.randn((2, 3, 4, 128), device=cuda)
    with pytest.raises(ValueError, match="candidates"):
        da.decode_attention_wide_cache_multi(torch.randn((2, 17, 4, 128), device=cuda),
                                             k, v, ks, vs, pos, 0)
    with pytest.raises(ValueError, match=r"q \[S, C, H, hd\]"):
        da.decode_attention_wide_cache_multi(q[:, 0], k, v, ks, vs, pos, 0)
    with pytest.raises(ValueError, match="head_dim"):   # int8 W=256 read as 4 heads of 64
        k8, v8, ks8, vs8 = _cache("int8", 2, 2, 128, 1, cuda)
        da.decode_attention_wide_cache_multi(q[..., :64].contiguous(), k8, v8,
                                             ks8.repeat(1, 2, 1), vs8.repeat(1, 2, 1), pos, 0)
    with pytest.raises(ValueError, match="scales must be"):
        da.decode_attention_wide_cache_multi(q, k, v, ks[:, :, :64].contiguous(),
                                             vs[:, :, :64].contiguous(), pos, 0)
    with pytest.raises(ValueError, match="shared memory"):   # 16 x 8 rows, 128-row blocks
        da.decode_attention_wide_cache_multi(torch.randn((2, 16, 8, 128), device=cuda),
                                             k, v, ks, vs, pos, 0)
    with pytest.raises(ValueError, match="out of range"):
        da.decode_attention_wide_cache_multi(q, k, v, ks, vs, pos, 1)
    before = da.multi_launches
    da.decode_attention_wide_cache_multi(q, k, v, ks, vs, pos, 0)
    torch.cuda.synchronize()
    assert da.multi_launches == before + 1


@pytest.mark.parametrize("kind,h,hkv,l,block_l,g_kv,scale_dtype", [
    ("int8", 32, 32, 256, 256, None, torch.float32),    # Llama-2-7B decode step, default split
    ("int8", 32, 32, 256, 256, 32, torch.bfloat16),     # all heads in one block
    ("bf16", 32, 32, 256, 256, None, None),
    ("int8", 32, 8, 256, 64, None, torch.float32),      # rep 4, four blocks
    ("int8", 32, 8, 256, 256, 8, torch.float32),
    ("bf16", 8, 4, 128, 32, 2, None),                    # rep 2
    ("f32", 8, 4, 128, 32, None, None),
    ("f32", 16, 2, 64, 16, 2, None),                     # rep 8
])
def test_decode_attention_grouped(cuda, kind, h, hkv, l, block_l, g_kv, scale_dtype):
    """The grouped kernel against its plain version on a window view of a
    longer cache (slot stride 2L rows) with transposed scale views, as the
    decode step hands them over. Same arithmetic, exact integer dots; an
    ulp of expf against torch.exp can tip one P entry across a bf16
    rounding boundary (2^-8 of it): 1e-3 of the output range."""
    s, n_layers, layer = 8, 2, 1
    k, v, ks, vs = _cache(kind, s, hkv, 2 * l, n_layers, cuda,
                          scale_dtype=scale_dtype or torch.float32)
    kw, vw = (t[layer, :, :l].view(s, l, hkv, 128) for t in (k, v))
    ksw = vsw = None
    if ks is not None:
        ksw, vsw = (t[:, :, :l].transpose(1, 2) for t in (ks, vs))
    g = torch.Generator().manual_seed(5)
    q = (torch.randn((s, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    pos = torch.randint(0, l, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[3], pos[5] = -1, l - 1, 0
    pos = pos.to(cuda)
    for qdt in (torch.float32, torch.bfloat16):
        args = (q.to(qdt), kw, vw, ksw, vsw, pos)
        before = da.grouped_launches
        out = da.decode_attention(*args, block_l=block_l, g_kv=g_kv)
        ref = da.decode_attention_plain(*args, block_l=block_l, g_kv=g_kv)
        torch.cuda.synchronize()
        assert da.grouped_launches == before + 1
        assert torch.all(out[1] == 0)
        err = (out - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 1e-7, (qdt, err)


def test_decode_attention_grouped_refuses(cuda):
    """The grouped wrapper raises, and never runs the plain version, on what
    the kernel does not take."""
    k, v, ks, vs = _cache("int8", 2, 2, 64, 1, cuda)
    k4, v4 = (t[0].view(2, 64, 2, 128) for t in (k, v))
    ks4, vs4 = (t.transpose(1, 2) for t in (ks, vs))
    pos = torch.tensor([3, 20], dtype=torch.int32, device=cuda)
    q = torch.randn((2, 4, 128), device=cuda)
    with pytest.raises(ValueError, match="needs scales"):
        da.decode_attention(q, k4, v4, None, None, pos)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q[..., :64].contiguous(), k4[..., :64], v4[..., :64], ks4, vs4, pos)
    with pytest.raises(ValueError, match="contiguous rows"):   # heads not adjacent
        da.decode_attention(q, k4.transpose(0, 1).contiguous().transpose(0, 1), v4, ks4, vs4,
                            pos)
    with pytest.raises(ValueError, match="query heads per block"):   # rep 3
        da.decode_attention(torch.randn((2, 6, 128), device=cuda), k4, v4, ks4, vs4, pos)
    before = da.grouped_launches
    da.decode_attention(q, k4, v4, ks4, vs4, pos)
    torch.cuda.synchronize()
    assert da.grouped_launches == before + 1


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("block_l", [256, 128, 32])
def test_decode_attention_wide(cuda, kind, block_l):
    """decode_attention_wide (the flat kernel over a one-layer view of a
    contiguous [S, L, Hkv, hd] cache) against its plain version: the flat
    kernel's tolerance, 2e-3 of the range."""
    s, hkv, l = 8, 4, 256
    k, v, ks, vs = _cache(kind, s, hkv, l, 1, cuda)
    k4, v4 = (t[0].view(s, l, hkv, 128) for t in (k, v))
    g = torch.Generator().manual_seed(6)
    q = (torch.randn((s, 2 * hkv, 128), generator=g) / 128 ** 0.5).to(cuda)
    pos = torch.randint(0, l, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[3] = -1, l - 1
    pos = pos.to(cuda)
    before = (da.wide_launches, da.launches)
    out = da.decode_attention_wide(q, k4, v4, ks, vs, pos, block_l=block_l)
    ref = da.decode_attention_wide_plain(q, k4, v4, ks, vs, pos, block_l=block_l)
    torch.cuda.synchronize()
    assert (da.wide_launches, da.launches) == (before[0] + 1, before[1])
    assert torch.all(out[1] == 0)
    err = (out - ref).abs().max().item()
    assert err <= 2e-3 * ref.abs().max().item() + 1e-6, err


@pytest.mark.parametrize("s,l,hkv", [(4, 256, 32), (3, 64, 2), (2, 32, 4)])
def test_attention_probes(cuda, s, l, hkv):
    """The probes against their plain versions: column sums exactly (integer
    atomics); dot_only to 1e-5 of the range (f32 atomics in any order)."""
    from tpuserve_torch.ops import attention_probes as probes

    g = torch.Generator().manual_seed(7)
    k, v = (torch.randint(-128, 128, (s, l, hkv, 128), generator=g, dtype=torch.int8).to(cuda)
            for _ in range(2))
    want = probes.colsum_plain(k, v)
    for name, fn in (("dma_bound", lambda: probes.dma_bound(k, v)),
                     ("dma_wide", lambda: probes.dma_wide(k, v)),
                     ("dma_wide3d", lambda: probes.dma_wide(k, v, three_d=True))):
        out = fn()
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
    qi = probes.probe_q(torch.randn((s, 2 * hkv, 128), generator=g).to(cuda) / 128 ** 0.5)
    before = probes.dot_only_launches
    out = probes.dot_only(qi, k, v)
    ref = probes.dot_only_plain(qi, k, v)
    torch.cuda.synchronize()
    assert probes.dot_only_launches == before + 1
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_vector_add(cuda):
    for n in (1, 1000, 1_000_003):
        a, b = torch.randn(n, device=cuda), torch.randn(n, device=cuda)
        assert torch.equal(smoke.vector_add(a, b), a + b)
    assert smoke.run_smoke_test(device="cuda")
