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

from tpuserve_torch import kernels
from tpuserve_torch.device import smoke
from tpuserve_torch.ops import decode_attention as da
from tpuserve_torch.ops import quant_matmul as qm
from tpuserve_torch.quant.core import QTensor, quantize, quantize_activation

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
    (4, 16, 0), (8, 32, 0),
    (4, 48, 0), (4, 96, 0), (8, 96, 0),     # groups a 64-row stage cannot tile
    (4, 40, 0), (4, 12, 0), (8, 24, 0)])    # groups of no multiple of 16 (masked steps)
@pytest.mark.parametrize("b", [1, 37, 130, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul(cuda, bits, gs, act_bits, b, dtype):
    """Both activation dtypes (f32 x as three bf16 pieces, f32 out) against
    the plain version: 1e-5 of the largest output for f32, one bf16 step
    for bf16."""
    k = 512 if 512 % (gs or 512) == 0 else 480
    n = 208  # N not a multiple of the 64-column tile
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
    ("int4", 32, 8, 256, None, None, torch.float32),     # Mixtral GQA rep 4: nq 8
    ("int8", 32, 8, 256, None, None, torch.float32),     # and nq 4
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
    ("bf16", 32, 32, 512, None, 9, None),   # the default cache's verify at Llama-2-7B
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


@pytest.mark.parametrize("entry", ["flat", "multi", "paged"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("s,split", [(2, True), (64, False)])
def test_decode_attention_core_splits(cuda, entry, kind, s, split):
    """The Hopper core with its window split over blocks (S=2: a few blocks
    a slot, so split_plan cuts the 512-row window into runs merged by the
    last block to arrive) and without (S=64 at 32 kv heads: the grid fills
    the card): against the plain version, which takes the same plan, two
    calls bitwise equal (the merge runs in split order), and the multi
    kernel's row c against the flat kernel at positions + c to 1e-6 of the
    range."""
    hkv, l, n_layers, layer, cands = 32, 512, 1, 0, 3
    h = hkv
    g = torch.Generator().manual_seed(11)
    pos = torch.randint(0, l - cands, (s,), generator=g, dtype=torch.int32)
    pos[0] = l - cands
    if s > 2:
        pos[1] = -1
    pos = pos.to(cuda)
    live = pos >= 0
    shape = (s, cands, h, 128) if entry == "multi" else (s, h, 128)
    q = (torch.randn(shape, generator=g) / 128 ** 0.5).to(cuda, torch.bfloat16)
    if entry == "paged":
        ps, n_cols = 128, l // 128
        n_pages = s * n_cols + 1
        k, v, ks, vs = _pools(kind, s, hkv, ps, n_pages, 1, cuda, seed=2)
        table = (1 + torch.randperm(n_pages - 1, generator=g)).view(s, n_cols)
        table = table.to(cuda, torch.int32)
        args = (q, k, v, ks, vs, table, pos, layer)
        kern, plain = da.decode_attention_wide_paged, da.decode_attention_wide_paged_plain
    else:
        k, v, ks, vs = _cache(kind, s, hkv, l, n_layers, cuda, scale_dtype=torch.bfloat16)
        args = (q, k, v, ks, vs, pos, layer)
        if entry == "flat":
            kern, plain = da.decode_attention_wide_cache, da.decode_attention_wide_cache_plain
        else:
            kern = da.decode_attention_wide_cache_multi
            plain = da.decode_attention_wide_cache_multi_plain
    units = hkv // 2 if kind == "int4" else hkv     # 128-row blocks (the default, one page)
    splits, _ = da.split_plan(units, s, l // 128, kernels.sm_count(cuda))
    assert (splits > 1) == split, splits
    out, again, ref = kern(*args), kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    err = (out - ref)[live].abs().max().item()
    assert err <= 2e-3 * ref[live].abs().max().item() + 1e-6, err
    if entry == "multi":
        for c in range(cands):
            flat = da.decode_attention_wide_cache(q[:, c].contiguous(), k, v, ks, vs, pos + c,
                                                  layer)
            torch.cuda.synchronize()
            flat_err = (out[:, c] - flat)[live].abs().max().item()
            assert flat_err <= 1e-6 * flat[live].abs().max().item() + 1e-7, (c, flat_err)


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
    # 16 x 8 rows over 2048-row blocks (at 128-row blocks the Hopper core serves them)
    with pytest.raises(ValueError, match="shared memory"):
        kl, vl, ksl, vsl = _cache("int4", 2, 2, 2048, 1, cuda)
        da.decode_attention_wide_cache_multi(torch.randn((2, 16, 8, 128), device=cuda),
                                             kl, vl, ksl, vsl, pos, 0, block_l=2048)
    with pytest.raises(ValueError, match="out of range"):
        da.decode_attention_wide_cache_multi(q, k, v, ks, vs, pos, 1)
    before = da.multi_launches
    da.decode_attention_wide_cache_multi(q, k, v, ks, vs, pos, 0)
    torch.cuda.synchronize()
    assert da.multi_launches == before + 1


@pytest.mark.parametrize("skip", ["0", "1"])
@pytest.mark.parametrize("kind,h,hkv,l,block_l,g_kv,scale_dtype", [
    ("int8", 32, 32, 256, 256, None, torch.float32),    # Llama-2-7B decode step, default split
    ("int8", 32, 32, 256, 256, 16, torch.float32),      # sixteen heads a block
    ("int8", 32, 32, 256, 256, 32, torch.bfloat16),     # all heads in one block
    ("int8", 32, 32, 256, 64, 32, torch.float32),       # ... over four blocks
    ("bf16", 32, 32, 256, 256, None, None),
    ("int8", 32, 8, 256, 64, None, torch.float32),      # rep 4, four blocks: the window splits
    ("int8", 32, 8, 256, 256, 8, torch.float32),
    ("int8", 16, 2, 256, 32, None, torch.bfloat16),     # rep 8, eight splits
    ("bf16", 8, 4, 128, 32, 2, None),                    # rep 2
    ("bf16", 32, 32, 256, 256, 16, None),               # Llama-2-7B heads, the JAX default g_kv
    ("bf16", 32, 8, 256, 64, None, None),               # rep 4, four blocks: the window splits
    ("f32", 8, 4, 128, 32, None, None),
    ("f32", 16, 2, 64, 16, 2, None),                     # rep 8
])
def test_decode_attention_grouped(cuda, monkeypatch, kind, h, hkv, l, block_l, g_kv,
                                  scale_dtype, skip):
    """The grouped kernel against its plain version on a window view of a
    longer cache (slot stride 2L rows) with transposed scale views, as the
    decode step hands them over, under TPUSERVE_ATTN_DYNSKIP 0 and 1, with
    f32 and bf16 q (an f32 q against a bf16 window: its three bf16 pieces).
    Same arithmetic (the kernel and its plain version split the window
    alike), exact integer (int8) or f32-exact (bf16) products; an ulp of
    expf against torch.exp, or of the order of f32 sums, can tip one P
    entry across a bf16 rounding boundary (2^-8 of it): 1e-3 of the output
    range."""
    monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", skip)
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


@pytest.mark.parametrize("skip", ["0", "1"])
@pytest.mark.parametrize("h,hkv,l,block_l,scale_dtype", [
    (32, 32, 256, 256, torch.bfloat16),   # Llama-2-7B decode step: one block, no split
    (32, 32, 256, 64, torch.float32),     # four blocks, two splits at S=8
    (32, 8, 256, 64, torch.float32),      # rep 4 (8 query rows a head pair), four splits
    (16, 2, 128, 32, torch.bfloat16),     # rep 8 (16 query rows a pair), four splits
    (4, 4, 256, 256, torch.float32),      # rep 1
])
def test_decode_attention_grouped_packed(cuda, monkeypatch, h, hkv, l, block_l, scale_dtype,
                                         skip):
    """The packed int4 route (decode_attention_packed: the grouped Hopper
    kernel decoding the nibbles itself) against its plain version
    (unpack_kv_codes, then decode_attention_plain) on the layer's window
    of a longer packed cache with head-major scale views, as the decode
    step hands them over: g_kv 1, 16 and 32 (clipped to Hkv) give the same
    values, inactive slots 0, 1e-3 of the output range (the int8 route's
    bound), and TPUSERVE_ATTN_DYNSKIP 0 and 1 agree to 1e-6 of it."""
    s, n_layers, layer = 8, 2, 1
    k, v, ks, vs = _cache("int4", s, hkv, 2 * l, n_layers, cuda, scale_dtype=scale_dtype)
    kw, vw = (t[layer, :, :l] for t in (k, v))
    ksw, vsw = (t[:, :, :l] for t in (ks, vs))
    g = torch.Generator().manual_seed(6)
    q = (torch.randn((s, h, 128), generator=g) / 128 ** 0.5).to(cuda, torch.bfloat16)
    pos = torch.randint(0, l, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[3], pos[5], pos[6] = -1, l - 1, 0, -1
    pos = pos.to(cuda)
    outs = {}
    for mode in ("0", "1") if skip == "0" else ("1", "0"):
        monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", mode)
        ref = da.decode_attention_packed_plain(q, kw, vw, ksw, vsw, pos, block_l=block_l)
        for g_kv in (1, 16, 32):
            before = da.grouped_launches
            out = da.decode_attention_packed(q, kw, vw, ksw, vsw, pos, block_l=block_l, g_kv=g_kv)
            torch.cuda.synchronize()
            assert da.grouped_launches == before + 1
            assert torch.all(out[1] == 0) and torch.all(out[6] == 0)
            err = (out - ref).abs().max().item()
            assert err <= 1e-3 * ref.abs().max().item() + 1e-7, (mode, g_kv, err)
            if g_kv == 1:
                outs[mode] = out
            else:
                assert torch.equal(out, outs[mode]), (mode, g_kv)
    live = pos >= 0
    diff = (outs["0"] - outs["1"])[live].abs().max().item()
    assert diff <= 1e-6 * outs["1"][live].abs().max().item()


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_decode_attention_grouped_float_scales(cuda, kind):
    """A float window with k/v scales (the JAX kernel's optional scales of a
    float cache): [S, L, Hkv] f32 and bf16 scales in a layout that is not
    head-major (copied head-major by the wrapper), g_kv 1 and Hkv and a
    split window (S=4, Hkv=4, four blocks), against the plain version within
    1e-3 of the output range; g_kv changes no value."""
    s, hkv, h, l = 4, 4, 8, 128
    k, v, _, _ = _cache(kind, s, hkv, l, 1, cuda)
    kw, vw = (t[0].view(s, l, hkv, 128) for t in (k, v))
    g = torch.Generator().manual_seed(9)
    q = (torch.randn((s, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    pos = torch.tensor([127, -1, 40, 0], dtype=torch.int32, device=cuda)
    for sdt in (torch.float32, torch.bfloat16):
        ks, vs = ((torch.rand((s, l, hkv), generator=g) + 0.5).to(cuda, sdt) for _ in range(2))
        ref = da.decode_attention_plain(q, kw, vw, ks, vs, pos, block_l=32)
        outs = [da.decode_attention(q, kw, vw, ks, vs, pos, block_l=32, g_kv=g_kv)
                for g_kv in (1, hkv)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]) and torch.all(outs[0][1] == 0)
        err = (outs[0] - ref).abs().max().item()
        assert err <= 1e-3 * ref.abs().max().item() + 1e-7, (sdt, err)


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


@pytest.mark.parametrize("m", [32, 128, 40])
@pytest.mark.parametrize("s,l,hkv", [(2, 256, 32), (3, 96, 2)])
def test_dot_only_tensor_cores(cuda, s, l, hkv, m):
    """The tensor-core dot_only against its plain version at M 32 (the
    sweep's: one query group), 128 (four groups) and 40 (a ragged group),
    over 8192 rows a slot (the sweep's) and 192 (three tiles): 1e-5 of the
    range (P rounds to bf16 at the same point, f32 sums in another order,
    blocks' float4 atomics in any order). The launch counter counts."""
    from tpuserve_torch.ops import attention_probes as probes

    g = torch.Generator().manual_seed(11)
    k, v = (torch.randint(-128, 128, (s, l, hkv, 128), generator=g, dtype=torch.int8).to(cuda)
            for _ in range(2))
    qi = probes.probe_q(torch.randn((s, m, 128), generator=g).to(cuda) / 128 ** 0.5)
    before = probes.dot_only_launches
    out = probes.dot_only(qi, k, v)
    ref = probes.dot_only_plain(qi, k, v)
    torch.cuda.synchronize()
    assert probes.dot_only_launches == before + 1
    assert out.shape == ref.shape == (s, m, 128)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


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


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _vadd_operand(n, dtype, device, g):
    if dtype in _BITS:
        return (torch.randn(n, generator=g, device=device)
                * torch.exp2(torch.randint(-6, 7, (n,), generator=g, device=device))).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max + 1, (n,), generator=g, device=device, dtype=dtype)


def _same_bits(x, y):
    return torch.equal(x.view(_BITS[x.dtype]), y.view(_BITS[y.dtype])) if x.dtype in _BITS \
        else torch.equal(x, y)


@pytest.mark.parametrize("n", [1, 3, 1000, 1_000_003, 2 ** 24 + 5])
@pytest.mark.parametrize("dtype", smoke.DTYPES)
def test_vector_add_dtypes(cuda, dtype, n):
    """Every dtype the JAX function adds, bitwise equal to torch's a + b:
    on whole tensors, on views that share an alignment (a[1:] + b[1:], the
    vector route after a scalar head) and on views that do not (a[1:] +
    b[3:], the scalar route)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a, b = _vadd_operand(n + 3, dtype, cuda, g), _vadd_operand(n + 3, dtype, cuda, g)
    cases = [(a[:n], b[:n]), (a[1:n + 1], b[1:n + 1]), (a[1:n + 1], b[3:n + 3])]
    for x, y in cases:
        before = smoke.launches
        out = smoke.vector_add(x, y)
        assert smoke.launches == before + 1
        assert out.dtype == dtype and _same_bits(out, x + y), (x.data_ptr() % 16, y.data_ptr() % 16)


@pytest.mark.parametrize("m,w2,n,blr,grid", [
    (32, 2048, 4096, 256, None),   # the microbenchmark's widths, 8 MB
    (16, 256, 640, 128, None),     # fewer groups than SMs
    (32, 2048, 38400, 128, 1),     # one block, 300 groups: each pair flushes twice
    (16, 12800, 3200, 128, 1),     # the widest q: its k-chunks stream beside x; a flush a pair
    (32, 64, 1024, 256, None),     # one 64-byte chunk: the 128-byte box half past the edge
    (16, 192, 2560, 128, 7),       # three 64-byte chunks: the second box half past the edge
])
def test_unpack_probes(cuda, monkeypatch, m, w2, n, blr, grid):
    """The five unpack-probe variants against their plain versions, exactly
    (int32 sums flushed into 64-bit integer atomics), with full-range int8
    inputs; the three unpack variants equal one another. `grid` stands in
    for the card's SM count, the launch's number of blocks."""
    from tpuserve_torch import kernels
    from tpuserve_torch.ops import unpack_probes as up

    if grid is not None:
        monkeypatch.setattr(kernels, "sm_count", lambda device: grid)
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-128, 128, (n, w2), generator=g, dtype=torch.int8).to(cuda)
    q = torch.randint(-128, 128, (m, w2), generator=g, dtype=torch.int8).to(cuda)
    outs = {}
    for name in up.VARIANTS:
        before = up.launches[name]
        out = up.PROBES[name](x, q, 7, blr)
        ref = up.unpack_probe_plain(name, x, q, 7, blr)
        torch.cuda.synchronize()
        assert up.launches[name] == before + 1
        assert out.dtype == torch.int64 and torch.equal(out, ref), name
        outs[name] = out
    assert torch.equal(outs["unpack_cur"], outs["unpack_hi"])
    assert torch.equal(outs["unpack_cur"], outs["unpack_i8"])


def test_unpack_probes_refuse(cuda):
    from tpuserve_torch.ops import unpack_probes as up

    x = torch.zeros((256, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="query rows"):
        up.dot_raw(x, torch.zeros((8, 256), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="multiple of 64"):
        up.unpack_cur(x[:, :96].contiguous(), torch.zeros((16, 96), dtype=torch.int8,
                                                          device=cuda), blr=128)
    with pytest.raises(ValueError, match="W2"):
        up.unpack_i8(torch.zeros((128, 16384), dtype=torch.int8, device=cuda),
                     torch.zeros((16, 16384), dtype=torch.int8, device=cuda), blr=128)
    with pytest.raises(ValueError, match="contiguous"):
        up.unpack_hi(x[:, ::2], torch.zeros((16, 128), dtype=torch.int8, device=cuda))


@pytest.mark.parametrize("s,l,hkv,hd,g,block_l", [
    (64, 256, 32, 128, 16, 256),   # diag_bw's defaults, and its smaller blocks
    (64, 256, 32, 128, 16, 64),
    (64, 256, 32, 128, 16, 16),
    (4, 64, 4, 48, 2, 16),         # 3 column groups a row: 255 of 256 threads load
    (3, 32, 2, 208, 1, 8),         # 13 column groups
    (2, 96, 8, 16, 4, 32),
    (5, 128, 6, 256, 3, 64),
])
def test_diag_copy(cuda, s, l, hkv, hd, g, block_l):
    """diag_copy's three forms against their plain versions, exactly
    (integer atomics; tolerance 0), on the card's grid of CTAs, not the
    TPU's; pdyn over mixed positions."""
    from tpuserve_torch.ops import attention_probes as probes

    gen = torch.Generator().manual_seed(hd)
    k, v = (torch.randint(-128, 128, (s, l, hkv, hd), generator=gen, dtype=torch.int8).to(cuda)
            for _ in range(2))
    pos = torch.randint(-1, l, (s,), generator=gen, dtype=torch.int32)
    pos[0] = -1
    pos[-1] = 0
    pos = pos.to(cuda)
    for mode in probes.COPY_MODES:
        p = pos if mode == "pdyn" else None
        rpc, cpb, grid = probes.diag_copy_plan(k.shape, mode, block_l, g,
                                               kernels.sm_count(cuda))
        tpu = probes.diag_copy_tpu_grid(k.shape, mode, block_l, g)
        assert grid == (tpu[0] * cpb,) + tpu[1:] and rpc * cpb >= block_l
        before = probes.diag_copy_launches
        out = probes.diag_copy(k, v, mode, block_l, g, p)
        ref = probes.diag_copy_plain(k, v, mode, block_l, g, p)
        torch.cuda.synchronize()
        assert probes.diag_copy_launches == before + 1
        assert out.dtype == torch.int32 and torch.equal(out, ref), mode


def test_diag_copy_refuses(cuda):
    from tpuserve_torch.ops import attention_probes as probes

    k = torch.zeros((2, 16, 2, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="hd=24"):
        probes.diag_copy(k, k, "pcopy", 8)
    k = torch.zeros((2, 16, 2, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int32 positions"):
        probes.diag_copy(k, k, "pdyn", 8, positions=torch.zeros(2, dtype=torch.int64,
                                                                device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        probes.diag_copy(k.transpose(0, 1).contiguous().transpose(0, 1), k, "pcopy", 8)


@pytest.fixture()
def noop(monkeypatch):
    monkeypatch.setenv("TPUSERVE_INT4_UNPACK", "noop")


def test_int4_noop_kernels(cuda, noop, monkeypatch):
    """TPUSERVE_INT4_UNPACK=noop: the flat, paged and multi kernels' NOOP
    instances against their plain versions under noop (the decode-attention
    tolerance), differing from the default instances; unset again, the
    default instances give what they gave before."""
    s, h, hkv, l, layer = 8, 32, 32, 256, 1
    k, v, ks, vs = _cache("int4", s, hkv, l, 2, cuda, scale_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(9)
    q = (torch.randn((s, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    q4 = (torch.randn((s, 3, h, 128), generator=g) / 128 ** 0.5).to(cuda)
    pos = torch.randint(0, l - 3, (s,), generator=g, dtype=torch.int32)
    pos[1] = -1
    pos = pos.to(cuda)
    pk, pv, pks, pvs = _pools("int4", s, hkv, 128, 2 * s + 1, 2, cuda)
    table = (1 + torch.randperm(2 * s, generator=g)).view(s, 2).to(torch.int32).to(cuda)
    calls = {
        "flat": (lambda: da.decode_attention_wide_cache(q, k, v, ks, vs, pos, layer),
                 lambda: da.decode_attention_wide_cache_plain(q, k, v, ks, vs, pos, layer)),
        "paged": (lambda: da.decode_attention_wide_paged(q, pk, pv, pks, pvs, table, pos, layer),
                  lambda: da.decode_attention_wide_paged_plain(q, pk, pv, pks, pvs, table, pos,
                                                               layer)),
        "multi": (lambda: da.decode_attention_wide_cache_multi(q4, k, v, ks, vs, pos, layer),
                  lambda: da.decode_attention_wide_cache_multi_plain(q4, k, v, ks, vs, pos,
                                                                     layer)),
    }
    live = pos >= 0
    noop_out = {}
    for name, (kern, plain) in calls.items():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out - ref)[live].abs().max().item()
        assert err <= 2e-3 * ref[live].abs().max().item() + 1e-6, (name, err)
        noop_out[name] = out
    monkeypatch.delenv("TPUSERVE_INT4_UNPACK")
    for name, (kern, plain) in calls.items():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = (out - ref)[live].abs().max().item()
        assert err <= 2e-3 * ref[live].abs().max().item() + 1e-6, (name, err)
        assert (out - noop_out[name])[live].abs().max().item() > 1e-3 * out.abs().max().item()


# ---------------------------------------------------------------- Hopper quant-matmul
@pytest.mark.parametrize("bits,gs", [(4, 128), (4, 32), (4, 16), (4, 0), (8, 128), (8, 32),
                                     (8, 16), (8, 0)])
@pytest.mark.parametrize("b", [1, 8, 37, 64, 72, 130, 256, 300])
def test_quant_matmul_hopper(cuda, bits, gs, b):
    """The bf16 kernel (wgmma, TMA ring, split K in one launch) against its
    plain version at every batch tile, N = 208 (not a multiple of the 64- or
    128-column tile), each group size: one bf16 step at the largest output;
    two calls bitwise equal; one launch a call."""
    k, n = 512, 208
    qt = _qt(bits, gs, k, n, 0, cuda)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda, torch.bfloat16)
    before = qm.launches
    out = qm.quant_matmul(x, qt)
    again = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.launches == before + 2
    assert out.dtype == torch.bfloat16 and out.shape == (b, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("bits,gs", [(4, 48), (4, 96), (4, 80), (4, 112), (8, 96), (8, 48)])
@pytest.mark.parametrize("b", [1, 64, 72, 130])
def test_quant_matmul_group_route(cuda, bits, gs, b):
    """bf16 activations in groups a 64-row stage cannot tile: the wgmma
    kernel in stages cut along the groups, one launch a call, counted as an
    odd-group launch and never as a group-route one, against the plain
    version within one bf16 step; two calls bitwise equal."""
    k, n = 480 if gs != 112 else 448, 208
    qt = _qt(bits, gs, k, n, 0, cuda)
    assert qt.group_size == gs and qm.bf16_route(bits, gs) == "wgmma" and qm.odd_group(bits, gs)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda, torch.bfloat16)
    before, routed, odd = qm.launches, qm.group_route_launches, qm.odd_group_launches
    out = qm.quant_matmul(x, qt)
    again = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.launches == before + 2 and qm.odd_group_launches == odd + 2
    assert qm.group_route_launches == routed
    assert out.dtype == torch.bfloat16 and out.shape == (b, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


def _qt_codes(bits, gs, k, n, act_bits, device, seed=0):
    """Random codes and scales made on the card (a quantizer's clip search
    at 7B widths would take the host minutes)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if bits == 4:
        q = torch.randint(0, 256, (k // 2, n), generator=g, device=device,
                          dtype=torch.int32).to(torch.uint8)
    else:
        q = torch.randint(-127, 128, (k, n), generator=g, device=device,
                          dtype=torch.int32).to(torch.int8)
    scale = (torch.rand((k // gs, n), generator=g, device=device) + 0.5) * 0.003
    return QTensor(q=q, scale=scale, bits=bits, group_size=gs if gs < k else 0,
                   orig_shape=(k, n), act_bits=act_bits)


# the five weight shapes of a Llama-2-7B layer step (K, N)
_SHAPES_7B = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("k,n", _SHAPES_7B)
@pytest.mark.parametrize("b", [1, 16, 64, 72, 128, 256])
def test_quant_matmul_w4a8_hopper(cuda, k, n, b):
    """W4A8 (int4 g128, int8 x) on the int8 wgmma kernel at the 7B shapes:
    within one bf16 step of the largest plain output, two calls bitwise
    equal, one launch a call counted in w4a8_launches (and one of the row
    quantization kernel); the masked routes' counters do not move."""
    qt = _qt_codes(4, 128, k, n, 8, cuda, seed=k + n)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda, torch.bfloat16)
    names = ("launches", "w4a8_launches", "quantize_launches", "w4a8_route_launches",
             "group_route_launches")
    counts = [getattr(qm, c) for c in names]
    out = qm.quant_matmul(x, qt)
    again = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert [getattr(qm, c) for c in names] == [counts[0] + 2, counts[1] + 2, counts[2] + 2,
                                               counts[3], counts[4]]
    assert out.dtype == torch.bfloat16 and out.shape == (b, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("gs,k", [(32, 512), (64, 512), (96, 480), (160, 480), (0, 512),
                                  (256, 1024)])
@pytest.mark.parametrize("b", [1, 37, 72, 130])
def test_quant_matmul_w4a8_groups(cuda, gs, k, b):
    """W4A8 groups of a multiple of 32 on the int8 wgmma kernel: whole
    groups a stage (32, 64, 96), pieces (160: 64 + 16 rows; 256; per
    channel), against the quantizer's own weights and the plain version."""
    n = 208
    qt = _qt(4, gs, k, n, 8, cuda)
    assert qm.w4a8_route(gs or k) == "wgmma"
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda, torch.bfloat16)
    a8 = qm.w4a8_launches
    out = qm.quant_matmul(x, qt)
    again = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert qm.w4a8_launches == a8 + 2
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,k", [(1, 96), (64, 4096), (72, 11008), (256, 4096), (3, 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows(cuda, b, k, dtype):
    """The row quantization kernel: codes and scales bitwise those of
    quantize_activation (its plain version), a row of zeros included."""
    x = (torch.randn((b, k), generator=torch.Generator().manual_seed(k)) * 3).to(cuda, dtype)
    x[b // 2] = 0
    before = qm.quantize_launches
    q, sx = qm.quantize_rows(x)
    ref_q, ref_s = quantize_activation(x)
    torch.cuda.synchronize()
    assert qm.quantize_launches == before + 1
    assert torch.equal(q, ref_q) and torch.equal(sx, ref_s)


@pytest.mark.parametrize("act_bits,gs", [(0, 40), (8, 48)])
def test_quant_matmul_cuda_core_routes_remain(cuda, act_bits, gs):
    """A bf16 group of no multiple of 16 (40) and a W4A8 group of no
    multiple of 32 (48) on the Hopper kernels in masked steps: each counted
    on its route, against the plain version."""
    k, n, b = 480, 208, 37
    qt = _qt(4, gs, k, n, act_bits, cuda)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(3)).to(cuda, torch.bfloat16)
    routed, a8_routed = qm.group_route_launches, qm.w4a8_route_launches
    out = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert (qm.group_route_launches, qm.w4a8_route_launches) == (
        (routed + 1, a8_routed) if act_bits == 0 else (routed, a8_routed + 1))
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err


# (bits, act_bits, group, K): bf16 x in groups of no multiple of 16 (int4
# even ones, int8 any), W4A8 in groups of no multiple of 32; some K of no
# multiple of 8 (bf16) or 16 (int8 x), which a TMA row could not hold as it
# is (the wrapper's stage layout holds any K)
_MASKED = [(4, 0, 2, 250), (4, 0, 10, 250), (4, 0, 12, 480), (4, 0, 20, 500), (4, 0, 40, 480),
           (4, 0, 136, 544), (8, 0, 1, 70), (8, 0, 3, 249), (8, 0, 24, 480), (8, 0, 40, 480),
           (4, 8, 2, 250), (4, 8, 12, 252), (4, 8, 20, 500), (4, 8, 48, 480), (4, 8, 136, 544),
           (4, 8, 144, 576)]


@pytest.mark.parametrize("bits,act_bits,gs,k", _MASKED,
                         ids=[f"int{c[0]}{'-w4a8' if c[1] else ''}-g{c[2]}-k{c[3]}"
                              for c in _MASKED])
@pytest.mark.parametrize("b", [1, 64, 72, 256])
def test_quant_matmul_masked_groups(cuda, bits, act_bits, gs, k, b):
    """The masked steps: one launch a call on the Hopper kernel, counted on
    its route (group_route_launches for bf16 x, w4a8_route_launches for
    W4A8), K split in the launch (N = 208: few tiles, so the plan splits),
    within one bf16 step of the largest plain output, two calls bitwise
    equal."""
    n = 208
    qt = _qt(bits, gs, k, n, act_bits, cuda)
    assert qt.group_size == gs
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda, torch.bfloat16)
    a8 = act_bits == 8
    assert qm.hopper_plan(b, k, n, bits, kernels.sm_count(x.device), gs=gs, a8=a8)[4] > 1
    names = ("launches", "group_route_launches", "w4a8_route_launches", "odd_group_launches",
             "w4a8_launches", "stage_launches", "quantize_launches")
    counts = [getattr(qm, c) for c in names]
    out = qm.quant_matmul(x, qt)
    again = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert [getattr(qm, c) for c in names] == [
        counts[0] + 2, counts[1] + (0 if a8 else 2), counts[2] + (2 if a8 else 0), counts[3],
        counts[4], counts[5] + (0 if a8 else 2), counts[6] + (2 if a8 else 0)]
    assert out.dtype == torch.bfloat16 and out.shape == (b, n)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("bits,gs,k", [(4, 40, 4000), (4, 344, 11008), (4, 10, 250),
                                       (8, 3, 249), (8, 72, 216)])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_stage_x_and_quantize_rows_lay_x_out(cuda, bits, gs, k, b):
    """The masked steps' x layout on the card: stage_x (bf16 x) bitwise its
    plain gather, and quantize_rows with the same index bitwise
    quantize_activation's codes gathered alike, its scales unchanged."""
    x = (torch.randn((b, k), generator=torch.Generator().manual_seed(k)) * 3).to(
        cuda, torch.bfloat16)
    index = qm.stage_index(bits, k, gs, cuda)
    out = qm.stage_x(x, index)
    q, sx = qm.quantize_rows(x, index)
    ref_q, ref_s = quantize_activation(x)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), qm._gather(x, index).view(torch.int16))
    assert torch.equal(q, qm._gather(ref_q, index)) and torch.equal(sx, ref_s)


@pytest.mark.parametrize("act_bits,gs", [(0, 96), (8, 128), (0, 40), (8, 48)])
def test_quant_matmul_new_paths_raise(cuda, monkeypatch, act_bits, gs):
    """A launch the kernel refuses (a batch tile it is not built for) on the
    odd-group, the W4A8 and both masked paths raises; nothing falls back."""
    k, n = 512 if 512 % gs == 0 else 480, 208
    qt = _qt(4, gs, k, n, act_bits, cuda)
    x = torch.randn((8, k), device=cuda).to(torch.bfloat16)
    monkeypatch.setattr(qm, "hopper_plan", lambda *a, **kw: (24, 2, 1, 1, 1))
    counts = (qm.launches, qm.group_route_launches, qm.w4a8_route_launches)
    with pytest.raises(RuntimeError, match="quant_matmul"):
        qm.quant_matmul(x, qt)
    assert counts == (qm.launches, qm.group_route_launches, qm.w4a8_route_launches)


@pytest.mark.parametrize("bits,gs,k", [(4, 128, 4096), (4, 96, 4032), (4, 40, 4000),
                                       (8, 128, 4096), (8, 24, 4032), (4, 0, 4096)])
@pytest.mark.parametrize("b", [1, 64, 72, 256])
def test_quant_matmul_f32_hopper(cuda, bits, gs, k, b):
    """f32 x on the Hopper kernel as three bf16 pieces at wo's width: one
    split and one matmul launch a call, counted in f32_launches and never
    on a bf16 route, within 1e-5 of the largest plain output, two calls
    bitwise equal."""
    n = 4096
    qt = _qt_codes(bits, gs or k, k, n, 0, cuda, seed=k + gs)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda)
    names = ("launches", "f32_launches", "split_launches", "group_route_launches",
             "odd_group_launches", "stage_launches")
    counts = [getattr(qm, c) for c in names]
    out = qm.quant_matmul(x, qt)
    again = qm.quant_matmul(x, qt)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    assert [getattr(qm, c) for c in names] == [counts[0] + 2, counts[1] + 2, counts[2] + 2,
                                               counts[3], counts[4], counts[5]]
    assert out.dtype == torch.float32 and out.shape == (b, n)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("bits,gs,k", [(4, 128, 4096), (4, 40, 4000), (8, 24, 4032),
                                       (4, 344, 11008)])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_split_x(cuda, bits, gs, k, b):
    """The split kernel bitwise its plain version, in order and in the
    masked steps' layout; its pieces add back to x in f32."""
    x = (torch.randn((b, k), generator=torch.Generator().manual_seed(k)) * 3).to(cuda)
    x[0, :4] = torch.tensor([0.0, -0.0, 3.4028234663852886e38, -1e-30])
    index = qm.stage_index(bits, k, gs, cuda) if qm.masked_group(gs) else None
    before = qm.split_launches
    out = qm.split_x(x, index)
    whole = qm.split_x(x)
    plain = qm.split_x_plain(x)
    torch.cuda.synchronize()
    assert qm.split_launches == before + 2
    assert torch.equal(whole.view(torch.int16), plain.view(torch.int16))
    if index is not None:
        want = torch.stack([qm._gather(t, index) for t in plain])
        assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    hi, mid, lo = whole.float()
    assert torch.equal(((hi + mid) + lo).view(torch.int32), x.view(torch.int32))


@pytest.mark.parametrize("k,n", _SHAPES_7B + [(4096, 100)])
@pytest.mark.parametrize("b", [1, 16, 17, 64])
@pytest.mark.parametrize("k_major", [True, False])
def test_w8a8_int_mm(cuda, k, n, b, k_major):
    """W8A8 on the card: the row kernel, then torch._int_mm on the codes
    (rows padded to 17 where B <= 16; codes K-major as quantize_param_tree
    stores them, or row-major) where K and N are multiples of 8, else the
    float64 contraction; the same bits as the float64 contraction scaled
    alike."""
    from tpuserve_torch.quant import core

    g = torch.Generator(device=cuda).manual_seed(k + n)
    q = torch.randint(-127, 128, (k, n), generator=g, device=cuda, dtype=torch.int32).to(
        torch.int8)
    if k_major:
        q = q.t().contiguous().t()
    qt = QTensor(q=q, scale=(torch.rand((1, n), generator=g, device=cuda) + 0.5) * 0.003,
                 bits=8, group_size=0, orig_shape=(k, n), act_bits=8)
    x = torch.randn((b, k), generator=g, device=cuda).to(torch.bfloat16)
    calls = (core.w8a8_int_mm_calls, core.w8a8_float64_calls)
    out = core._w8a8_matmul(x, qt)
    xq, sx = quantize_activation(x)
    acc = torch.matmul(xq.to(torch.float64), q.to(torch.float64))
    ref = (acc.to(torch.float32) * sx * qt.scale[0][None, :]).to(x.dtype)
    torch.cuda.synchronize()
    int_mm = n % 8 == 0
    assert (core.w8a8_int_mm_calls, core.w8a8_float64_calls) == (
        calls[0] + int_mm, calls[1] + (not int_mm))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bits,block_k", [(4, 128), (4, 256), (4, 512), (4, 1024), (4, 4096),
                                          (8, 64), (8, 512), (8, 1024)])
def test_quant_matmul_hopper_block_k(cuda, bits, block_k):
    """Each K split the sweep takes, in one launch: the last split of a tile
    adds the partials in split order, so the result is the same bits as a
    second call and within one bf16 step of the plain version. N = 1040:
    nine 128-column tiles, the last one partly past N."""
    k, n, b = 4096, 1040, 72
    qt = _qt(bits, 128, k, n, 0, cuda)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(7)).to(cuda, torch.bfloat16)
    out = qm.quant_matmul(x, qt, block_k=block_k)
    again = qm.quant_matmul(x, qt, block_k=block_k)
    ref = qm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 ** -7 * ref.float().abs().max().item(), err
    assert torch.equal(out, again)


# ---------------------------------------------------------------- TPUSERVE_ATTN_DYNSKIP
@pytest.mark.parametrize("entry,kind", [("flat", "int4"), ("flat", "int8"), ("flat", "bf16"),
                                        ("multi", "int8"), ("multi", "int4"),
                                        ("grouped", "int8"), ("grouped", "bf16")])
def test_dynskip_changes_no_output(cuda, monkeypatch, entry, kind):
    """The flat, multi and grouped kernels under TPUSERVE_ATTN_DYNSKIP=0
    (every block read, the rows past a slot masked) against =1 (those
    blocks skipped): masked rows add exact zeros, so the outputs agree to
    1e-6 of the range (expected equal), and both against the plain version."""
    s, hkv, l, n_layers, layer = 8, 2, 256, 2, 1
    h = hkv * (2 if kind != "bf16" else 1)
    k, v, ks, vs = _cache(kind, s, hkv, l, n_layers, cuda)
    g = torch.Generator().manual_seed(9)
    cands = 3 if entry == "multi" else 1
    shape = (s, cands, h, 128) if entry == "multi" else (s, h, 128)
    q = (torch.randn(shape, generator=g) / 128 ** 0.5).to(cuda, torch.bfloat16)
    pos = torch.randint(0, l - cands, (s,), generator=g, dtype=torch.int32)
    pos[1], pos[2], pos[4] = -1, 0, 40
    pos = pos.to(cuda)
    if entry == "flat":
        fns = (lambda: da.decode_attention_wide_cache(q, k, v, ks, vs, pos, layer, block_l=32),
               lambda: da.decode_attention_wide_cache_plain(q, k, v, ks, vs, pos, layer,
                                                            block_l=32))
    elif entry == "multi":
        fns = (lambda: da.decode_attention_wide_cache_multi(q, k, v, ks, vs, pos, layer,
                                                            block_l=32),
               lambda: da.decode_attention_wide_cache_multi_plain(q, k, v, ks, vs, pos, layer,
                                                                  block_l=32))
    else:
        kw, vw = (t[layer].view(s, l, hkv, 128) for t in (k, v))
        ksw = vsw = None
        if ks is not None:
            ksw, vsw = ks.transpose(1, 2), vs.transpose(1, 2)
        fns = (lambda: da.decode_attention(q, kw, vw, ksw, vsw, pos, block_l=32),
               lambda: da.decode_attention_plain(q, kw, vw, ksw, vsw, pos, block_l=32))
    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", mode)
        outs[mode] = (fns[0](), fns[1]())
    torch.cuda.synchronize()
    live = pos >= 0
    a, b = outs["0"][0][live], outs["1"][0][live]
    assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()
    tol = (1e-3 if entry == "grouped" else 2e-3) * outs["1"][1][live].abs().max().item() + 1e-6
    for mode in ("0", "1"):
        assert (outs[mode][0] - outs[mode][1])[live].abs().max().item() <= tol, mode


# ---------------------------------------------------------------- MoE experts
def _experts_codes(e_n, k, n, device, gs=128, seed=0):
    from tpuserve_torch.quant.core import QExperts

    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.empty((e_n, k // 2, n), dtype=torch.uint8, device=device)
    q.random_(0, 256, generator=g)
    scale = (torch.rand((e_n, k // gs, n), generator=g, device=device) + 0.5) * 0.003
    return QExperts(q=q, scale=scale, bits=4, group_size=gs, orig_shape=(e_n, k, n))


@pytest.mark.parametrize("k,n", [(4096, 28672), (14336, 4096)], ids=["gateup", "down"])
@pytest.mark.parametrize("b", [8, 16, 32, 64])
def test_quant_matmul_expert_views(cuda, k, n, b):
    """The kernel on views of a stack of int4 g128 experts at Mixtral-8x7B's
    widths (the codes of expert e at e*K/2*N bytes, its scales at
    e*groups*N*4): launched on the view itself, against the plain version
    within one bf16 step, two calls bitwise equal."""
    st = _experts_codes(3, k, n, cuda)
    x = torch.randn((b, k), generator=torch.Generator().manual_seed(b)).to(cuda, torch.bfloat16)
    for e in range(3):
        ex = st.expert(e)
        assert ex.q.data_ptr() == st.q.data_ptr() + e * (k // 2) * n
        assert ex.q.data_ptr() % 16 == 0 and ex.scale.data_ptr() % 16 == 0
        before = qm.launches
        out, again = qm.quant_matmul(x, ex), qm.quant_matmul(x, ex)
        ref = qm.quant_matmul_plain(x, ex)
        torch.cuda.synchronize()
        assert qm.launches == before + 2
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= 2 ** -7 * ref.float().abs().max().item(), (e, err)
        assert torch.equal(out, again)


@pytest.mark.parametrize("decode_t", ["64", "128"], ids=["dispatch", "dense"])
def test_moe_ffn_on_card(cuda, monkeypatch, decode_t):
    """llama._moe_ffn over 64 bf16 rows on int4 experts (dim 512, ffn 256,
    E=8, top-2), the kernel against the plain versions (the same routing:
    both paths compute the router in f32 from the same h): within two bf16
    steps of the output's range; 2E quant-matmul launches a call whatever
    the route."""
    from tpuserve_torch.models import llama

    monkeypatch.setenv("TPUSERVE_MOE_DECODE_DISPATCH_T", decode_t)
    p = llama.LlamaParams(dim=512, ffn_dim=256, n_experts=8, n_experts_per_tok=2)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = {"x/router/kernel": torch.randn((512, 8), generator=g, device=cuda),
              "x/moe_gateup/kernel": _experts_codes(8, 512, 512, cuda, seed=1),
              "x/moe_down/kernel": _experts_codes(8, 256, 512, cuda, seed=2)}
    h = torch.randn((64, 512), generator=g, device=cuda).to(torch.bfloat16)
    before = qm.launches
    out = llama._moe_ffn(params, "x", h, p)
    torch.cuda.synchronize()
    assert qm.launches == before + 16
    monkeypatch.setattr(llama, "qmatmul", qm.quant_matmul_plain)
    ref = llama._moe_ffn(params, "x", h, p)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 * 2 ** -8 * ref.float().abs().max().item(), err
