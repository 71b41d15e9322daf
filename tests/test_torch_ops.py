"""Kernel modules of tpuserve_torch against the Pallas kernels they replace.

On the CPU every wrapper runs its kernel's plain PyTorch version, which
repeats the kernel's algorithm step by step. Here it is held against the
Pallas kernel in interpret mode (the TPU kernel's own arithmetic), so the
two differ only in the order of float sums: tolerances are a few f32 ulps
of the output scale, far tighter than the 5e-2/1e-2 that
tests/test_decode_attention.py allows against its plain numpy reference.

tests/test_torch_cuda.py holds each CUDA kernel against its plain version
on the card. The dispatch tests at the end show, without a card, that a
CUDA tensor goes to the kernel (or raises) and never to the plain version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.device import smoke as jsmoke
from tpuserve.ops import decode_attention as jda
from tpuserve.ops import quant_matmul as jqm
from tpuserve.quant import core as jcore
from tpuserve_torch import kernels
from tpuserve_torch.device import smoke as tsmoke
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.ops import quant_matmul as tqm
from torch_parity import jax_qt_to_torch, to_np


# ------------------------------------------------------------ quant-matmul
QMM_CASES = [
    # (bits, group_size, K, N, act_bits, block_k for the Pallas call[, x dtype])
    (4, 128, 256, 384, 0, None),
    (4, 0, 256, 128, 0, None),       # one group spanning K
    (8, 128, 256, 384, 0, None),
    (8, 256, 512, 256, 0, 128),      # int8 group split across K blocks (gpb == 0)
    (8, 0, 256, 256, 0, None),       # per-channel int8
    (4, 128, 512, 256, 8, None),     # W4A8: int8 x int8 -> int32 per group
    # groups a 64-row stage cannot tile, bf16 x (the odd-group stages)
    (4, 48, 480, 256, 0, None, "bf16"),
    (4, 96, 480, 256, 0, None, "bf16"),
    (4, 112, 448, 256, 0, None, "bf16"),
    (8, 96, 480, 256, 0, None, "bf16"),
    # W4A8 on int8 wgmma: groups of a multiple of 32 (whole groups a stage)
    (4, 32, 512, 256, 8, None),
    (4, 64, 512, 256, 8, None),
    (4, 96, 480, 256, 8, None),
    # groups of no multiple of 16 values, bf16 x (the masked k16 steps)
    (4, 40, 480, 256, 0, None, "bf16"),
    (4, 12, 240, 256, 0, None, "bf16"),
    (8, 24, 480, 256, 0, None, "bf16"),
    (8, 40, 480, 256, 0, None, "bf16"),
    # W4A8 in groups of no multiple of 32 (the masked k32 steps)
    (4, 48, 480, 256, 8, None),
    (4, 20, 480, 256, 8, None),
    (4, 136, 272, 256, 8, None),
    # f32 x as three bf16 pieces on the Hopper kernel: groups the 64-row
    # stage cannot tile, and groups of no multiple of 16 (masked steps)
    (4, 48, 480, 256, 0, None, "f32"),
    (4, 96, 480, 256, 0, None, "f32"),
    (8, 96, 480, 256, 0, None, "f32"),
    (4, 40, 480, 256, 0, None, "f32"),
    (4, 12, 240, 256, 0, None, "f32"),
    (8, 24, 480, 256, 0, None, "f32"),
]


def _qmm_inputs(bits, gs, k, n, act_bits, b=5, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    x = rng.normal(size=(b, k)).astype(np.float32)
    qt = jcore.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    if act_bits:
        qt = dataclasses.replace(qt, act_bits=act_bits)
    return x, qt


@pytest.mark.parametrize("bits,gs,k,n,act_bits,block_k,xdt",
                         [c + ("f32",) * (7 - len(c)) for c in QMM_CASES],
                         ids=["-".join(map(str, c)) for c in QMM_CASES])
def test_quant_matmul_plain_matches_pallas(bits, gs, k, n, act_bits, block_k, xdt):
    x, qt = _qmm_inputs(bits, gs, k, n, act_bits)
    if xdt == "bf16":
        xb = jnp.asarray(x, jnp.bfloat16)
        ref = np.asarray(jqm.quant_matmul(xb, qt, interpret=True, block_k=block_k)).astype(
            np.float32)
        xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
        out = tqm.quant_matmul(xt, jax_qt_to_torch(qt))
        assert out.dtype == torch.bfloat16
        # both round an f32 sum of the same exact products to bf16: at most
        # one bf16 ulp apart
        np.testing.assert_allclose(to_np(out), ref, rtol=2 ** -7, atol=1e-6)
        return
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), qt, interpret=True, block_k=block_k))
    out = to_np(tqm.quant_matmul(torch.from_numpy(x), jax_qt_to_torch(qt)))
    # f32 sums of the same products in another order: ~1e-6 of |out| ~ 3
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _f32_specials():
    """f32 values the split must keep: random normals of many scales, every
    power of two from 2^-110 up with its neighbours at or above 2^-110,
    +-FLT_MAX, zeros of both signs."""
    rng = np.random.default_rng(5)
    fin = np.finfo(np.float32)
    pow2 = np.ldexp(np.float32(1), np.arange(-110, 128)).astype(np.float32)
    vals = [rng.normal(size=4096).astype(np.float32) * np.exp2(rng.integers(-100, 100, 4096)),
            pow2, np.nextafter(pow2[1:], np.float32(0)), np.nextafter(pow2, np.float32(np.inf)),
            np.array([fin.max, -fin.max, 0.0, -0.0], np.float32)]
    v = np.concatenate(vals).astype(np.float32)
    return np.concatenate([v, -v])


def test_f32_split_is_exact():
    """x = hi + mid + lo bitwise, three bf16 pieces added in f32, for every
    finite f32 of magnitude >= 2^-110 and for zeros (-0.0 stays -0.0):
    random values of many scales, powers of two and their neighbours,
    +-FLT_MAX."""
    x = torch.from_numpy(_f32_specials())
    assert torch.isfinite(x).all()
    pieces = tqm.split_x(x[None])
    assert pieces.dtype == torch.bfloat16 and tuple(pieces.shape) == (3, 1, x.numel())
    hi, mid, lo = pieces.float()[:, 0]
    back = (hi + mid) + lo
    assert torch.equal(back.view(torch.int32), x.view(torch.int32))


def test_f32_split_of_denormals_keeps_bf16s_finest_step():
    """Below 2^-110 three bf16 pieces cannot hold every bit (bf16's finest
    step is 2^-133, an f32 denormal's 2^-149): the split keeps every bit at
    or above 2^-133 and drops the rest, and x's that bf16 holds (and every
    zero) come back bitwise."""
    rng = np.random.default_rng(6)
    bits = rng.integers(1, 1 << 23, size=4096).astype(np.uint32)   # every f32 denormal kind
    bits[:256] = (bits[:256] | 1 << 16) & 0xFFFF0000                   # and ones bf16 holds
    small = np.concatenate([bits.view(np.float32),
                            np.ldexp(rng.uniform(1, 2, 4096), rng.integers(-126, -110, 4096))
                            .astype(np.float32)])
    x = torch.from_numpy(np.concatenate([small, -small]))
    hi, mid, lo = tqm.split_x(x[None]).float()[:, 0]
    back = (hi + mid) + lo
    step = 2.0 ** -133
    kept = torch.from_numpy(np.trunc(x.double().numpy() / step) * step)   # bits >= 2^-133
    assert torch.equal(back.double(), kept)
    assert ((x.double() - back.double()).abs() < step).all()
    held = x.to(torch.bfloat16).float() == x
    assert held.any() and torch.equal(back[held].view(torch.int32), x[held].view(torch.int32))


@pytest.mark.parametrize("bits,gs,k", [(4, 40, 480), (8, 24, 480), (4, 136, 272)])
def test_f32_split_in_the_masked_layout(bits, gs, k):
    """split_x with stage_index: each piece laid out as stage_x lays bf16 x
    out (the plain gather), the pieces those of x in order."""
    x = torch.from_numpy(np.random.default_rng(gs).normal(size=(3, k)).astype(np.float32))
    index = tqm.stage_index(bits, k, gs, "cpu")
    laid = tqm.split_x(x, index)
    whole = tqm.split_x(x)
    assert tuple(laid.shape) == (3, 3, index.numel())
    for p in range(3):
        assert torch.equal(laid[p], tqm._gather(whole[p], index))


def test_quant_matmul_bf16_and_leading_dims():
    """bf16 activations (exact products, f32 sums, one rounding to bf16) and
    [.., K] inputs flattened into the batch and restored."""
    x, qt = _qmm_inputs(4, 128, 256, 256, 0, b=6, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16).reshape(2, 3, 256)
    ref = np.asarray(jqm.quant_matmul(xb, qt, interpret=True)).astype(np.float32)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    out = tqm.quant_matmul(xt, jax_qt_to_torch(qt))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 3, 256)
    # both round the same f32 sum to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(to_np(out), ref, rtol=2 ** -7, atol=1e-6)


# ------------------------------------------------------------ decode attention
def _attn_inputs(kind, s=4, h=4, hkv=2, l=64, n_layers=2, scale_dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    hd = 128
    w = hkv * hd
    q = (rng.normal(size=(s, h, hd)) / np.sqrt(hd)).astype(np.float32)
    if kind == "int8":
        k = rng.integers(-127, 128, size=(n_layers, s, l, w)).astype(np.int8)
        v = rng.integers(-127, 128, size=(n_layers, s, l, w)).astype(np.int8)
    elif kind == "int4":
        k = rng.integers(0, 256, size=(n_layers, s, l, w // 2)).astype(np.uint8)
        v = rng.integers(0, 256, size=(n_layers, s, l, w // 2)).astype(np.uint8)
    else:
        k = rng.normal(size=(n_layers, s, l, w)).astype(np.float32)
        v = rng.normal(size=(n_layers, s, l, w)).astype(np.float32)
    ks = vs = None
    if kind in ("int8", "int4"):
        ks = (rng.uniform(0.5, 1.5, size=(s, hkv, l)) * 0.01).astype(scale_dtype)
        vs = (rng.uniform(0.5, 1.5, size=(s, hkv, l)) * 0.01).astype(scale_dtype)
    return q, k, v, ks, vs


def _run_both(kind, q, k, v, ks, vs, pos, layer, **kw):
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    jsc = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    tsc = [None if a is None else torch.from_numpy(np.asarray(a, np.float32)) for a in (ks, vs)]
    if ks is not None and ks.dtype != np.float32:  # bf16 scales
        tsc = [t.to(torch.bfloat16) for t in tsc]
    ref = np.asarray(jda.decode_attention_wide_cache(
        jnp.asarray(q), jk, jv, *jsc, jnp.asarray(pos), layer, interpret=True, **kw))
    out = to_np(tda.decode_attention_wide_cache(
        torch.from_numpy(q), tk, tv, *tsc, torch.from_numpy(pos), layer, **kw))
    return out, ref


ATTN_CASES = [
    # (kind, layer, window, block_l): block_l=16 takes the L-blocked online
    # softmax (_wide_kernel); the default at this size is the TPU's
    # multi-slot packing (_packed_kernel), one plain softmax per row
    ("int8", 1, None, 16),
    ("int8", 0, None, None),   # packed (2b)
    ("int8", 1, 32, 16),       # window < L
    ("int4", 1, None, 16),
    ("int4", 0, 32, None),
    ("f32", 1, None, 16),
    ("f32", 0, None, None),    # packed (2b), float cache
    ("bf16", 1, None, 32),
]


@pytest.mark.parametrize("kind,layer,window,block_l", ATTN_CASES)
def test_decode_attention_plain_matches_pallas(kind, layer, window, block_l):
    q, k, v, ks, vs = _attn_inputs(kind)
    win = window or k.shape[2]
    pos = np.array([5, -1, win - 1, win // 2], np.int32)  # slot 1 inactive
    out, ref = _run_both(kind, q, k, v, ks, vs, pos, layer, window=window, block_l=block_l)
    # same algorithm (int32 dots, same requant points): f32 ulps of |out| <= ~2
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)


def test_decode_attention_bf16_scales_and_gqa():
    """bf16 head-major scales (the serving default) and rep = 4 query heads
    per kv head."""
    q, k, v, ks, vs = _attn_inputs("int8", h=8, hkv=2, scale_dtype=jnp.bfloat16, seed=3)
    pos = np.array([0, 63, 17, -1], np.int32)
    out, ref = _run_both("int8", q, k, v, ks, vs, pos, 1, block_l=32)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)


def test_decode_attention_packed_whole_row():
    """The TPU's packed case (_packed_kernel) where it differs from the
    L-blocked one: at L=256 and W=256, win*W*sb < 1 MiB, so P is requantized
    once over the whole 256-row window instead of once per 128-row block."""
    q, k, v, ks, vs = _attn_inputs("int8", s=4, h=8, hkv=2, l=256, seed=5)
    geometry = tda._geometry(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(ks),
                             None, None)
    assert geometry["block_l"] == 256
    pos = np.array([200, -1, 255, 130], np.int32)  # every live slot spans both halves
    out, ref = _run_both("int8", q, k, v, ks, vs, pos, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)


@pytest.fixture()
def dynskip_env(monkeypatch):
    """Set TPUSERVE_ATTN_DYNSKIP for one test; JAX reads it when it traces,
    so its caches are cleared around the change."""
    import jax

    def set_mode(mode):
        monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", mode)
        jax.clear_caches()

    yield set_mode
    jax.clear_caches()


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dyn", ["0", "1"])
@pytest.mark.parametrize("s,hkv,l,block_l", [(2, 2, 256, 64), (4, 4, 512, 128)])
def test_decode_attention_split_window_matches_pallas(dynskip_env, kind, dyn, s, hkv, l,
                                                      block_l):
    """The Hopper core's split plan at small grids: the window is cut into
    runs of whole blocks, each with its own online softmax, merged in
    order. The plain version, which takes the same plan, against the Pallas
    kernel (one online softmax over the window) under either dynskip: the
    same requant points per block, so f32 ulps of |out|. The cache holds a
    block past the window, so int8 never takes the one-block packed form."""
    dynskip_env(dyn)
    q, k, v, ks, vs = _attn_inputs(kind, s=s, h=hkv, hkv=hkv, l=l + block_l, seed=7 + s)
    g = tda._geometry(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(ks), l,
                      block_l)
    splits, bps = tda._core_plan(g, torch.device("cpu"))
    assert splits >= 2 and splits * bps >= l // block_l
    pos = np.array([l - 1, -1, block_l, 3][:s], np.int32)
    out, ref = _run_both(kind, q, k, v, ks, vs, pos, 1, window=l, block_l=block_l)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("units,s,n_blocks,want", [
    (16, 64, 2, 1),     # the slice: 1024 blocks fill the card
    (32, 64, 2, 1),     # the paged slice: 2048
    (32, 8, 4, 2),      # the spec cell: 256 blocks, two splits of two blocks
    (2, 16, 1, 1),      # a window that is one block cannot split
    (2, 2, 4, 4),       # a tiny grid: a block a split
    (1, 1, 7, 7)])
def test_split_plan(units, s, n_blocks, want):
    splits, bps = tda.split_plan(units, s, n_blocks, 132)
    assert splits == want and (splits - 1) * bps < n_blocks <= splits * bps


def test_vector_add_plain_matches_pallas():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(1000,)).astype(np.float32)
    b = rng.normal(size=(1000,)).astype(np.float32)
    ref = np.asarray(jsmoke.vector_add(jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = to_np(tsmoke.vector_add(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_array_equal(out, ref)
    assert tsmoke.run_smoke_test(4096, device="cpu")


VADD_DTYPES = ["float32", "bfloat16", "float16", "int32", "int16", "int8", "uint8"]
_BITS = {"float32": torch.int32, "bfloat16": torch.int16, "float16": torch.int16}


def _vadd_inputs(dtype, n, seed):
    """Two vectors of `dtype` from a seed, as (jax, torch) pairs: floats of
    mixed magnitudes rounded to the type by both sides alike, integers
    over the type's full range (so that sums wrap)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(2):
        if dtype in _BITS:
            v = (rng.normal(size=n) * np.exp2(rng.integers(-6, 7, size=n))).astype(np.float32)
            pairs.append((jnp.asarray(v).astype(dtype), torch.from_numpy(v).to(getattr(torch, dtype))))
        else:
            info = np.iinfo(dtype)
            v = rng.integers(info.min, int(info.max) + 1, size=n, dtype=dtype)
            pairs.append((jnp.asarray(v), torch.from_numpy(v)))
    return pairs


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 33000])
@pytest.mark.parametrize("dtype", VADD_DTYPES)
def test_vector_add_dtypes_match_pallas(dtype, n):
    """The JAX vector_add adds every dtype jnp has with x64 off; the port
    takes the same seven and gives the same bits (integers wrap, floats
    round once), at lengths that are and are not multiples of its
    (256, 128) block."""
    (ja, ta), (jb, tb) = _vadd_inputs(dtype, n, seed=n)
    ref = jsmoke.vector_add(ja, jb, interpret=True)
    out = tsmoke.vector_add(ta, tb)
    assert out.dtype == ta.dtype and out.shape == (n,)
    if dtype in _BITS:   # compare bit patterns: exact, signed zeros included
        ref_bits = np.asarray(ref).view(np.int32 if dtype == "float32" else np.int16)
        np.testing.assert_array_equal(out.view(_BITS[dtype]).numpy(), ref_bits)
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float64", "int64", "bool", "complex64"])
def test_vector_add_refuses_other_dtypes(dtype):
    a = torch.zeros(8, dtype=getattr(torch, dtype))
    with pytest.raises(ValueError, match="float32, bfloat16, float16, int32, int16, int8, uint8"):
        tsmoke.vector_add(a, a)


def test_vector_add_refuses_mixed_dtypes():
    with pytest.raises(ValueError, match="one dtype"):
        tsmoke.vector_add(torch.zeros(8), torch.zeros(8, dtype=torch.bfloat16))


# ------------------------------------------------------------ dispatch
class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to reach the
    wrappers' kernel branch on a machine without a card."""

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            return self.rc
        return fn


def _plain_must_not_run(*a, **kw):
    raise AssertionError("plain version taken for a CUDA tensor")


@pytest.mark.parametrize("rc", [0, 700])
def test_cuda_tensors_launch_the_kernel_or_raise(monkeypatch, rc):
    fake = _FakeLib(rc)
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "check", lambda code, what: (
        None if code == 0 else (_ for _ in ()).throw(RuntimeError(f"{what}: {code}"))))
    monkeypatch.setattr(tqm, "quant_matmul_plain", _plain_must_not_run)
    monkeypatch.setattr(tda, "decode_attention_wide_cache_plain", _plain_must_not_run)
    monkeypatch.setattr(tsmoke, "vector_add_plain", _plain_must_not_run)

    x, qt = _qmm_inputs(4, 128, 256, 128, 0)
    q, k, v, ks, vs = _attn_inputs("int8")
    fc = lambda a: torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(np.asarray(a)))
    calls = [
        lambda: tqm.quant_matmul(fc(x), jax_qt_to_torch(qt)),
        lambda: tda.decode_attention_wide_cache(
            fc(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ks),
            torch.from_numpy(vs), torch.zeros(4, dtype=torch.int32), 0),
        lambda: tsmoke.vector_add(fc(x[0]), fc(x[1])),
    ]
    counts = (tqm.launches, tda.launches, tsmoke.launches)
    for call in calls:
        if rc == 0:
            call()
        else:
            with pytest.raises(RuntimeError):
                call()
    # f32 x is split into three bf16 pieces for the Hopper quant-matmul (a
    # failing split raises before the matmul); an int8 cache takes the
    # Hopper decode-attention core
    qmm_calls = ["tpuserve_split_x", "tpuserve_quant_matmul_bf16"] if rc == 0 else \
        ["tpuserve_split_x"]
    assert fake.calls == qmm_calls + ["tpuserve_decode_attention_core", "tpuserve_vector_add"]
    grew = 1 if rc == 0 else 0
    assert (tqm.launches, tda.launches, tsmoke.launches) == tuple(c + grew for c in counts)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On the CPU no kernel library is built or called."""
    def no_lib():
        raise AssertionError("kernel library reached for a CPU tensor")

    monkeypatch.setattr(kernels, "lib", no_lib)
    x, qt = _qmm_inputs(8, 128, 256, 128, 0)
    before = (tqm.launches, tda.launches)
    tqm.quant_matmul(torch.from_numpy(x), jax_qt_to_torch(qt))
    q, k, v, ks, vs = _attn_inputs("int4")
    tda.decode_attention_wide_cache(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(ks),
                                    torch.from_numpy(vs), torch.zeros(4, dtype=torch.int32), 0)
    assert (tqm.launches, tda.launches) == before


class _RecordingLib:
    """A kernel library that records each call's arguments and succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.mark.parametrize("offsets,want", [((0, 0), tsmoke.VECTOR), ((1, 1), tsmoke.VECTOR),
                                          ((1, 3), tsmoke.SCALAR), ((0, 2), tsmoke.SCALAR)])
@pytest.mark.parametrize("dtype", VADD_DTYPES)
def test_vector_add_passes_dtype_and_route(monkeypatch, dtype, offsets, want):
    """A CUDA tensor of each dtype reaches the C entry once, with the
    dtype's code and the route its alignments allow: views that share an
    alignment modulo 16 (a[1:], b[1:]) keep the vector route, with out
    allocated at the same alignment; views that do not (a[1:], b[3:]) take
    the scalar route. The plain version is never taken."""
    fake = _RecordingLib()
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "check", lambda code, what: None)
    monkeypatch.setattr(tsmoke, "vector_add_plain", _plain_must_not_run)
    n = 100
    base = torch.zeros(n + 8, dtype=getattr(torch, dtype))
    assert base.data_ptr() % 16 == 0
    a, b = (torch.Tensor._make_subclass(_FakeCuda, base.clone()[o:o + n]) for o in offsets)
    before = tsmoke.launches
    out = tsmoke.vector_add(a, b)
    assert tsmoke.launches == before + 1
    (name, args), = fake.calls
    assert name == "tpuserve_vector_add"
    pa, pb, po, count, code, route, _ = args
    assert (pa, pb, po, count) == (a.data_ptr(), b.data_ptr(), out.data_ptr(), n)
    assert tsmoke.DTYPES[code] == getattr(torch, dtype) and route == want
    assert out.shape == (n,) and out.dtype == a.dtype
    if want == tsmoke.VECTOR:
        assert po % 16 == pa % 16 == pb % 16
