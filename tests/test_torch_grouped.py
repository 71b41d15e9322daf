"""The decode-attention mode switch of tpuserve_torch (TPUSERVE_DECODE_ATTN)
against the JAX package: the grouped kernel's plain version
(`ops.decode_attention`) against the TPU's `_kernel` in interpret mode, the
prebuilt-Q_wide entry (`decode_attention_wide`) against `_wide_kernel`,
decode_step, verify_step and decode_step_paged under "grouped" and "xla"
against the JAX package's branches, and the engine's greedy tokens in all
three modes. Also: the constructors that default to the card refuse to run
without one.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_decode_attention.py does); caches cross as numpy bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserve.ops.decode_attention as jda
from tpuserve.models import llama as jllama
from tpuserve.serving import paged_kv as jpkv
from tpuserve_torch import interop, kernels
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving import paged_kv as tpkv
from tpuserve_torch.serving import sampling as tsampling
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, numpy_weights, to_np, write_model

P_J = jllama.LlamaParams(**SMALL)
P_T = tllama.LlamaParams(**SMALL)
HD = 128


def _attn_inputs(kind, rep, s=4, l=128, n_kv=4, seed=0):
    """q [S, H, hd] f32 (scaled), k/v [S, L, Hkv, hd], scales [S, L, Hkv]
    f32 or None, positions with an inactive slot, 0 and L-1."""
    rng = np.random.default_rng(seed)
    h = n_kv * rep
    q = (rng.normal(size=(s, h, HD)) / np.sqrt(HD)).astype(np.float32)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, size=(s, l, n_kv, HD)).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.002, 0.02, size=(s, l, n_kv)).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=(s, l, n_kv, HD)).astype(np.float32) for _ in range(2))
        if kind == "bf16":
            k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (k, v))
        ks = vs = None
    positions = np.array([-1, 0, l - 1, 77][:s], np.int32)
    return q, k, v, ks, vs, positions


def _torch(a):
    return None if a is None else interop.tensor_from_numpy(np.asarray(a), "cpu")


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _range_close(out, ref, rel, what):
    tol = rel * float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


# The integer score dots are exact on both sides and P is rounded to bf16 at
# the same point; the sides differ in the order of f32 sums and in exp()
# by an ulp, which can tip one P entry across a bf16 rounding boundary
# (2^-8 of that entry). Measured up to 2.8e-7 of the output range; bound
# 1e-3, one such tip. Where the grid is small (these tests' S and Hkv) the
# int8 and packed int4 routes split the window as the Hopper kernel does,
# and a run rounds P at its own max: measured up to 5.3e-4 of the range in
# these tests (test_grouped_plain_matches_pallas, int8, rep 4).
_ATTN_TOL = 1e-3


def _grouped_pair(inputs, block_l, g_kv):
    """(port's plain version, JAX's `_kernel` in interpret mode)."""
    q, k, v, ks, vs, positions = inputs
    ref = np.asarray(jda.decode_attention(*map(_jax, inputs), block_l=block_l, g_kv=g_kv,
                                          interpret=True))
    out = to_np(tda.decode_attention(*map(_torch, inputs), block_l=block_l, g_kv=g_kv))
    assert out.shape == ref.shape == q.shape
    assert np.all(out[0] == 0.0), "the inactive slot is not exactly 0"
    return out, ref


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_grouped_plain_matches_pallas(kind, rep):
    """decode_attention_plain against the TPU's grouped `_kernel` in
    interpret mode over L=128: block_l 32 (four blocks) with one kv head a
    block, and block_l 256 (clipped to one block) with all Hkv heads in one
    block. Positions -1 (exactly 0 out), 0, L-1 and 77."""
    inputs = _attn_inputs(kind, rep)
    for block_l, g_kv in ((32, 1), (256, inputs[1].shape[2])):
        out, ref = _grouped_pair(inputs, block_l, g_kv)
        _range_close(out, ref, _ATTN_TOL, f"{kind} rep {rep} block_l {block_l} g_kv {g_kv}")


def test_grouped_kv_split_changes_no_value():
    """g_kv 1, 2 and Hkv: the JAX kernel's head groups agree with each
    other within f32 summation order (its masked head pairs add exact
    zeros; measured equal), and the port's plain version with each."""
    inputs = _attn_inputs("int8", 2)
    pairs = [_grouped_pair(inputs, 32, g_kv) for g_kv in (1, 2, inputs[1].shape[2])]
    for out, ref in pairs:
        _range_close(out, ref, _ATTN_TOL, "g_kv split")
        _range_close(ref, pairs[0][1], 1e-6, "JAX g_kv splits")


def _packed_inputs(rep, s=4, l=128, n_kv=4, seed=0):
    """q [S, H, hd] f32 (scaled), packed int4 k/v [S, L, Hkv*hd/2] (random
    bytes: every nibble code), head-major f32 scales [S, Hkv, L], positions
    with an inactive slot, 0 and L-1."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(s, n_kv * rep, HD)) / np.sqrt(HD)).astype(np.float32)
    k, v = (rng.integers(0, 256, size=(s, l, n_kv * HD // 2)).astype(np.uint8) for _ in range(2))
    ks, vs = (rng.uniform(0.05, 0.3, size=(s, n_kv, l)).astype(np.float32) for _ in range(2))
    return q, k, v, ks, vs, np.array([-1, 0, l - 1, 77][:s], np.int32)


def _jax_packed_reference(inputs, block_l):
    """The JAX package's grouped path over a packed window: its
    unpack_kv_codes, then decode_attention (`_kernel` in interpret mode)
    with the [S, L, Hkv] scale views."""
    q, k, v, ks, vs, positions = inputs
    s, l = k.shape[:2]
    n_kv = ks.shape[1]
    k8, v8 = (jllama.unpack_kv_codes(jnp.asarray(a)).reshape(s, l, n_kv, HD) for a in (k, v))
    return np.asarray(jda.decode_attention(
        jnp.asarray(q), k8, v8, jnp.asarray(ks.transpose(0, 2, 1)),
        jnp.asarray(vs.transpose(0, 2, 1)), jnp.asarray(positions), block_l=block_l, g_kv=1,
        interpret=True))


@pytest.fixture()
def dynskip_env(monkeypatch):
    """Set TPUSERVE_ATTN_DYNSKIP for both packages; JAX reads it when it
    traces, so its caches are cleared around the change."""
    def set_skip(val):
        monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", val)
        jax.clear_caches()

    yield set_skip
    jax.clear_caches()


@pytest.mark.parametrize("skip", ["0", "1"])
@pytest.mark.parametrize("rep", [1, 4])
def test_packed_route_plain_matches_pallas(dynskip_env, rep, skip):
    """The packed int4 route's plain version (decode_attention_packed on
    CPU tensors) against the JAX package's unpack_kv_codes followed by its
    grouped `_kernel` in interpret mode: L=128, block_l 32, rep 1 and 4, an
    inactive slot (exactly 0), under TPUSERVE_ATTN_DYNSKIP 0 and 1, within
    _ATTN_TOL. It is today's CPU path bit for bit: unpack_kv_codes, then
    decode_attention."""
    dynskip_env(skip)
    inputs = _packed_inputs(rep)
    q, k, v, ks, vs, positions = (_torch(a) for a in inputs)
    ref = _jax_packed_reference(inputs, 32)
    before = tda.grouped_launches
    out = to_np(tda.decode_attention_packed(q, k, v, ks, vs, positions, block_l=32))
    assert tda.grouped_launches == before   # the plain version on the CPU
    assert out.shape == ref.shape == inputs[0].shape
    assert np.all(out[0] == 0.0), "the inactive slot is not exactly 0"
    _range_close(out, ref, _ATTN_TOL, f"packed rep {rep} dynskip {skip}")
    s, l, n_kv = k.shape[0], k.shape[1], ks.shape[1]
    k8, v8 = (tda.unpack_kv_codes(t).view(s, l, n_kv, HD) for t in (k, v))
    today = to_np(tda.decode_attention(q, k8, v8, ks.transpose(1, 2), vs.transpose(1, 2),
                                       positions, block_l=32))
    np.testing.assert_array_equal(out, today)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16", "f32", "bf16_q"])
def test_grouped_split_plan_matches_pallas(kind):
    """Where the grid is small the grouped Hopper kernel splits the window
    (split_plan over Hkv heads of S slots, whatever the route and g_kv) and
    its plain version takes the same plan: at S=3, Hkv=2, L=256, block_l 32
    the window is cut into eight runs of one block, each with its own
    online softmax, merged in order. Against the TPU's `_kernel` (one online
    softmax over the window) within _ATTN_TOL: a run rounds P to bf16 at its
    own max, which moves an output by bf16 roundings (measured 3.4e-4 of the
    range for int8, 2.0e-4 for int4). g_kv 1 and Hkv give the same values.
    The float windows (bf16 with an f32 q, and bf16_q: with a bf16 q; f32)
    split alike, unscaled (measured 1.9e-4, 1.5e-4 and 4.6e-8 of the range:
    an f32 window rounds no P)."""
    s, l, n_kv, rep = 3, 256, 2, 2   # positions -1, 0, 255
    if kind != "int4":
        inputs = _attn_inputs(kind[:4], rep, s=s, l=l, n_kv=n_kv, seed=4)
        if kind == "bf16_q":
            inputs = (np.asarray(jnp.asarray(inputs[0], jnp.bfloat16)),) + inputs[1:]
        ref = np.asarray(jda.decode_attention(*map(_jax, inputs), block_l=32, g_kv=1,
                                              interpret=True))
        q, k, v, ks, vs, positions = map(_torch, inputs)
        entry = tda.decode_attention
    else:
        inputs = _packed_inputs(rep, s=s, l=l, n_kv=n_kv, seed=4)
        ref = _jax_packed_reference(inputs, 32)
        q, k, v, ks, vs, positions = map(_torch, inputs)
        entry = tda.decode_attention_packed
    g = tda._grouped_dims(q, l, n_kv, kind in ("int8", "int4"), ks is not None, 32)
    assert (g["splits"], g["bps"]) == (8, 1)
    outs = [to_np(entry(q, k, v, ks, vs, positions, block_l=32, g_kv=g_kv))
            for g_kv in (1, n_kv)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.all(outs[0][0] == 0.0)
    _range_close(outs[0], ref, _ATTN_TOL, f"{kind} split")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to reach the
    wrappers' kernel branch on a machine without a card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("skip", ["0", "1"])
@pytest.mark.parametrize("route", ["int8", "int4", "bf16", "f32"])
def test_grouped_cuda_tensors_pass_the_route_arguments(monkeypatch, route, skip):
    """A CUDA tensor reaches the grouped Hopper kernel's C entry once, with
    the window read in place (its own pointer, slot and row strides in
    bytes), the head-major scale strides (an unscaled float window: null
    scales), the launch code (1 packed int4, 0 int8, 2 bf16, 3 f32; +16
    under TPUSERVE_ATTN_DYNSKIP=0), the query heads a unit and the split
    plan, with a workspace only where it splits, the same for g_kv 1 and 4
    (one unit a block whatever g_kv); no plain version and no unpack runs."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    def must_not_run(*a, **kw):
        raise AssertionError("plain version or unpack for a CUDA tensor")

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "check", lambda code, what: None)
    for name in ("decode_attention_plain", "decode_attention_packed_plain", "unpack_kv_codes"):
        monkeypatch.setattr(tda, name, must_not_run)
    monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", skip)
    fc = lambda t: torch.Tensor._make_subclass(_FakeCuda, t)
    n_layers, s, l_max, win, n_kv, rep, layer = 2, 4, 256, 128, 4, 2, 1
    wst = n_kv * HD // (2 if route == "int4" else 1)
    dtype = {"int4": torch.uint8, "int8": torch.int8, "bf16": torch.bfloat16,
             "f32": torch.float32}[route]
    esz = torch.tensor([], dtype=dtype).element_size()
    floating = route in ("bf16", "f32")
    cache = torch.zeros((n_layers, s, l_max, wst), dtype=dtype)
    scales = torch.ones((n_layers, s, n_kv, l_max), dtype=torch.bfloat16)
    q = fc(torch.zeros((s, n_kv * rep, HD)))
    kw, vw = (fc(cache[layer, :, :win]) for _ in range(2))
    ksw, vsw = (fc(scales[layer, :, :, :win]) for _ in range(2))
    pos = fc(torch.tensor([-1, 0, 127, 40], dtype=torch.int32))
    before = tda.grouped_launches
    for g_kv in (1, 4):
        if route == "int4":
            out = tda.decode_attention_packed(q, kw, vw, ksw, vsw, pos, block_l=32, g_kv=g_kv)
        else:
            out = tda.decode_attention(q, kw.view(s, win, n_kv, HD), vw.view(s, win, n_kv, HD),
                                       None if floating else ksw.transpose(1, 2),
                                       None if floating else vsw.transpose(1, 2), pos,
                                       block_l=32, g_kv=g_kv)
        assert out.shape == q.shape and out.dtype == torch.float32
        name, args = calls[-1]
        assert name == "tpuserve_decode_attention_grouped_hopper"
        assert args[1] == kw.data_ptr()
        ws, cnt = args[7], args[8]
        assert args[9] == l_max * wst * esz                          # slot stride (bytes)
        if floating:                                                 # null scales
            assert args[3] == args[4] == 0 and args[10:12] == (0, 0) and args[13] == 0
        else:                                                        # scale strides, bf16
            assert args[3] == ksw.data_ptr() and args[10:12] == (n_kv * l_max, l_max)
            assert args[13] == 1
        assert args[12] == 0                                         # f32 q
        assert args[14:20] == (s, n_kv * rep, n_kv, win, 32, wst * esz)
        kind, nq, splits, bps = args[20:24]
        assert kind == {"int8": 0, "int4": 1, "bf16": 2, "f32": 3}[route] + (16 if skip == "0"
                                                                               else 0)
        assert nq == (2 * rep if route == "int4" else rep)
        assert (splits, bps) == tda.split_plan(n_kv, s, win // 32, 132) == (4, 1)
        assert (ws != 0) == (cnt != 0) == (splits > 1)
    assert tda.grouped_launches == before + 2


@pytest.mark.parametrize("name", ["base", "s2b6", "s4b3", "s6b2", "no_convert", "no_pv"])
def test_grouped_ablations_still_match_the_kernel_source(name):
    """Each variant of scripts/grouped_ablate.py applies to the grouped
    kernel's source as it is (csrc/attention_grouped.cuh; the script runs
    only on the card; this keeps it in step)."""
    from tpuserve_torch.scripts import grouped_ablate

    assert list(grouped_ablate.PATCHES) == ["base", "s2b6", "s4b3", "s6b2", "no_convert",
                                            "no_pv"]
    src = grouped_ablate.patched(name)
    assert "attn_grouped_kernel" in src
    base = (kernels.CSRC / grouped_ablate.SOURCE).read_text()
    assert (name == "base") == (src == base)


def test_grouped_ablate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from tpuserve_torch.scripts import grouped_ablate

    with pytest.raises(SystemExit, match="needs the card"):
        grouped_ablate.main([])


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_wide_plain_matches_pallas(kind):
    """decode_attention_wide's plain version (the flat kernel's, over a
    one-layer view) against the TPU's prebuilt-Q_wide `_wide_kernel` in
    interpret mode, block_l 32 and 256. Same requant points and exact
    integer dots; an ulp of exp() can tip one P code (int8: one P step is
    pmax/127): bound 2e-3 of the range, as the flat kernel's parity test."""
    q, k, v, ks, vs, positions = _attn_inputs(kind, 2)
    if ks is not None:   # the wide entry takes head-major [S, Hkv, L] scales
        ks, vs = ks.transpose(0, 2, 1).copy(), vs.transpose(0, 2, 1).copy()
    for block_l in (32, 256):
        ref = np.asarray(jda.decode_attention_wide(
            _jax(q), _jax(k), _jax(v), _jax(ks), _jax(vs), _jax(positions), block_l=block_l,
            interpret=True))
        out = to_np(tda.decode_attention_wide(*map(_torch, (q, k, v, ks, vs, positions)),
                                              block_l=block_l))
        assert np.all(out[0] == 0.0)
        _range_close(out, ref, 2e-3, f"wide {kind} block_l {block_l}")


def test_constructors_default_to_the_card():
    """KVCache.create, PagedKVCache.create and SamplingParams.create run on
    the card unless asked for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    for make in (lambda: tllama.KVCache.create(P_T, 2, 16, quantized=True),
                 lambda: tpkv.PagedKVCache.create(P_T, 4, 16, quantized=True),
                 lambda: tsampling.SamplingParams.create(2)):
        with pytest.raises(BackendError, match="device='cpu'"):
            make()
    assert tllama.KVCache.create(P_T, 2, 16, quantized=True, device="cpu").k.device.type == "cpu"


# ------------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def weights():
    """f32 weights (no quantization: the point is attention); both packages
    get the same numpy arrays."""
    w = numpy_weights()
    return {k: jnp.asarray(a) for k, a in w.items()}, interop.params_from_numpy(w, "cpu")


def _cache_bytes(kind, slots, max_len, seed=3):
    """Random cache state in the flat layout: k/v [n_layers, S, L, W (W/2
    packed int4)], head-major f32 scales [n_layers, S, Hkv, L] or None."""
    rng = np.random.default_rng(seed)
    n_layers, n_kv = SMALL["n_layers"], SMALL["n_kv_heads"]
    w = n_kv * HD
    shape = (n_layers, slots, max_len, w)
    if kind == "int4":
        k, v = (rng.integers(0, 256, size=shape[:-1] + (w // 2,)).astype(np.uint8)
                for _ in range(2))
    elif kind == "int8":
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
    else:
        k, v = (np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)) for _ in range(2))
    ks = vs = None
    if kind != "bf16":
        hi = 0.3 if kind == "int4" else 0.02
        ks, vs = (rng.uniform(hi / 4, hi, size=(n_layers, slots, n_kv, max_len))
                  .astype(np.float32) for _ in range(2))
    return k, v, ks, vs


def _jax_cache(k, v, ks, vs, flat):
    if not flat:
        k, v = (a.reshape(a.shape[:3] + (SMALL["n_kv_heads"], HD)) for a in (k, v))
    return jllama.KVCache(k=_jax(k), v=_jax(v), k_scale=_jax(ks), v_scale=_jax(vs), flat=flat)


@pytest.fixture()
def jax_mode(monkeypatch):
    """Put the JAX package in a decode-attention mode, its kernels in
    interpret mode."""
    def set_mode(mode):
        monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: mode)
        for name in ("decode_attention", "decode_attention_wide_cache",
                     "decode_attention_wide_cache_multi"):
            orig = getattr(jda, name)
            monkeypatch.setattr(jda, name, (lambda orig: lambda *a, **kw: orig(
                *a, **{**kw, "interpret": True}))(orig))
    return set_mode


# f32 activations through two layers; the attention sides differ as in the
# kernel tests above, and the K/V of this step is quantized on both sides
# from f32 values that differ by summation order (a code can move by one
# step). Measured up to 1.3e-4 of the logit range; bound 1e-3.
_LOGIT_TOL = 1e-3


@pytest.mark.parametrize("mode", ["grouped", "xla"])
@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
def test_decode_step_modes_match_jax(weights, jax_mode, monkeypatch, mode, kind):
    """Three decode steps at the SMALL config from one random cache state:
    logits within _LOGIT_TOL of the range and the same greedy tokens. The
    JAX side keeps a 5D cache for int8 and bf16 (what its engine picks
    under these modes) and a flat one for packed int4."""
    jp, tp = weights
    slots, max_len = 4, 64
    k, v, ks, vs = _cache_bytes(kind, slots, max_len)
    jc = _jax_cache(k, v, ks, vs, flat=kind == "int4")
    tc = interop.kv_cache_from_numpy(k, v, ks, vs, device="cpu")
    jax_mode(mode)
    monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode.upper())
    assert tllama._decode_attn_mode(P_T) == mode
    pos = np.array([40, -1, 5, 63 - 3], np.int32)
    toks = np.array([7, 0, 300, 11], np.int32)
    for step in range(3):
        jl, jc = jllama.decode_step(jp, P_J, jnp.asarray(toks), jc, jnp.asarray(pos))
        tl, tc = tllama.decode_step(tp, P_T, torch.from_numpy(toks).long(), tc,
                                    torch.from_numpy(pos), window=max_len)
        jl, tl = np.asarray(jl), to_np(tl)
        _range_close(tl, jl, _LOGIT_TOL, f"{mode} {kind} step {step}")
        assert np.all(tl[1] == 0.0)
        np.testing.assert_array_equal(np.argmax(tl, -1)[pos >= 0], np.argmax(jl, -1)[pos >= 0])
        toks = np.argmax(jl, -1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, pos)


def test_decode_step_grouped_int4_reads_the_packed_window(weights, jax_mode, monkeypatch):
    """decode_step under "grouped" with a packed int4 cache hands each
    layer's packed window and head-major scales to decode_attention_packed
    (views of the cache: no unpack in the model layer, no call of
    decode_attention) and matches the JAX package's grouped branch, which
    unpacks the window in XLA, within _LOGIT_TOL, with the same greedy
    tokens."""
    jp, tp = weights
    slots, max_len = 4, 64
    k, v, ks, vs = _cache_bytes("int4", slots, max_len, seed=6)
    jc = _jax_cache(k, v, ks, vs, flat=True)
    tc = interop.kv_cache_from_numpy(k, v, ks, vs, device="cpu")
    jax_mode("grouped")
    monkeypatch.setenv("TPUSERVE_DECODE_ATTN", "grouped")
    seen = []
    real = tllama.decode_attention_packed

    def packed(q, k_rows, v_rows, k_scale, v_scale, positions, **kw):
        seen.append((k_rows.data_ptr(), k_rows.shape, k_scale.shape, k_scale.stride(-1)))
        return real(q, k_rows, v_rows, k_scale, v_scale, positions, **kw)

    def must_not_run(*a, **kw):
        raise AssertionError("the packed window was unpacked or sent to decode_attention")

    monkeypatch.setattr(tllama, "decode_attention_packed", packed)
    monkeypatch.setattr(tllama, "decode_attention", must_not_run)
    monkeypatch.setattr(tllama, "unpack_kv_codes", must_not_run)
    pos = np.array([33, -1, 7, 60], np.int32)
    toks = np.array([9, 0, 250, 31], np.int32)
    jl, _ = jllama.decode_step(jp, P_J, jnp.asarray(toks), jc, jnp.asarray(pos))
    tl, _ = tllama.decode_step(tp, P_T, torch.from_numpy(toks).long(), tc,
                               torch.from_numpy(pos), window=max_len)
    n_kv = SMALL["n_kv_heads"]
    assert seen == [(tc.k[layer].data_ptr(), (slots, max_len, n_kv * HD // 2),
                     (slots, n_kv, max_len), 1) for layer in range(SMALL["n_layers"])]
    jl, tl = np.asarray(jl), to_np(tl)
    _range_close(tl, jl, _LOGIT_TOL, "grouped int4 packed route")
    assert np.all(tl[1] == 0.0)
    np.testing.assert_array_equal(np.argmax(tl, -1)[pos >= 0], np.argmax(jl, -1)[pos >= 0])


def test_decode_step_pallas_unchanged(weights, jax_mode, monkeypatch):
    """The default mode is today's: "pallas" (any case) and no variable give
    bitwise the same logits, through the flat kernel, and they match the JAX
    package's flat kernel; "grouped" and "xla" move them, within
    _LOGIT_TOL."""
    jp, tp = weights
    k, v, ks, vs = _cache_bytes("int8", 4, 64)
    pos = np.array([40, -1, 5, 60], np.int32)
    toks = torch.tensor([7, 0, 300, 11])

    def port(mode):
        if mode is None:
            monkeypatch.delenv("TPUSERVE_DECODE_ATTN", raising=False)
        else:
            monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode)
        tc = interop.kv_cache_from_numpy(k, v, ks, vs, device="cpu")
        before = tda.launches, tda.grouped_launches
        out = to_np(tllama.decode_step(tp, P_T, toks, tc, torch.from_numpy(pos))[0])
        assert (tda.launches, tda.grouped_launches) == before   # plain versions on the CPU
        return out

    default = port(None)
    np.testing.assert_array_equal(port("Pallas"), default)
    jax_mode("pallas")
    jl, _ = jllama.decode_step(jp, P_J, jnp.asarray(toks.numpy().astype(np.int32)),
                               _jax_cache(k, v, ks, vs, flat=True), jnp.asarray(pos))
    _range_close(default, np.asarray(jl), _LOGIT_TOL, "pallas vs JAX")
    for mode in ("grouped", "einsum"):
        other = port(mode)
        assert not np.array_equal(other, default)
        _range_close(other, default, 2e-2, f"{mode} vs pallas")


@pytest.mark.parametrize("mode", ["grouped", "xla"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_verify_step_modes_match_jax(weights, jax_mode, monkeypatch, mode, kind):
    """verify_step under the non-"pallas" modes against the JAX package's
    einsum branch (C = 3; one slot with a single valid row, one inactive)."""
    jp, tp = weights
    slots, max_len, c = 4, 64, 3
    k, v, ks, vs = _cache_bytes(kind, slots, max_len)
    jc = _jax_cache(k, v, ks, vs, flat=True)
    tc = interop.kv_cache_from_numpy(k, v, ks, vs, device="cpu")
    jax_mode(mode)
    monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, SMALL["vocab_size"], size=(slots, c)).astype(np.int32)
    pos = np.array([10, 30, -1, 50], np.int32)
    lens = np.array([3, 1, 0, 3], np.int32)
    jl, _ = jllama.verify_step(jp, P_J, jnp.asarray(toks), jc, jnp.asarray(pos),
                               jnp.asarray(lens))
    tl, _ = tllama.verify_step(tp, P_T, torch.from_numpy(toks).long(), tc,
                               torch.from_numpy(pos), torch.from_numpy(lens))
    jl, tl = np.asarray(jl), to_np(tl)
    _range_close(tl, jl, _LOGIT_TOL, f"verify {mode} {kind}")
    valid = np.arange(c)[None, :] < lens[:, None]
    np.testing.assert_array_equal(np.argmax(tl, -1)[valid], np.argmax(jl, -1)[valid])


@pytest.mark.parametrize("mode", ["grouped", "xla"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_step_paged_modes_match_jax(weights, jax_mode, monkeypatch, mode, kind):
    """decode_step_paged under the non-"pallas" modes against the JAX
    package's gathered einsum branch, over shuffled pages of 16 rows."""
    jp, tp = weights
    slots, ps, n_cols = 4, 16, 4
    n_pages = slots * n_cols + 1
    rng = np.random.default_rng(9)
    k, v, ks, vs = _cache_bytes(kind, 1, n_pages * ps)
    k, v = (a.reshape(a.shape[0], n_pages, ps, a.shape[-1]) for a in (k, v))
    hp = 8   # scale pools hold pad8(Hkv) rows
    ks, vs = (np.concatenate([a.reshape(a.shape[0], a.shape[2], n_pages, ps).transpose(0, 2, 1, 3),
                              np.zeros((a.shape[0], n_pages, hp - a.shape[2], ps), np.float32)],
                             axis=2) for a in (ks, vs))
    table = (1 + rng.permutation(n_pages - 1)).reshape(slots, n_cols).astype(np.int32)
    jc = jpkv.PagedKVCache(k=_jax(k), v=_jax(v), k_scale=_jax(ks), v_scale=_jax(vs), flat=True)
    tc = interop.paged_cache_from_numpy(k, v, ks, vs, device="cpu")
    jax_mode(mode)
    monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode)
    toks = np.array([3, 9, 0, 400], np.int32)
    pos = np.array([20, 63, -1, 0], np.int32)
    jl, _ = jllama.decode_step_paged(jp, P_J, jnp.asarray(toks), jc, jnp.asarray(table),
                                     jnp.asarray(pos))
    tl, _ = tllama.decode_step_paged(tp, P_T, torch.from_numpy(toks).long(), tc,
                                     torch.from_numpy(table), torch.from_numpy(pos))
    jl, tl = np.asarray(jl), to_np(tl)
    _range_close(tl, jl, _LOGIT_TOL, f"paged {mode} {kind}")
    live = pos >= 0
    np.testing.assert_array_equal(np.argmax(tl, -1)[live], np.argmax(jl, -1)[live])


def _engine_config(name):
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int4"},
            "generation": dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=8,
                               prefill_chunk=16, decode_horizon=2)}


def test_engine_greedy_tokens_equal_across_modes(tmp_path, monkeypatch):
    """The port's engine serves the SMALL wide-margin checkpoint (int4 g128
    weights, packed int4 KV) with the same greedy tokens under "pallas",
    "grouped" and "xla", and under "grouped" its decode steps go through
    the grouped kernel's entries (counted on the plain path by wrappers:
    a packed int4 cache takes the packed route, decode_attention_packed)."""
    cfg = _engine_config("modes")
    vdir = write_model(str(tmp_path), "modes", cfg)
    prompts = [[5, 17, 100, 42, 7], list(range(30, 70)), [3, 1, 4, 1, 5, 9, 2, 6]]
    calls = []
    for name in ("decode_attention", "decode_attention_packed"):
        real = getattr(tllama, name)
        monkeypatch.setattr(tllama, name, (lambda real: lambda *a, **kw: calls.append(1)
                                           or real(*a, **kw))(real))
    outs = {}
    for mode in ("pallas", "grouped", "xla"):
        monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode)
        calls.clear()
        eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
        eng.start()
        try:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            for r in reqs:
                r.done.wait(timeout=300)
                assert r.error is None, r.error
            outs[mode] = [list(r.output_ids) for r in reqs]
            steps = eng.steps
        finally:
            eng.stop()
        assert (len(calls) > 0) == (mode == "grouped")
        if mode == "grouped":
            assert len(calls) == SMALL["n_layers"] * steps
    assert all(len(o) == 8 for o in outs["pallas"])
    assert outs["grouped"] == outs["pallas"] and outs["xla"] == outs["pallas"]
