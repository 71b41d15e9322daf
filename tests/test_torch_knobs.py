"""The three knobs of the JAX package that tpuserve_torch reads per call,
held against the JAX package on the CPU:

- TPUSERVE_ATTN_BLOCK_L: the flat and multi-candidate entries' block_l
  when the caller gives none (default 128). It decides where P is
  requantized, so it moves the output, and both packages move alike. The
  plain versions run against the Pallas kernels in interpret mode.
- TPUSERVE_ATTN_DYNSKIP: "1" skips a slot's blocks past its position, "0"
  reads and masks them (defaults: on for the flat and multi kernels, off
  for the grouped one). The output does not change; the plain versions
  under either setting equal each other and the JAX kernels.
- TPUSERVE_QMATMUL=xla: qmatmul takes dequantize-then-matmul (W4A8: the
  per-group integer reference) and never the fused kernel, as the JAX
  qmatmul does with use_pallas=False.

JAX reads the attention knobs when it traces a kernel, so each case clears
JAX's caches around it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserve.ops.decode_attention as jda
from tpuserve.quant import core as jcore
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.ops import quant_matmul as tqm
from tpuserve_torch.quant import core as tcore
from torch_parity import jax_qt_to_torch, to_np

HD = 128


@pytest.fixture()
def env(monkeypatch):
    """Set (or, with None, unset) environment variables for one test, with
    JAX retracing on both sides."""
    def set_vars(**kv):
        for name, val in kv.items():
            if val is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, str(val))
        jax.clear_caches()

    yield set_vars
    jax.clear_caches()


def _cache(s, hkv, l, n_layers, seed, cands=None, rep=1):
    """Packed int4 caches (never the multi-slot packed form, so block_l is
    always the online-softmax block), q f32 scaled, f32 scales."""
    rng = np.random.default_rng(seed)
    h, w = hkv * rep, hkv * HD
    shape = (s, h, HD) if cands is None else (s, cands, h, HD)
    q = (rng.normal(size=shape) / np.sqrt(HD)).astype(np.float32)
    k, v = (rng.integers(0, 256, size=(n_layers, s, l, w // 2)).astype(np.uint8)
            for _ in range(2))
    ks, vs = ((rng.uniform(0.5, 1.5, size=(s, hkv, l)) * 0.01).astype(np.float32)
              for _ in range(2))
    return q, k, v, ks, vs


def _flat(inputs, pos, layer=1):
    """(port, JAX in interpret mode) of decode_attention_wide_cache with
    block_l left to the knob."""
    q, k, v, ks, vs = inputs
    ref = np.asarray(jda.decode_attention_wide_cache(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, pos)), layer, interpret=True))
    out = to_np(tda.decode_attention_wide_cache(
        *(torch.from_numpy(a) for a in (q, k, v, ks, vs, pos)), layer))
    return out, ref


def _multi(inputs, pos, layer=1):
    q, k, v, ks, vs = inputs
    ref = np.asarray(jda.decode_attention_wide_cache_multi(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, pos)), layer, interpret=True))
    out = to_np(tda.decode_attention_wide_cache_multi(
        *(torch.from_numpy(a) for a in (q, k, v, ks, vs, pos)), layer))
    return out, ref


# ------------------------------------------------------------ block_l
@pytest.mark.parametrize("block_l", [64, 256])
def test_block_l_flat_matches_pallas(env, block_l):
    """The flat plain version with TPUSERVE_ATTN_BLOCK_L set against the
    Pallas kernel with the same setting, over L=512 (8 or 2 blocks); the
    value moves the output away from the default 128's."""
    inputs = _cache(s=3, hkv=2, l=512, n_layers=2, seed=block_l)
    pos = np.array([300, -1, 511], np.int32)
    env(TPUSERVE_ATTN_BLOCK_L=block_l)
    out, ref = _flat(inputs, pos)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)
    env(TPUSERVE_ATTN_BLOCK_L=None)
    default, default_ref = _flat(inputs, pos)
    np.testing.assert_allclose(default, default_ref, rtol=1e-5, atol=2e-6)
    assert np.abs(out - default).max() > 1e-6 * np.abs(default).max()
    assert tda.default_block_l() == 128


@pytest.mark.parametrize("block_l", [64, 256])
def test_block_l_multi_matches_pallas(env, block_l):
    """The multi-candidate plain version under TPUSERVE_ATTN_BLOCK_L against
    the Pallas multi kernel under it (active slots), and unlike the
    default."""
    inputs = _cache(s=3, hkv=2, l=512, n_layers=2, seed=block_l + 1, cands=3, rep=2)
    pos = np.array([200, -1, 509], np.int32)
    env(TPUSERVE_ATTN_BLOCK_L=block_l)
    out, ref = _multi(inputs, pos)
    np.testing.assert_allclose(out[[0, 2]], ref[[0, 2]], rtol=1e-5, atol=2e-6)
    env(TPUSERVE_ATTN_BLOCK_L=None)
    default, _ = _multi(inputs, pos)
    assert np.abs(out[[0, 2]] - default[[0, 2]]).max() > 1e-6 * np.abs(default).max()


def test_block_l_clips_and_halves_to_the_window(env):
    """A block_l past the window is clipped to it and halved until it
    divides it, as in the JAX package; an explicit block_l wins over the
    variable, and the paged entry keeps one page a block."""
    q, k, _, ks, _ = _cache(s=2, hkv=2, l=96, n_layers=1, seed=3)
    qt, kt, kst = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(ks)
    env(TPUSERVE_ATTN_BLOCK_L=256)
    assert tda._geometry(qt, kt, kst, None, None)["block_l"] == 96
    assert tda._geometry(qt, kt, kst, 64, None)["block_l"] == 64
    env(TPUSERVE_ATTN_BLOCK_L=64)
    assert tda._geometry(qt, kt, kst, None, None)["block_l"] == 32
    assert tda._geometry(qt, kt, kst, None, 32)["block_l"] == 32
    assert tda._geometry(qt, kt, kst, 96, 16, pack=False)["block_l"] == 16


# ------------------------------------------------------------ dynskip
@pytest.mark.parametrize("skip", ["0", "1"])
def test_dynskip_flat_and_multi_match_pallas(env, skip):
    """Flat and multi plain versions under TPUSERVE_ATTN_DYNSKIP=0 and =1:
    bitwise equal to each other (masked blocks add exact zeros) and to
    the JAX kernels under the same setting within f32 ulps."""
    inputs = _cache(s=4, hkv=2, l=256, n_layers=2, seed=7)
    pos = np.array([10, -1, 255, 130], np.int32)
    env(TPUSERVE_ATTN_DYNSKIP=skip, TPUSERVE_ATTN_BLOCK_L=32)
    out, ref = _flat(inputs, pos)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    minputs = _cache(s=3, hkv=2, l=256, n_layers=2, seed=8, cands=2, rep=2)
    mpos = np.array([3, -1, 254], np.int32)
    mout, mref = _multi(minputs, mpos)
    np.testing.assert_allclose(mout[[0, 2]], mref[[0, 2]], rtol=1e-5, atol=2e-6)
    env(TPUSERVE_ATTN_DYNSKIP="0" if skip == "1" else "1")
    other, _ = _flat(inputs, pos)
    mother, _ = _multi(minputs, mpos)
    np.testing.assert_array_equal(out, other)
    np.testing.assert_array_equal(mout[[0, 2]], mother[[0, 2]])
    assert np.all(out[1] == 0.0) and np.all(mout[1, 0] == 0.0)


@pytest.mark.parametrize("skip", [None, "0", "1"])
def test_dynskip_grouped_matches_pallas(env, skip):
    """The grouped plain version (default: read and mask) under each
    setting against the grouped Pallas kernel under it, int8 cache, and
    equal across settings."""
    rng = np.random.default_rng(11)
    s, l, n_kv, rep = 4, 128, 2, 2
    q = (rng.normal(size=(s, n_kv * rep, HD)) / np.sqrt(HD)).astype(np.float32)
    k, v = (rng.integers(-127, 128, size=(s, l, n_kv, HD)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.02, size=(s, l, n_kv)).astype(np.float32) for _ in range(2))
    pos = np.array([-1, 0, l - 1, 40], np.int32)
    env(TPUSERVE_ATTN_DYNSKIP=skip)
    assert tda.dynskip(grouped=True) == (skip == "1")
    ref = np.asarray(jda.decode_attention(*(jnp.asarray(a) for a in (q, k, v, ks, vs, pos)),
                                          block_l=32, interpret=True))
    out = to_np(tda.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, ks, vs, pos)),
                                     block_l=32))
    tol = 1e-3 * float(np.abs(ref).max())   # tests/test_torch_grouped.py's bound
    assert float(np.abs(out - ref).max()) <= tol
    env(TPUSERVE_ATTN_DYNSKIP="1" if skip != "1" else "0")
    other = to_np(tda.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, ks, vs, pos)),
                                       block_l=32))
    np.testing.assert_array_equal(out, other)
    assert np.all(out[0] == 0.0)


def test_dynskip_defaults(env):
    env(TPUSERVE_ATTN_DYNSKIP=None)
    assert tda.dynskip() and not tda.dynskip(grouped=True)
    env(TPUSERVE_ATTN_DYNSKIP="0")
    assert not tda.dynskip() and not tda.dynskip(grouped=True)
    env(TPUSERVE_ATTN_DYNSKIP="1")
    assert tda.dynskip() and tda.dynskip(grouped=True)


# ------------------------------------------------------------ qmatmul=xla
def _kernel_must_not_run(*a, **k):
    raise AssertionError("the fused kernel's wrapper ran under TPUSERVE_QMATMUL=xla")


@pytest.mark.parametrize("bits,gs,act_bits", [
    (4, 128, 0), (4, 32, 0), (4, 0, 0), (8, 128, 0), (8, 32, 0), (8, 0, 0), (4, 128, 8),
    (4, 32, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qmatmul_xla_matches_jax(monkeypatch, bits, gs, act_bits, dtype):
    """qmatmul under TPUSERVE_QMATMUL=xla against the JAX qmatmul with
    use_pallas=False (what the variable selects there): f32 activations to
    f32 ulps, bf16 to one bf16 step of the largest output; the wrapper of
    the fused kernel is never called."""
    rng = np.random.default_rng(bits * 100 + gs + act_bits)
    k, n, b = 256, 96, 5
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    x = rng.normal(size=(b, k)).astype(np.float32)
    qt = jcore.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    if act_bits:
        qt = dataclasses.replace(qt, act_bits=act_bits)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    ref = np.asarray(jcore.qmatmul(jx, qt, use_pallas=False).astype(jnp.float32))
    monkeypatch.setenv("TPUSERVE_QMATMUL", "xla")
    monkeypatch.setattr(tqm, "quant_matmul", _kernel_must_not_run)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    out = tcore.qmatmul(tx, jax_qt_to_torch(qt))
    assert out.dtype == tx.dtype and tuple(out.shape) == (b, n)
    out = to_np(out.float())
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert float(np.abs(out - ref).max()) <= 2 ** -7 * scale


def test_qmatmul_mode_is_read_per_call(monkeypatch):
    """The default ("pallas", any case) reaches the fused kernel's wrapper;
    "xla" (any case) does not, in the same process."""
    rng = np.random.default_rng(5)
    qt = tcore.quantize(torch.from_numpy(rng.normal(size=(128, 32)).astype(np.float32)),
                        bits=4, group_size=128)
    x = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    seen = []
    real = tqm.quant_matmul
    monkeypatch.setattr(tqm, "quant_matmul", lambda *a, **k: seen.append(1) or real(*a, **k))
    for mode, fused in [(None, 1), ("PALLAS", 1), ("xla", 0), ("XLA", 0), ("pallas", 1)]:
        if mode is None:
            monkeypatch.delenv("TPUSERVE_QMATMUL", raising=False)
        else:
            monkeypatch.setenv("TPUSERVE_QMATMUL", mode)
        before = len(seen)
        out = to_np(tcore.qmatmul(x, qt))
        assert len(seen) - before == fused, mode
        ref = to_np(tqm.quant_matmul_plain(x, qt))   # the same sums in another order
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
