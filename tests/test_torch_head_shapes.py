"""The attention core at every head shape the Pallas kernels serve: head_dim
256 and GQA ratios 3, 7 and 8 (packed int4 at rep 8: 16 query rows a
block), held against the JAX package.

- Each decode-attention entry's plain version (flat, multi-candidate,
  paged, prebuilt Q_wide, grouped and its packed int4 route) against the
  TPU kernel in interpret mode, at the tolerances the head_dim-128 parity
  tests use (tests/test_torch_ops.py, test_torch_spec.py,
  test_torch_paged.py, test_torch_grouped.py).
- decode_step, verify_step and decode_step_paged of a 2-layer head_dim-256
  model and a 2-layer rep-8 model against the JAX functions with their
  kernels forced on (tests/test_torch_llama.py's tolerance).
- A head_dim the kernels do not take (384) is refused at load with a
  BackendError naming it.

The JAX side runs its Pallas kernels in interpret mode; data crosses as
numpy arrays.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserve.ops.decode_attention as jda
from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.serving import paged_kv as jpkv
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving import paged_kv as tpkv
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import jax_to_torch_params, to_np

torch.set_num_threads(1)


def _kv(kind, shape, rng):
    if kind == "int8":
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    if kind == "int4":
        return rng.integers(0, 256, size=shape[:-1] + (shape[-1] // 2,)).astype(np.uint8)
    return rng.normal(size=shape).astype(np.float32)


def _tt(kind, a):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if kind == "bf16" else t


def _jt(kind, a):
    j = jnp.asarray(a)
    return j.astype(jnp.bfloat16) if kind == "bf16" else j


def _pallas(fn, *arrays, statics=(), **kw):
    """The JAX entry `fn` in interpret mode, jitted: the arrays traced, the
    rest (layer, block_l, window) closed over. Returns numpy."""
    return np.asarray(jax.jit(lambda *a: fn(*a, *statics, interpret=True, **kw))(
        *[None if a is None else jnp.asarray(a) for a in arrays]))


def _scales(rng, shape):
    return (rng.uniform(0.5, 1.5, size=shape) * 0.01).astype(np.float32)


# (kind, Hkv, rep, hd): head_dim 256 for every cache, the odd ratios, and
# packed int4 at rep 8 (16 query rows a block)
SHAPES = [("int8", 2, 1, 256), ("int4", 2, 2, 256), ("bf16", 2, 1, 256), ("f32", 1, 2, 256),
          ("int8", 2, 3, 128), ("int8", 1, 7, 128), ("int4", 2, 8, 128)]


def _id(c):
    return f"{c[0]}-hkv{c[1]}-rep{c[2]}-hd{c[3]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_flat_plain_matches_pallas(shape):
    """The flat core's plain version (decode_attention_wide_cache) against
    `_wide_kernel` in interpret mode, block_l 32 over L = 64, an inactive
    slot exactly 0: f32 ulps of |out|, as at head_dim 128."""
    kind, hkv, rep, hd = shape
    rng = np.random.default_rng(hd + rep)
    s, l = 3, 64
    q = (rng.normal(size=(s, hkv * rep, hd)) / np.sqrt(hd)).astype(np.float32)
    k, v = (_kv(kind, (2, s, l, hkv * hd), rng) for _ in range(2))
    sc = [_scales(rng, (s, hkv, l)) for _ in range(2)] if kind in ("int8", "int4") else [None] * 2
    pos = np.array([5, -1, l - 1], np.int32)
    ref = _pallas(jda.decode_attention_wide_cache, q, _jt(kind, k), _jt(kind, v), *sc, pos,
                  statics=(1,), block_l=32)
    out = to_np(tda.decode_attention_wide_cache(
        torch.from_numpy(q), _tt(kind, k), _tt(kind, v),
        *[None if a is None else torch.from_numpy(a) for a in sc], torch.from_numpy(pos), 1,
        block_l=32))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_multi_plain_matches_pallas(shape):
    """The multi-candidate core (C = 3) against `_wide_multi_kernel` in
    interpret mode (active slots), and candidate c against the flat plain
    version at positions + c (f32 rounding)."""
    kind, hkv, rep, hd = shape
    rng = np.random.default_rng(2 * hd + rep)
    s, l, cands = 3, 64, 3
    q = (rng.normal(size=(s, cands, hkv * rep, hd)) / np.sqrt(hd)).astype(np.float32)
    k, v = (_kv(kind, (2, s, l, hkv * hd), rng) for _ in range(2))
    sc = [_scales(rng, (s, hkv, l)) for _ in range(2)] if kind in ("int8", "int4") else [None] * 2
    pos = np.array([5, -1, l - cands], np.int32)
    ref = _pallas(jda.decode_attention_wide_cache_multi, q, _jt(kind, k), _jt(kind, v), *sc,
                  pos, statics=(1,), block_l=32)
    tsc = [None if a is None else torch.from_numpy(a) for a in sc]
    tk, tv = _tt(kind, k), _tt(kind, v)
    out = to_np(tda.decode_attention_wide_cache_multi(torch.from_numpy(q), tk, tv, *tsc,
                                                      torch.from_numpy(pos), 1, block_l=32))
    np.testing.assert_allclose(out[[0, 2]], ref[[0, 2]], rtol=1e-5, atol=2e-6)
    assert np.all(out[1, 0] == 0.0)
    for c in range(cands):
        flat = to_np(tda.decode_attention_wide_cache_plain(
            torch.from_numpy(q[:, c]), tk, tv, *tsc, torch.from_numpy(pos + c), 1, block_l=32,
            window=l))
        np.testing.assert_allclose(out[[0, 2], c], flat[[0, 2]], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [c for c in SHAPES if c[0] != "f32"], ids=_id)
def test_paged_plain_matches_pallas(shape):
    """The paged core's plain version against `_wide_kernel` with scale
    pools in interpret mode: pages of 16 rows in a shuffled table, positions
    ps - 1, -1, ps and the window's last row."""
    kind, hkv, rep, hd = shape
    rng = np.random.default_rng(3 * hd + rep)
    s, ps, pages = 4, 16, 3
    n_pages = s * pages + 2
    hp = tpkv.pad8(hkv)
    q = (rng.normal(size=(s, hkv * rep, hd)) / np.sqrt(hd)).astype(np.float32)
    k, v = (_kv(kind, (2, n_pages, ps, hkv * hd), rng) for _ in range(2))
    sc = [_scales(rng, (2, n_pages, hp, ps)) for _ in range(2)] if kind != "bf16" else [None] * 2
    table = (1 + rng.permutation(n_pages - 1)[:s * pages]).reshape(s, pages).astype(np.int32)
    pos = np.array([ps - 1, -1, ps, pages * ps - 1], np.int32)
    ref = _pallas(jda.decode_attention_wide_paged, q, _jt(kind, k), _jt(kind, v), *sc, table,
                  pos, statics=(1,))
    out = to_np(tda.decode_attention_wide_paged(
        torch.from_numpy(q), _tt(kind, k), _tt(kind, v),
        *[None if a is None else torch.from_numpy(a) for a in sc], torch.from_numpy(table),
        torch.from_numpy(pos), 1))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("shape", [c for c in SHAPES if c[0] != "int4"], ids=_id)
def test_wide_plain_matches_pallas(shape):
    """decode_attention_wide (the flat kernel over a contiguous [S, L, Hkv,
    hd] cache, every block read) against `_wide_kernel` with a prebuilt
    Q_wide in interpret mode: 2e-3 of the range, as at head_dim 128."""
    kind, hkv, rep, hd = shape
    rng = np.random.default_rng(4 * hd + rep)
    s, l = 3, 64
    q = (rng.normal(size=(s, hkv * rep, hd)) / np.sqrt(hd)).astype(np.float32)
    k, v = (_kv(kind, (s, l, hkv, hd), rng) for _ in range(2))
    sc = [_scales(rng, (s, hkv, l)) for _ in range(2)] if kind == "int8" else [None] * 2
    pos = np.array([5, -1, l - 1], np.int32)
    ref = _pallas(jda.decode_attention_wide, q, _jt(kind, k), _jt(kind, v), *sc, pos,
                  block_l=32)
    out = to_np(tda.decode_attention_wide(
        torch.from_numpy(q), _tt(kind, k), _tt(kind, v),
        *[None if a is None else torch.from_numpy(a) for a in sc], torch.from_numpy(pos),
        block_l=32))
    err, tol = float(np.abs(out - ref).max()), 2e-3 * float(np.abs(ref).max())
    assert err <= tol, (err, tol)
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_grouped_plain_matches_pallas(shape):
    """The grouped kernel's plain version against the TPU's `_kernel` in
    interpret mode (block_l 32 over L = 64); packed int4 through its route
    (unpack_kv_codes, then the grouped plain version) against the JAX
    unpack and `_kernel`: 1e-3 of the range, as at head_dim 128."""
    kind, hkv, rep, hd = shape
    rng = np.random.default_rng(5 * hd + rep)
    s, l = 3, 64
    q = (rng.normal(size=(s, hkv * rep, hd)) / np.sqrt(hd)).astype(np.float32)
    pos = np.array([5, -1, l - 1], np.int32)
    if kind == "int4":
        k, v = (_kv(kind, (s, l, hkv * hd), rng) for _ in range(2))
        ks, vs = (_scales(rng, (s, hkv, l)) for _ in range(2))
        jk, jv = (jllama.unpack_kv_codes(jnp.asarray(a)).reshape(s, l, hkv, hd) for a in (k, v))
        ref = _pallas(jda.decode_attention, q, jk, jv, jnp.asarray(ks).transpose(0, 2, 1),
                      jnp.asarray(vs).transpose(0, 2, 1), pos, block_l=32)
        out = to_np(tda.decode_attention_packed(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ks),
            torch.from_numpy(vs), torch.from_numpy(pos), block_l=32))
    else:
        k, v = (_kv(kind, (s, l, hkv, hd), rng) for _ in range(2))
        sc = [_scales(rng, (s, l, hkv)) for _ in range(2)] if kind == "int8" else [None] * 2
        ref = _pallas(jda.decode_attention, q, _jt(kind, k), _jt(kind, v), *sc, pos,
                      block_l=32)
        out = to_np(tda.decode_attention(
            torch.from_numpy(q), _tt(kind, k), _tt(kind, v),
            *[None if a is None else torch.from_numpy(a) for a in sc], torch.from_numpy(pos),
            block_l=32))
    err, tol = float(np.abs(out - ref).max()), 1e-3 * float(np.abs(ref).max())
    assert err <= tol, (err, tol)
    assert np.all(out[1] == 0.0)


def test_kernel_kind_takes_every_ratio_and_both_head_dims():
    """The wrapper's launch plan for the shapes once refused: any nq (rows
    in groups of 32, padded to 8, 16 or 32), packed int4 at rep 8 is 16 rows;
    head_dim 384 is refused by name. The shared memory of each plan stays
    under the H100's 227 KB at the default block_l."""
    for rep in (1, 3, 5, 6, 7, 8, 16, 40):
        for hd in (128, 256):
            assert tda._kernel_kind(torch.int8, 8, 8, rep, hd) == (0, rep)
            assert tda._kernel_kind(torch.uint8, 4, 8, rep, hd) == (1, 2 * rep)
            for kind, nq in ((0, rep), (1, 2 * rep), (2, rep), (3, rep)):
                _, rp = tda.core_rows(1, nq)
                assert tda.core_smem_bytes(rp, 128, kind=kind, hd=hd) <= 227 * 1024
                assert tda.core_smem_bytes(rp, 64, 4, kind=kind, hd=hd) <= 227 * 1024
                assert tda.grouped_smem_bytes(nq, 256, kind=kind, hd=hd) <= 227 * 1024
    assert tda.core_rows(1, 16) == (1, 16) and tda.core_rows(5, 16) == (3, 32)
    assert tda.grouped_rows(40) == (2, 32, 32) and tda.grouped_rows(6) == (1, 6, 8)
    # the int8 stage at head_dim 256 holds its V tile transposed: 256 rows of 80 bytes
    assert tda._core_stage_bytes(0, 256) == 256 * 80 > tda._stage_bytes(0, 256)
    assert tda._core_stage_bytes(0, 128) == tda._stage_bytes(0, 128) == 64 * 144 + 4 * 68 * 4
    with pytest.raises(ValueError, match="head_dim"):
        tda._kernel_kind(torch.int8, 8, 2, 1, 384)


# ------------------------------------------------------------ the models
def _weights(cfg, seed=0):
    """Float weights of a llama config, spread as tests/torch_parity.py's."""
    rng = np.random.default_rng(seed)
    d, f, v = cfg["dim"], cfg["ffn_dim"], cfg["vocab_size"]
    qd, kvd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]

    def n(*shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    w = {"embed/weight": n(v, d, std=1.0), "final_norm/scale": np.ones((d,), np.float32),
         "lm_head/kernel": n(d, v, std=4.0 / np.sqrt(d))}
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}"
        w[f"{pre}/attn_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/mlp_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/wq/kernel"] = n(d, qd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wk/kernel"] = n(d, kvd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wv/kernel"] = n(d, kvd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wo/kernel"] = n(qd, d, std=1.0 / np.sqrt(qd))
        w[f"{pre}/w_gate/kernel"] = n(d, f, std=1.0 / np.sqrt(d))
        w[f"{pre}/w_up/kernel"] = n(d, f, std=1.0 / np.sqrt(d))
        w[f"{pre}/w_down/kernel"] = n(f, d, std=1.0 / np.sqrt(f))
    return w


# head_dim 256 (Gemma's head shape: as many kv heads as query heads) and
# GQA rep 8 (Llama-2-70B's ratio; packed int4 KV: 16 rows a block)
MODELS = {"hd256": dict(vocab_size=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                        head_dim=256, ffn_dim=512),
          "rep8": dict(vocab_size=512, dim=256, n_layers=2, n_heads=16, n_kv_heads=2,
                       head_dim=128, ffn_dim=512)}


# (model, KV bits): packed int4 KV in the contiguous steps (head_dim 256's
# 256-byte rows of two heads; rep 8's 16 rows a block), and the paged
# steps over the pools chip_smoke's [hd256] and [gqa8] serve (an int8
# pool; packed int4 pages). The int8 cache at rep 8 has the 8 rows a block
# of head_dim-128 serving, and every cache kind at head_dim 256 is held
# per entry above.
DECODE_KV = [("hd256", 4), ("rep8", 4)]
PAGED_KV = [("hd256", 8), ("rep8", 4)]


@functools.lru_cache(maxsize=None)
def _model(name):
    """int4 g128 weights quantized by the JAX package, jitted (one compile
    for the tree instead of one a primitive); the port gets the same
    bytes."""
    cfg = MODELS[name]
    pj, pt = jllama.LlamaParams(**cfg), tllama.LlamaParams(**cfg)
    raw = jllama.fuse_params({k: jnp.asarray(v) for k, v in _weights(cfg).items()}, pj)
    jp = jax.jit(lambda tree: jcore.quantize_param_tree(
        tree, bits=4, group_size=128,
        predicate=lambda name, a: a.ndim == 2 and name.endswith("kernel")))(raw)
    return pj, pt, jp, jax_to_torch_params(jp)


@pytest.fixture()
def jax_kernels(monkeypatch):
    """Force the JAX package onto its kernels (interpret mode on the CPU)."""
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


@functools.lru_cache(maxsize=None)
def _jit(name):
    """The JAX function `name`, jitted with its params and window static
    (one compile a shape instead of one a primitive; the kernels are read
    when it traces, after jax_kernels has forced them on)."""
    fn = getattr(jllama, name)
    window = ("window",) if "window" in inspect.signature(fn).parameters else ()
    return jax.jit(fn, static_argnums=(1,), static_argnames=window)


def _close(out, ref, what):
    # tests/test_torch_llama.py's bound: f32 model, same algorithms; a K/V
    # value on a quantizer rounding boundary moves one code
    tol = 1e-2 * float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("name,kv_bits", DECODE_KV)
def test_decode_and_verify_match_jax(name, kv_bits, jax_kernels):
    """Prefill two slots, two greedy decode_steps (flat core) and one
    verify_step of 4 candidates (multi core) against the JAX functions:
    logits within 1e-2 of the range, greedy tokens equal, inactive slots 0."""
    pj, pt, jp, tp = _model(name)
    slots, max_len = 3, 64
    jc = jllama.KVCache.create(pj, slots, max_len, quantized=True, flat=True, kv_bits=kv_bits)
    tc = tllama.KVCache.create(pt, slots, max_len, quantized=True, kv_bits=kv_bits,
                               device="cpu")
    rng = np.random.default_rng(3)
    prompts = {0: rng.integers(0, 512, 9), 2: rng.integers(0, 512, 20)}
    tok = np.zeros(slots, np.int32)
    for slot, prompt in prompts.items():
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, jc = _jit("prefill")(jp, pj, jnp.asarray(toks), jc, jnp.int32(slot),
                                jnp.int32(len(prompt)))
        tl, tc = tllama.prefill(tp, pt, torch.from_numpy(toks).long(), tc, slot, len(prompt))
        _close(to_np(tl), np.asarray(jl), f"{name} prefill {slot}")
        tok[slot] = int(np.argmax(np.asarray(jl)[0]))
    pos = np.array([9, -1, 20], np.int32)
    for step in range(2):
        jl, jc = _jit("decode_step")(jp, pj, jnp.asarray(tok), jc, jnp.asarray(pos))
        tl, tc = tllama.decode_step(tp, pt, torch.from_numpy(tok).long(), tc,
                                    torch.from_numpy(pos))
        jl, tl = np.asarray(jl), to_np(tl)
        _close(tl, jl, f"{name} kv{kv_bits} decode step {step}")
        assert np.all(tl[1] == 0.0)
        np.testing.assert_array_equal(tl[[0, 2]].argmax(-1), jl[[0, 2]].argmax(-1))
        tok = jl.argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, pos)
    draft = np.array([[tok[0], 11, 200, 7], [0, 0, 0, 0], [tok[2], 5, 0, 0]], np.int32)
    lens = np.array([4, 0, 2], np.int32)
    jl, jc = _jit("verify_step")(jp, pj, jnp.asarray(draft), jc, jnp.asarray(pos),
                                jnp.asarray(lens), window=64)
    tl, _ = tllama.verify_step(tp, pt, torch.from_numpy(draft).long(), tc,
                               torch.from_numpy(pos), torch.from_numpy(lens), window=64)
    jl, tl = np.asarray(jl), to_np(tl)
    valid = np.arange(4)[None, :] < lens[:, None]
    _close(tl[valid], jl[valid], f"{name} kv{kv_bits} verify_step")
    assert np.all(tl[~valid] == 0.0)
    np.testing.assert_array_equal(tl[valid].argmax(-1), jl[valid].argmax(-1))


@pytest.mark.parametrize("name,kv_bits", PAGED_KV)
def test_decode_step_paged_matches_jax(name, kv_bits, jax_kernels):
    """Prefill two slots into shuffled pages of 16 rows, then two greedy
    decode_step_paged (the paged core) against the JAX function."""
    pj, pt, jp, tp = _model(name)
    ps, n_slots, n_pages = 16, 3, 10
    jc = jpkv.PagedKVCache.create(pj, n_pages, ps, quantized=True, flat=True, kv_bits=kv_bits)
    tc = tpkv.PagedKVCache.create(pt, n_pages, ps, quantized=True, kv_bits=kv_bits,
                                  device="cpu")
    rng = np.random.default_rng(5)
    order = 1 + rng.permutation(n_pages - 1)
    table = np.zeros((n_slots, 3), np.int32)
    table[0, :1], table[2, :3] = order[:1], order[1:4]
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    tok = np.zeros(n_slots, np.int32)
    for slot, n, bucket in ((0, 7, 16), (2, 15, 16)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = rng.integers(0, 512, n)
        jl, jc = _jit("prefill_paged")(jp, pj, jnp.asarray(toks), jc, jt, jnp.int32(slot),
                                      jnp.int32(n))
        tl, _ = tllama.prefill_paged(tp, pt, torch.from_numpy(toks).long(), tc, tt, slot, n)
        _close(to_np(tl), np.asarray(jl), f"{name} prefill_paged {slot}")
        tok[slot] = int(np.argmax(np.asarray(jl)[0]))
    pos = np.array([7, -1, 15], np.int32)   # slot 2 crosses into its second page
    for step in range(2):
        jl, jc = _jit("decode_step_paged")(jp, pj, jnp.asarray(tok), jc, jt, jnp.asarray(pos),
                                          window=48)
        tl, _ = tllama.decode_step_paged(tp, pt, torch.from_numpy(tok).long(), tc, tt,
                                         torch.from_numpy(pos), window=48)
        jl, tl = np.asarray(jl), to_np(tl)
        _close(tl, jl, f"{name} kv{kv_bits} decode_step_paged {step}")
        assert np.all(tl[1] == 0.0)
        np.testing.assert_array_equal(tl[[0, 2]].argmax(-1), jl[[0, 2]].argmax(-1))
        tok = jl.argmax(-1).astype(np.int32)
        pos = np.where(pos >= 0, pos + 1, pos)


def test_head_dim_384_is_refused_at_load(monkeypatch, tmp_path):
    """A head_dim the kernels do not take fails at load with a BackendError
    that names it (and the kernels of the mode), in each kernel mode, before
    any weight is read. Where no kernel runs (the einsum mode, and a paged
    pool under grouped, whose steps take the einsum path) the config passes
    the check and goes on to load (which fails here: the directory holds no
    checkpoint)."""
    params = dict(vocab_size=512, dim=384, n_layers=1, n_heads=2, n_kv_heads=2, head_dim=384,
                  ffn_dim=512)
    paged = {"paged": True, "page_size": 16}

    def config(gen):
        return ModelConfig.from_dict({
            "name": "hd384", "platform": "llm", "architecture": "llama",
            "model_params": params,
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int8"},
            "generation": dict({"max_slots": 2, "max_seq_len": 64}, **gen)})

    for mode, gen, want in (("pallas", {}, "flat"),
                            ("pallas", {"speculation_tokens": 2}, "multi-candidate"),
                            ("pallas", paged, "paged"),
                            ("grouped", {}, "grouped")):
        monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode)
        with pytest.raises(BackendError, match=f"head_dim 384.*{want}"):
            GenerationEngine(str(tmp_path), config(gen), device="cpu").start()
    for mode, gen in (("xla", {}), ("grouped", paged)):
        monkeypatch.setenv("TPUSERVE_DECODE_ATTN", mode)
        with pytest.raises(BackendError, match="no checkpoint"):
            GenerationEngine(str(tmp_path), config(gen), device="cpu").start()
