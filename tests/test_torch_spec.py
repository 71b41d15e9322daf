"""Speculative decoding in tpuserve_torch against the JAX package's.

- (a) decode_attention_wide_cache_multi's plain version against the Pallas
  `_wide_multi_kernel` in interpret mode, and each candidate row against
  the port's own single-query plain version at positions + c;
- (b) llama.draft_lookup against the JAX package's, and against the
  engine's host proposer;
- (c) sampling.spec_accept: greedy rows equal to JAX's, sampled rows by
  distribution (the two packages' random numbers differ);
- (d) verify_step against JAX's with its kernels forced on, int8, packed
  int4 and the default bf16 KV, and against sequential decode_steps;
- (e) verify_step_paged against JAX's (both attend with einsums over the
  gathered window) and against sequential decode_step_paged;
- (f) the engine: tests/test_torch_spec_engine.py and
  tests/test_torch_spec_limits.py;
- (g) on CUDA tensors the multi wrapper launches its kernel or raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.ops import decode_attention as jda
from tpuserve.quant import core as jcore
from tpuserve.serving import paged_kv as jpkv
from tpuserve.serving import sampling as jsampling
from tpuserve_torch import kernels
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.serving import paged_kv as tpkv
from tpuserve_torch.serving import sampling as tsampling
from tpuserve_torch.serving.engine import GenerationEngine, Request, _SlotState
from torch_parity import SMALL, jax_to_torch_params, numpy_weights, to_np

P_J = jllama.LlamaParams(**SMALL)
P_T = tllama.LlamaParams(**SMALL)


@pytest.fixture()
def jax_kernels(monkeypatch):
    """Force the JAX package onto its kernels (interpret mode on the CPU)."""
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


# ------------------------------------------------------------ (a) multi kernel
def _multi_inputs(kind, rep, cands, s=3, hkv=2, l=128, n_layers=2, seed=0):
    rng = np.random.default_rng(seed)
    hd, h = 128, hkv * rep
    w = hkv * hd
    q = (rng.normal(size=(s, cands, h, hd)) / np.sqrt(hd)).astype(np.float32)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, size=(n_layers, s, l, w)).astype(np.int8)
                for _ in range(2))
    elif kind == "int4":
        k, v = (rng.integers(0, 256, size=(n_layers, s, l, w // 2)).astype(np.uint8)
                for _ in range(2))
    else:
        k, v = (rng.normal(size=(n_layers, s, l, w)).astype(np.float32) for _ in range(2))
    ks = vs = None
    if kind in ("int8", "int4"):
        ks, vs = ((rng.uniform(0.5, 1.5, size=(s, hkv, l)) * 0.01).astype(np.float32)
                  for _ in range(2))
    return q, k, v, ks, vs


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16", "f32"])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("cands,block_l", [(1, 32), (3, 128), (3, 32)])
def test_multi_plain_matches_pallas(kind, rep, cands, block_l):
    q, k, v, ks, vs = _multi_inputs(kind, rep, cands)
    l = k.shape[2]
    pos = np.array([5, -1, l - cands], np.int32)     # slot 1 inactive, slot 2 at the end
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)
    if kind == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    jsc = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    tsc = [None if a is None else torch.from_numpy(a) for a in (ks, vs)]
    ref = np.asarray(jda.decode_attention_wide_cache_multi(
        jnp.asarray(q), jk, jv, *jsc, jnp.asarray(pos), 1, block_l=block_l, interpret=True))
    out = to_np(tda.decode_attention_wide_cache_multi(
        torch.from_numpy(q), tk, tv, *tsc, torch.from_numpy(pos), 1, block_l=block_l))
    assert out.shape == (3, cands, 2 * rep, 128)
    # as the flat kernel's parity test: same algorithm (int32 dots, same
    # requant points), so f32 ulps of |out| <= ~2; active slots only, since
    # candidates >= 1 of an inactive slot are garbage for the caller to mask
    np.testing.assert_allclose(out[[0, 2]], ref[[0, 2]], rtol=1e-5, atol=2e-6)
    assert np.all(out[1, 0] == 0.0)
    # row c is the single-query computation at positions + c: a block past
    # its horizon adds nothing, so the two agree to f32 rounding (expected 0)
    for c in range(cands):
        flat = to_np(tda.decode_attention_wide_cache_plain(
            torch.from_numpy(q[:, c]), tk, tv, *tsc, torch.from_numpy(pos + c), 1,
            block_l=block_l, window=l))
        np.testing.assert_allclose(out[[0, 2], c], flat[[0, 2]], rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ (b) drafting
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("cands", [1, 3, 9])
@pytest.mark.parametrize("dyn", ["0", "1"])
def test_multi_split_window_matches_pallas(monkeypatch, kind, cands, dyn):
    """The multi kernel's plain version with the window split into runs of
    whole blocks (the Hopper core's plan at S=3, Hkv=2, L=256) against the
    Pallas kernel in interpret mode under either dynskip, and row c against
    the flat plain version at positions + c, which takes the same plan (S=3
    keeps the flat int8 side off the one-block packed form)."""
    monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", dyn)
    jax.clear_caches()
    try:
        q, k, v, ks, vs = _multi_inputs(kind, 1, cands, s=3, l=256, seed=cands)
        l, block_l = 256, 64
        tq = torch.from_numpy(q)
        g = tda._geometry(tq[:, 0], torch.from_numpy(k), torch.from_numpy(ks), None, block_l,
                          pack=False)
        assert tda._core_plan(g, torch.device("cpu"))[0] >= 2
        pos = np.array([l - cands, 70, -1], np.int32)
        tsc = [torch.from_numpy(a) for a in (ks, vs)]
        ref = np.asarray(jda.decode_attention_wide_cache_multi(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(pos), 1, block_l=block_l, interpret=True))
        out = to_np(tda.decode_attention_wide_cache_multi(
            tq, torch.from_numpy(k), torch.from_numpy(v), *tsc, torch.from_numpy(pos), 1,
            block_l=block_l))
        # active slots only: candidates >= 1 of an inactive slot are garbage
        np.testing.assert_allclose(out[:2], ref[:2], rtol=1e-5, atol=2e-6)
        assert np.all(out[2, 0] == 0.0)
        for c in range(cands):
            flat = to_np(tda.decode_attention_wide_cache_plain(
                torch.from_numpy(q[:, c]), torch.from_numpy(k), torch.from_numpy(v), *tsc,
                torch.from_numpy(pos + c), 1, block_l=block_l, window=l))
            np.testing.assert_allclose(out[:2, c], flat[:2], rtol=1e-6, atol=1e-7)
    finally:
        jax.clear_caches()


def _histories(rng, s, l):
    hist = np.zeros((s, l), np.int32)
    lens = rng.integers(1, l, s).astype(np.int32)
    for i in range(s):
        if i % 2:   # periodic: the lookup fires with full continuations
            period = rng.integers(0, 50, rng.integers(2, 9))
            hist[i, :lens[i]] = np.resize(period, lens[i])
        else:       # random over a small vocabulary: short or no matches
            hist[i, :lens[i]] = rng.integers(0, rng.integers(2, 7), lens[i])
    return hist, lens


def test_draft_lookup_matches_jax_and_host_proposer():
    rng = np.random.default_rng(3)
    s, l, n, k = 8, 80, 3, 4
    jl = jax.jit(jllama.draft_lookup, static_argnums=(2, 3))
    eng = GenerationEngine.__new__(GenerationEngine)   # the proposer is pure
    for trial in range(20):
        hist, lens = _histories(rng, s, l)
        k_cap = rng.integers(0, k + 1, s).astype(np.int32) if trial % 2 else np.full(s, k, np.int32)
        jd, jk = (np.asarray(a) for a in jl(jnp.asarray(hist), jnp.asarray(lens), n, k,
                                            jnp.asarray(k_cap)))
        td, tk = tllama.draft_lookup(torch.from_numpy(hist), torch.from_numpy(lens), n, k,
                                     torch.from_numpy(k_cap))
        np.testing.assert_array_equal(to_np(td), jd)
        np.testing.assert_array_equal(to_np(tk), jk)
        for i in range(s):
            req = Request(prompt_ids=hist[i, :lens[i]].tolist(), max_new_tokens=1)
            st = _SlotState(request=req, next_pos=int(lens[i]) - 1, generated=0,
                            last_token=int(hist[i, lens[i] - 1]))
            # the cap truncates the draft; the match is chosen for k
            want = eng._propose_lookup(st, k=k, n=n)[:int(k_cap[i])]
            assert to_np(td)[i, :int(tk[i])].tolist() == want, (trial, i)


# ------------------------------------------------------------ (c) acceptance
def _accept_both(logits, draft, lens, temperature=0.0, top_k=0):
    s = logits.shape[0]
    jp = jsampling.SamplingParams.create(s, temperature=temperature, top_k=top_k)
    tp = tsampling.SamplingParams.create(s, temperature=temperature, top_k=top_k,
                                         device="cpu")
    jo = jsampling.spec_accept(jnp.asarray(logits), jnp.asarray(draft, jnp.int32),
                               jnp.asarray(lens, jnp.int32), jp, jax.random.PRNGKey(0))
    to = tsampling.spec_accept(torch.from_numpy(logits), torch.from_numpy(draft),
                               torch.from_numpy(lens), tp, torch.Generator().manual_seed(0))
    return [np.asarray(a) for a in jo], [to_np(a) for a in to]


def test_spec_accept_greedy_matches_jax():
    rng = np.random.default_rng(1)
    s, c, v = 6, 4, 16
    logits = rng.normal(size=(s, c, v)).astype(np.float32)
    g = logits.argmax(-1)
    draft = rng.integers(0, v, (s, c)).astype(np.int64)
    draft[0, 1:] = g[0, :3]                   # all drafts accepted: bonus token
    draft[1, 1], draft[1, 2] = g[1, 0], (g[1, 1] + 1) % v   # one accepted, then rejected
    draft[2, 1] = (g[2, 0] + 3) % v           # first draft rejected
    lens = np.array([4, 4, 3, 1, 0, 2], np.int64)   # row 3 no drafts, row 4 inactive
    (jo, jlp, ja), (to, tlp, ta) = _accept_both(logits, draft, lens)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(to, jo)
    assert list(ta[:3]) == [3, 1, 0]
    # logprobs under the unfiltered distribution: f32 logsumexp, a few ulps
    np.testing.assert_allclose(tlp, jlp, rtol=1e-5, atol=1e-5)


# the sampled rows: S copies of one logits row in one call, so S independent
# draws. A frequency over N draws has a standard deviation of at most
# sqrt(0.25 / N): 0.0079 at N = 4000, 0.0065 at 6000 (and over the ~2,500
# accepted rows of the conditional test at most 0.010), so 0.03 and 0.05
# are about 4-5 standard deviations
def _sampled(seed, n, draft_row, lens_row, top_k=0, gen_seed=42):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 3, 8)).astype(np.float32)
    logits = torch.from_numpy(np.repeat(base, n, axis=0))
    draft = torch.tensor([draft_row] * n)
    lens = torch.full((n,), lens_row)
    params = tsampling.SamplingParams.create(n, temperature=1.0, top_k=top_k, device="cpu")
    out, _, acc = tsampling.spec_accept(logits, draft, lens, params,
                                        torch.Generator().manual_seed(gen_seed))
    return base[0], to_np(out), to_np(acc)


def test_spec_accept_first_token_marginal():
    """The first emitted token's marginal over accept and residual is p_0,
    for a likely and an unlikely draft."""
    base, _, _ = _sampled(3, 1, [0, 0, 1], 3)
    p0 = torch.softmax(torch.from_numpy(base[0]), -1).numpy()
    for draft_tok in (int(np.argmax(p0)), int(np.argmin(p0))):
        _, out, _ = _sampled(3, 4000, [0, draft_tok, 1], 3)
        freq = np.bincount(out[:, 0], minlength=8) / len(out)
        np.testing.assert_allclose(freq, p0, atol=0.03)


def test_spec_accept_second_token_conditional():
    """Given the first draft accepted, the second emitted token follows p_1."""
    base, _, _ = _sampled(5, 1, [0, 0, 2], 3)
    p = torch.softmax(torch.from_numpy(base), -1).numpy()
    _, out, acc = _sampled(5, 6000, [0, int(np.argmax(p[0])), 2], 3)
    sel = out[acc >= 1, 1]
    assert len(sel) > 500
    np.testing.assert_allclose(np.bincount(sel, minlength=8) / len(sel), p[1], atol=0.05)


def test_spec_accept_masks_respected():
    """top_k flows into acceptance: a draft outside the top-k is always
    rejected, and the emitted token lies inside it."""
    base, _, _ = _sampled(11, 1, [0, 0, 0], 2)
    order = np.argsort(-base[0])
    _, out, acc = _sampled(11, 200, [0, int(order[5]), 0], 2, top_k=2)
    assert np.all(acc == 0)
    assert set(out[:, 0]) <= {int(order[0]), int(order[1])}


# ------------------------------------------------------------ (d) verify_step
@pytest.fixture(scope="module")
def weights():
    raw = jllama.fuse_params({k: jnp.asarray(v) for k, v in numpy_weights().items()}, P_J)
    jp = jcore.quantize_param_tree(
        raw, bits=4, group_size=128,
        predicate=lambda name, a: a.ndim == 2 and name.endswith("kernel"))
    return jp, jax_to_torch_params(jp)


def _close(out, ref, what, frac=1e-2):
    # as tests/test_torch_llama.py: f32 model, same algorithms; a K/V value
    # on a quantizer rounding boundary moves one code (measured there up to
    # 2.2e-3 of the logit range); the bound leaves 4x
    tol = frac * float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


def _codes(cache, kv_bits, name):
    t = getattr(cache, name)
    if isinstance(t, torch.Tensor):
        return to_np(tllama.unpack_kv_codes(t) if kv_bits == 4 else t).astype(np.int32)
    return np.asarray(jllama.unpack_kv_codes(t) if kv_bits == 4 else t).astype(np.int32)


VERIFY_TOKENS = np.array([[11, 200, 7, 93], [0, 0, 0, 0], [301, 5, 0, 0]], np.int32)
VERIFY_LENS = np.array([4, 0, 2], np.int32)


@pytest.mark.parametrize("kv_bits", [8, 4, 16])
def test_verify_step_matches_jax_and_sequential_decode(weights, jax_kernels, kv_bits):
    """kv_bits 16: the JAX package's default cache (kv_cache none: bf16, no
    scales), whose verify runs the multi kernel's float route."""
    jp, tp = weights
    slots, max_len = 3, 64
    quantized = kv_bits != 16
    jc = jllama.KVCache.create(P_J, slots, max_len, quantized=quantized, flat=True,
                               kv_bits=min(kv_bits, 8))
    tc = tllama.KVCache.create(P_T, slots, max_len, quantized=quantized, kv_bits=min(kv_bits, 8),
                               device="cpu")
    rng = np.random.default_rng(7)
    prompts = {0: rng.integers(0, SMALL["vocab_size"], 9), 2: rng.integers(0, 512, 30)}
    for slot, prompt in prompts.items():
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        _, jc = jllama.prefill(jp, P_J, jnp.asarray(toks), jc, jnp.int32(slot),
                               jnp.int32(len(prompt)))
        tllama.prefill(tp, P_T, torch.from_numpy(toks).long(), tc, slot, len(prompt))
    pos = np.array([9, -1, 30], np.int32)
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    before = {n: getattr(tc, n).clone() for n in names}
    seq_cache = tllama.KVCache(**{n: before[n].clone() if n in before else None
                                  for n in ("k", "v", "k_scale", "v_scale")})

    jl, jc = jllama.verify_step(jp, P_J, jnp.asarray(VERIFY_TOKENS), jc, jnp.asarray(pos),
                                jnp.asarray(VERIFY_LENS), window=64)
    tl, _ = tllama.verify_step(tp, P_T, torch.from_numpy(VERIFY_TOKENS).long(), tc,
                               torch.from_numpy(pos), torch.from_numpy(VERIFY_LENS), window=64)
    jl, tl = np.asarray(jl), to_np(tl)
    valid = np.arange(4)[None, :] < VERIFY_LENS[:, None]
    _close(tl[valid], jl[valid], "verify_step vs JAX")
    assert np.all(tl[~valid] == 0.0)
    np.testing.assert_array_equal(tl[valid].argmax(-1), jl[valid].argmax(-1))

    # the written rows: codes one apart at most where a value sits on a
    # quantizer rounding boundary (as test_torch_llama), scales to f32 ulps
    rows = [(s, pos[s] + c) for s in range(3) for c in range(VERIFY_LENS[s])]
    for name in ("k", "v"):
        if not quantized:
            a = np.asarray(getattr(jc, name).astype(jnp.float32))
            b = to_np(getattr(tc, name).float())
            wa = np.stack([a[:, s, p] for s, p in rows])
            wb = np.stack([b[:, s, p] for s, p in rows])
            # layer 1's K/V follow layer 0's attention, whose kernels sum
            # in another order and can round a P entry the other way:
            # measured 2^-8.9 of the values' range, 0.4% of them unequal
            assert np.abs(wa - wb).max() <= 2 ** -8 * np.abs(wa).max()
            assert (wa != wb).mean() < 1e-2
            continue
        a, b = _codes(jc, kv_bits, name), _codes(tc, kv_bits, name)
        wa = np.stack([a[:, s, p] for s, p in rows])
        wb = np.stack([b[:, s, p] for s, p in rows])
        assert np.abs(wa - wb).max() <= 1 and (wa != wb).mean() < 1e-3
    for name in ("k_scale", "v_scale") if quantized else ():
        a, b = np.asarray(getattr(jc, name)), to_np(getattr(tc, name))
        np.testing.assert_allclose(np.stack([b[:, s, :, p] for s, p in rows]),
                                   np.stack([a[:, s, :, p] for s, p in rows]), rtol=1e-5)
    # every other row, the inactive slot's and the padded rows' included,
    # is untouched
    written = np.zeros((3, max_len), bool)
    for s, p in rows:
        written[s, p] = True
    for name, t in before.items():
        after = getattr(tc, name)
        keep = torch.from_numpy(~written)
        if name.endswith("scale"):
            assert torch.equal(after.permute(0, 1, 3, 2)[:, keep], t.permute(0, 1, 3, 2)[:, keep])
        else:
            assert torch.equal(after[:, keep], t[:, keep])

    # C sequential decode steps of the port on a copy of the cache: the
    # multi-candidate path against the single-query one. They differ by the
    # K/V of each step computed in a batch of another shape (f32 order, a
    # code here and there), so the bound is that of the JAX comparison
    for c in range(4):
        step_pos = np.where(c < VERIFY_LENS, pos + c, -1).astype(np.int32)
        sl, _ = tllama.decode_step(tp, P_T, torch.from_numpy(VERIFY_TOKENS[:, c]).long(),
                                   seq_cache, torch.from_numpy(step_pos), window=64)
        sl = to_np(sl)
        live = c < VERIFY_LENS
        _close(tl[live, c], sl[live], f"verify_step vs decode step {c}")
        np.testing.assert_array_equal(tl[live, c].argmax(-1), sl[live].argmax(-1))


# ------------------------------------------------------------ (e) paged verify
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_verify_step_paged_matches_jax_and_sequential_decode(weights, jax_kernels, kv_bits):
    jp, tp = weights
    ps, n_pages = 16, 12
    jc = jpkv.PagedKVCache.create(P_J, n_pages, ps, quantized=True, flat=True, kv_bits=kv_bits)
    tc = tpkv.PagedKVCache.create(P_T, n_pages, ps, quantized=True, kv_bits=kv_bits,
                                   device="cpu")
    order = 1 + np.random.default_rng(2).permutation(n_pages - 1)
    table = np.zeros((3, 4), np.int32)
    table[0, :2], table[2, :3] = order[:2], order[2:5]     # shuffled pages
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    rng = np.random.default_rng(8)
    prompts = {0: rng.integers(0, 512, 9), 2: rng.integers(0, 512, 30)}
    for slot, prompt in prompts.items():
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(prompt)] = prompt
        _, jc = jllama.prefill_paged(jp, P_J, jnp.asarray(toks), jc, jt, jnp.int32(slot),
                                     jnp.int32(len(prompt)))
        tllama.prefill_paged(tp, P_T, torch.from_numpy(toks).long(), tc, tt, slot, len(prompt))
    pos = np.array([9, -1, 30], np.int32)
    seq_cache = tpkv.PagedKVCache(**{n: getattr(tc, n).clone()
                                     for n in ("k", "v", "k_scale", "v_scale")})
    zero_page = {n: getattr(tc, n)[:, 0].clone() for n in ("k", "v", "k_scale", "v_scale")}

    jl, jc = jllama.verify_step_paged(jp, P_J, jnp.asarray(VERIFY_TOKENS), jc, jt,
                                      jnp.asarray(pos), jnp.asarray(VERIFY_LENS), window=48)
    tl, _ = tllama.verify_step_paged(tp, P_T, torch.from_numpy(VERIFY_TOKENS).long(), tc, tt,
                                     torch.from_numpy(pos), torch.from_numpy(VERIFY_LENS),
                                     window=48)
    jl, tl = np.asarray(jl), to_np(tl)
    valid = np.arange(4)[None, :] < VERIFY_LENS[:, None]
    # the same einsum algorithm in both packages: the bound of (d)
    _close(tl[valid], jl[valid], "verify_step_paged vs JAX")
    np.testing.assert_array_equal(tl[valid].argmax(-1), jl[valid].argmax(-1))
    assert np.all(tl[~valid] == 0.0)
    for name in ("k", "v"):   # the pools hold the same codes (as (d))
        a, b = _codes(jc, kv_bits, name), _codes(tc, kv_bits, name)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3
    for name, t in zero_page.items():   # invalid rows are never written
        assert torch.equal(getattr(tc, name)[:, 0], t)

    # sequential decode_step_paged runs the paged kernel's algorithm (int8
    # q and P requant) where the verify attends in bf16 einsums, as in the
    # JAX package: the two differ by those roundings, a few 1e-2 of the
    # logit range (the JAX package's own test allows 5e-2 absolute)
    for c in range(4):
        step_pos = np.where(c < VERIFY_LENS, pos + c, -1).astype(np.int32)
        sl, _ = tllama.decode_step_paged(tp, P_T, torch.from_numpy(VERIFY_TOKENS[:, c]).long(),
                                         seq_cache, tt, torch.from_numpy(step_pos), window=48)
        live = c < VERIFY_LENS
        _close(tl[live, c], to_np(sl)[live], f"verify_step_paged vs decode step {c}",
               frac=5e-2)


# ------------------------------------------------------------ (g) dispatch
class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("rc", [0, 700])
def test_multi_cuda_tensors_launch_the_kernel_or_raise(monkeypatch, rc):
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or rc

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "check", lambda code, what: (
        None if code == 0 else (_ for _ in ()).throw(RuntimeError(f"{what}: {code}"))))

    def plain_must_not_run(*a, **kw):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(tda, "decode_attention_wide_cache_multi_plain", plain_must_not_run)
    q, k, v, ks, vs = _multi_inputs("int4", 1, 9, l=64)
    fq = torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(q))
    before = tda.multi_launches
    call = lambda: tda.decode_attention_wide_cache_multi(
        fq, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ks),
        torch.from_numpy(vs), torch.zeros(3, dtype=torch.int32), 1)
    if rc == 0:
        call()
    else:
        with pytest.raises(RuntimeError):
            call()
    assert [name for name, _ in calls] == ["tpuserve_decode_attention_core"]
    # S, C, H, Hkv, L, layer, window, block_l, row stride; kind (int4), heads per block
    assert calls[0][1][12:21] == (3, 9, 2, 2, 64, 1, 64, 64, 128)
    assert calls[0][1][24:26] == (1, 2)
    assert tda.multi_launches == before + (1 if rc == 0 else 0)
    with pytest.raises(ValueError, match="candidates"):
        tda.decode_attention_wide_cache_multi(
            torch.Tensor._make_subclass(_FakeCuda, torch.zeros(3, 17, 2, 128)),
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ks),
            torch.from_numpy(vs), torch.zeros(3, dtype=torch.int32), 1)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_multi_float_cache_reaches_the_core(monkeypatch, kind):
    """A float cache's multi call reaches the Hopper core's entry once and
    nothing else: the float kind (2 bf16, 3 f32; +16 under
    TPUSERVE_ATTN_DYNSKIP=0), null scales, the row stride in bytes and the
    whole window in one run (no split, no workspace), however small the
    grid (S=3, where an int8 cache splits)."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(tda, "decode_attention_wide_cache_multi_plain",
                        lambda *a, **kw: pytest.fail("plain version taken for a CUDA tensor"))
    q, k, v, _, _ = _multi_inputs(kind, 2, 9, l=256)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    fq = torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(q).to(torch.bfloat16))
    for skip in ("1", "0"):
        monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", skip)
        out = tda.decode_attention_wide_cache_multi(fq, tk, tv, None, None,
                                                    torch.zeros(3, dtype=torch.int32), 1,
                                                    block_l=64)
        assert out.shape == (3, 9, 4, 128) and out.dtype == torch.float32
        name, args = calls[-1]
        assert [n for n, _ in calls] == ["tpuserve_decode_attention_core"] * len(calls)
        assert args[3] == args[4] == 0 and args[8] == args[9] == 0   # no scales, no workspace
        assert args[10:12] == (1, 0)                                  # bf16 q
        # S, C, H, Hkv, L, layer, window, block_l, row stride (bytes)
        assert args[12:21] == (3, 9, 4, 2, 256, 1, 256, 64, 256 * tk.element_size())
        kind_code = {"bf16": 2, "f32": 3}[kind] + (16 if skip == "0" else 0)
        assert args[24:28] == (kind_code, 2, 1, 4)                    # kind, nq, splits, bps
    assert len(calls) == 2


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_flat_float_cache_shares_the_multi_core(monkeypatch, kind):
    """A float cache's flat call (the decode step) reaches the Hopper core's
    entry with the arguments of the multi call at C = 1, so the decode step
    and the speculative verify run one kernel; the prebuilt-Q_wide call
    (reading every block) and a float pool's paged call (one page a block,
    the whole window in one run) reach it too. A block_l whose scores the
    core's shared memory cannot hold is refused before any launch."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    for plain in ("decode_attention_wide_cache_plain", "decode_attention_wide_cache_multi_plain",
                  "decode_attention_wide_plain"):
        monkeypatch.setattr(tda, plain, lambda *a, **kw: pytest.fail("plain version taken"))
    monkeypatch.setenv("TPUSERVE_ATTN_DYNSKIP", "1")
    q, k, v, _, _ = _multi_inputs(kind, 2, 1, l=256)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    fq1 = torch.Tensor._make_subclass(_FakeCuda, qb)
    fq = torch.Tensor._make_subclass(_FakeCuda, qb[:, 0].contiguous())
    pos = torch.tensor([255, -1, 7], dtype=torch.int32)
    before = tda.launches
    out = tda.decode_attention_wide_cache(fq, tk, tv, None, None, pos, 1, block_l=64)
    tda.decode_attention_wide_cache_multi(fq1, tk, tv, None, None, pos, 1, block_l=64)
    assert out.shape == (3, 4, 128) and tda.launches == before + 1
    assert [n for n, _ in calls] == ["tpuserve_decode_attention_core"] * 2
    (_, flat), (_, multi) = calls
    assert flat[3] == flat[4] == flat[8] == flat[9] == 0          # no scales, no workspace
    assert flat[10:28] == multi[10:28]                             # one kernel, one launch form
    code = {"bf16": 2, "f32": 3}[kind]
    assert flat[24:28] == (code, 2, 1, 4)                          # kind, nq, splits, bps
    tda.decode_attention_wide(fq, tk[1].view(3, 256, 2, 128), tv[1].view(3, 256, 2, 128), None,
                              None, pos, block_l=128)
    name, wide = calls[-1]
    assert name == "tpuserve_decode_attention_core"
    assert wide[24:28] == (code + 16, 2, 1, 2)                     # every block read
    pools = [t.reshape(2, 3 * 4, 64, 256) for t in (tk, tv)]       # 12 pages of 64 rows
    table = torch.arange(12, dtype=torch.int32).flip(0).view(3, 4)
    out = tda.decode_attention_wide_paged(fq, *pools, None, None, table, pos, 1)
    name, paged = calls[-1]
    assert out.shape == (3, 4, 128) and name == "tpuserve_decode_attention_core"
    assert paged[6] == table.data_ptr() and paged[3] == paged[4] == 0
    # layer, window, block_l = ps, row stride, pages, scale rows (none)
    assert paged[17:23] == (1, 256, 64, 256 * tk.element_size(), 12, 0)
    assert paged[24:28] == (code, 2, 1, 4)
    monkeypatch.setattr(tda, "_SMEM_LIMIT", 1024)
    with pytest.raises(ValueError, match="shared memory"):
        tda.decode_attention_wide_cache(fq, tk, tv, None, None, pos, 1, block_l=64)
    assert len(calls) == 4


@pytest.mark.parametrize("cache", ["int8", "int4", "bf16", "f32"])
def test_core_smem_bytes_admit_every_verify_width(cache):
    """The core's shared memory (core_smem_bytes, the C smem_bytes' mirror)
    for each cache: a bf16 stage is 64 rows of 272 bytes, an f32 one of 528.
    At the default block_l 128 every verify width (C <= 16 candidates of 1,
    2, 4 or 8 query heads a unit) is admitted and stays under the H100's
    227 KB; wherever check_multi_kernel admits a shape the bytes are under
    it, and an f32 cache's 2048-row blocks of 32 rows are refused."""
    kind = tda._CACHE_KINDS[cache]
    assert tda._stage_bytes(kind) == 64 * {"bf16": 272, "f32": 528}.get(cache, 144) + 4 * 68 * 4
    for block_l in (16, 64, 128, 256, 512, 2048):
        for cands in range(1, 17):
            for nq in (1, 2, 4, 8):
                smem = tda.core_smem_bytes(tda.core_rows(cands, nq)[1], block_l, kind=kind)
                try:
                    tda.check_multi_kernel(cands, nq, block_l, cache=cache)
                except ValueError:
                    assert block_l > 128 and smem > 227 * 1024
                    continue
                assert smem <= 227 * 1024
    # the bf16 core at 32 rows and block_l 128: 4 stages of 18,496 bytes, q
    # rows 32 x 272, scores 32 x 132 x 4, bf16 P 32 x 272, V scales, stats
    assert tda.core_smem_bytes(32, 128, kind=2) == (4 * 18496 + 32 * 272 + 32 * 132 * 4
                                                     + 32 * 272 + 1024 + 24 * 32 * 4)
    with pytest.raises(ValueError, match="shared memory"):
        tda.check_multi_kernel(16, 8, 2048, cache="f32")
