"""The paged KV path of tpuserve_torch against the JAX package's.

- (a) the page allocator and PageTableManager: one seeded sequence of
  ensure / release / admit_shared calls gives identical tables, free pages,
  prefix hits and cached blocks in both packages (page ids included);
- (b) decode_attention_wide_paged's plain version against the Pallas paged
  kernel (`_wide_kernel` with paged_sc) in interpret mode;
- (c) the paged plain version against the flat plain version on the same
  KV with one page per block: equal;
- (d) prefill_paged, prefill_paged_suffix and decode_step_paged against the
  JAX package with its kernels forced on, int8 and int4 pools;
- (e)-(g) the paged engine: tests/test_torch_paged_engine.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.ops import decode_attention as jda
from tpuserve.quant import core as jcore
from tpuserve.serving import paged_kv as jpkv
from tpuserve.utils.errors import ResourceExhaustedError as JExhausted
from tpuserve_torch import interop, kernels
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.serving import paged_kv as tpkv
from tpuserve_torch.utils.errors import ResourceExhaustedError as TExhausted
from torch_parity import SMALL, jax_to_torch_params, numpy_weights, to_np

P_J = jllama.LlamaParams(**SMALL)
P_T = tllama.LlamaParams(**SMALL)


@pytest.fixture()
def jax_kernels(monkeypatch):
    """Force the JAX package onto its kernels (interpret mode on the CPU):
    flat pools, the Pallas paged decode kernel and Pallas quant-matmul."""
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


# ------------------------------------------------------------ (a) allocator
def _ptm_pair(monkeypatch, n_pages, ps, n_slots, max_len):
    # the JAX package takes its native allocator when built; hold the port
    # against the pure-Python one, whose semantics the native one copies
    monkeypatch.setattr(jpkv, "make_allocator", jpkv._PyKvAllocator)
    j = jpkv.PageTableManager(n_pages, ps, n_slots, max_len, prefix_sharing=True)
    t = tpkv.PageTableManager(n_pages, ps, n_slots, max_len, prefix_sharing=True,
                              device="cpu")
    return j, t


def _same_state(j, t):
    np.testing.assert_array_equal(t.table, j.table)
    assert (t.free_pages, t.cached_blocks, t.prefix_hits, t.prefix_hit_tokens) == \
        (j.free_pages, j.cached_blocks, j.prefix_hits, j.prefix_hit_tokens)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_table_manager_matches_jax(monkeypatch, seed):
    """400 random calls on a pool small enough that shared blocks are
    evicted (LRU) and ensure runs out of pages."""
    ps, n_slots, max_len = 4, 4, 32
    j, t = _ptm_pair(monkeypatch, 14, ps, n_slots, max_len)
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 50, 24).tolist() for _ in range(4)]
    exhausted = evicted = 0
    for _ in range(400):
        slot = int(rng.integers(n_slots))
        op = rng.choice(["admit", "ensure", "release"], p=[0.3, 0.5, 0.2])
        if op == "admit":
            stem = stems[int(rng.integers(len(stems)))]
            prompt = stem[:int(rng.integers(2, 24))] + rng.integers(0, 50, 3).tolist()
            before = j.cached_blocks
            assert t.admit_shared(slot, prompt) == j.admit_shared(slot, prompt)
            evicted += j.cached_blocks < before
        elif op == "ensure":
            n = int(rng.integers(1, max_len + 1))
            try:
                j.ensure(slot, n)
                j_err = False
            except JExhausted:
                j_err = True
            try:
                t.ensure(slot, n)
                t_err = False
            except TExhausted:
                t_err = True
            assert t_err == j_err
            exhausted += j_err
        else:
            j.release(slot)
            t.release(slot)
        _same_state(j, t)
    assert exhausted > 0 and t.prefix_hits > 0


def test_allocator_run_affine_and_lru_eviction(monkeypatch):
    """Interleaved one-page growth gives chains of a few physical runs
    (soft reservations grow with the chain; round-robin placement would
    give five one-page runs), and a pool under pressure evicts the least
    recently used unreferenced block first, in both packages alike."""
    ja, ta = jpkv._PyKvAllocator(40, 4), tpkv._PyKvAllocator(40, 4)
    for step in range(1, 6):
        for seq in (0, 1, 2):
            assert ta.ensure(seq, 4 * step) == ja.ensure(seq, 4 * step)
    for seq in (0, 1, 2):
        chain = ta.page_table(seq)
        assert chain == ja.page_table(seq)
        assert len(ta._runs(chain)) == 2   # e.g. [0, 1, 6, 7, 8]
    assert not ta.ensure(3, 4 * 40) and not ja.ensure(3, 4 * 40)

    j, t = _ptm_pair(monkeypatch, 6, 4, 2, 16)  # 5 usable pages
    a, b = list(range(9)), list(range(100, 109))
    for m in (j, t):
        m.admit_shared(0, a)   # registers 2 blocks
        m.release(0)
        m.admit_shared(1, b)   # 2 more blocks, newer
        m.release(1)
        m.admit_shared(0, a)   # touches a's blocks: b's are now the oldest
        m.release(0)
        m.ensure(1, 12)        # 3 private pages: 1 free, so evict 2 blocks
    _same_state(j, t)
    assert t.cached_blocks == 2 and t.admit_shared(0, a) == (8, 8)
    with pytest.raises(TExhausted):
        t.ensure(0, 16)


# ------------------------------------------------------------ (b), (c) kernel
def _pool_inputs(kind, ps, n_slots=4, h=4, hkv=2, table_pages=4, n_layers=2, seed=0):
    """Random pools, scale pools and a table of shuffled distinct pages."""
    rng = np.random.default_rng(seed)
    hd, hp = 128, tpkv.pad8(hkv)
    w = hkv * hd
    n_pages = n_slots * table_pages + 3
    q = (rng.normal(size=(n_slots, h, hd)) / np.sqrt(hd)).astype(np.float32)
    shape = (n_layers, n_pages, ps, w // 2 if kind == "int4" else w)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
    elif kind == "int4":
        k, v = (rng.integers(0, 256, size=shape).astype(np.uint8) for _ in range(2))
    else:
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    ks = vs = None
    if kind in ("int8", "int4"):
        ks, vs = ((rng.uniform(0.5, 1.5, size=(n_layers, n_pages, hp, ps)) * 0.01)
                  .astype(np.float32) for _ in range(2))
    table = (1 + rng.permutation(n_pages - 1)[:n_slots * table_pages]).reshape(
        n_slots, table_pages).astype(np.int32)
    return q, k, v, ks, vs, table


def _torch_pools(kind, k, v, ks, vs):
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    tsc = [None if a is None else torch.from_numpy(a) for a in (ks, vs)]
    return tk, tv, tsc


PAGED_CASES = [
    # (kind, ps, layer, window): positions cover ps-1, ps and -1
    ("int8", 16, 1, None),
    ("int8", 16, 0, 32),      # window shorter than the table (2 of 4 pages)
    ("int8", 128, 1, None),
    ("int4", 16, 1, None),
    ("int4", 128, 0, 256),
    ("bf16", 16, 1, None),
    ("bf16", 128, 0, None),
]


@pytest.mark.parametrize("kind,ps,layer,window", PAGED_CASES)
def test_paged_plain_matches_pallas(kind, ps, layer, window):
    q, k, v, ks, vs, table = _pool_inputs(kind, ps, seed=ps + layer)
    win = window or table.shape[1] * ps
    pos = np.array([ps - 1, -1, ps, win - 1], np.int32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if kind == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    jsc = [None if a is None else jnp.asarray(a) for a in (ks, vs)]
    ref = np.asarray(jda.decode_attention_wide_paged(
        jnp.asarray(q), jk, jv, *jsc, jnp.asarray(table), jnp.asarray(pos), layer,
        window=window, interpret=True))
    tk, tv, tsc = _torch_pools(kind, k, v, ks, vs)
    out = to_np(tda.decode_attention_wide_paged(
        torch.from_numpy(q), tk, tv, *tsc, torch.from_numpy(table), torch.from_numpy(pos),
        layer, window=window))
    # same algorithm (int32 dots, one P requant per page): f32 ulps of |out|
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("s,hkv,ps,pages", [(2, 2, 64, 4), (4, 4, 128, 4)])
def test_paged_split_window_matches_pallas(kind, s, hkv, ps, pages):
    """The paged plain version with the window split into runs of whole
    pages (the Hopper core's plan at a small grid) against the Pallas
    kernel in interpret mode: f32 ulps of |out|."""
    q, k, v, ks, vs, table = _pool_inputs(kind, ps, n_slots=s, h=hkv, hkv=hkv,
                                          table_pages=pages, seed=s + ps)
    win = pages * ps
    units = hkv // 2 if kind == "int4" else hkv
    assert tda.split_plan(units, s, pages, 132)[0] >= 2
    pos = np.array([win - 1, ps + 5, -1, 2 * ps][:s], np.int32)
    ref = np.asarray(jda.decode_attention_wide_paged(
        *(jnp.asarray(a) for a in (q, k, v, ks, vs, table, pos)), 1, interpret=True))
    tk, tv, tsc = _torch_pools(kind, k, v, ks, vs)
    out = to_np(tda.decode_attention_wide_paged(
        torch.from_numpy(q), tk, tv, *tsc, torch.from_numpy(table), torch.from_numpy(pos), 1))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
def test_paged_plain_equals_flat_plain(kind):
    """The same KV scattered into shuffled pages and laid out contiguously:
    with block_l = ps the two plain versions do the same arithmetic."""
    ps, layer = 16, 1
    q, k, v, ks, vs, table = _pool_inputs(kind, ps, seed=7)
    n_slots, n_cols = table.shape
    win = n_cols * ps
    pos = np.array([ps - 1, -1, ps, win - 1], np.int32)
    tk, tv, tsc = _torch_pools(kind, k, v, ks, vs)
    tt, tq, tpos = torch.from_numpy(table), torch.from_numpy(q), torch.from_numpy(pos)
    paged = tda.decode_attention_wide_paged_plain(tq, tk, tv, *tsc, tt, tpos, layer)
    # the flat cache holds one junk page past the window, so the flat side
    # runs its L-blocked form (not the whole-row multi-slot form)
    idx = tt.long()

    def flat(pool):
        rows = pool[:, idx].reshape(pool.shape[0], n_slots, win, -1)
        return torch.cat([rows, pool[:, :1].expand(-1, n_slots, -1, -1)], dim=2)

    def flat_scales(pool):
        sc = pool[layer][idx].permute(0, 2, 1, 3).reshape(n_slots, -1, win)[:, :2]
        return torch.cat([sc, sc[:, :, :ps]], dim=2)

    fk, fv = flat(tk), flat(tv)
    fks = fvs = None
    if tsc[0] is not None:
        fks, fvs = flat_scales(tsc[0]), flat_scales(tsc[1])
    ref = tda.decode_attention_wide_cache_plain(tq, fk, fv, fks, fvs, tpos, layer,
                                                window=win, block_l=ps)
    torch.testing.assert_close(paged, ref, rtol=0, atol=0)


def test_paged_cuda_tensors_launch_the_kernel_or_raise(monkeypatch):
    """A CUDA tensor goes to the paged kernel and never to the plain version;
    a refused launch raises, and a bad window or scale pool is refused
    before any launch."""
    from test_torch_ops import _FakeCuda, _FakeLib, _plain_must_not_run

    fake = _FakeLib(0)
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "check", lambda code, what: (
        None if code == 0 else (_ for _ in ()).throw(RuntimeError(f"{what}: {code}"))))
    monkeypatch.setattr(tda, "decode_attention_wide_paged_plain", _plain_must_not_run)
    q, k, v, ks, vs, table = _pool_inputs("int8", 16)
    fq = torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(q))
    tk, tv, tsc = _torch_pools("int8", k, v, ks, vs)
    tt = torch.from_numpy(table)
    pos = torch.zeros(4, dtype=torch.int32)
    before = tda.paged_launches
    tda.decode_attention_wide_paged(fq, tk, tv, *tsc, tt[:, :2], pos, 0)  # strided table
    assert fake.calls == ["tpuserve_decode_attention_core"]   # int8 pools: the Hopper core
    assert tda.paged_launches == before + 1
    with pytest.raises(ValueError, match="multiple of page_size"):
        tda.decode_attention_wide_paged(fq, tk, tv, *tsc, tt, pos, 0, window=24)
    with pytest.raises(ValueError, match="float32"):
        tda.decode_attention_wide_paged(fq, tk, tv, *(s.to(torch.bfloat16) for s in tsc),
                                        tt, pos, 0)
    fake.rc = 700
    with pytest.raises(RuntimeError):
        tda.decode_attention_wide_paged(fq, tk, tv, *tsc, tt, pos, 0)
    assert tda.paged_launches == before + 1


# ------------------------------------------------------------ (d) model
@pytest.fixture(scope="module")
def weights():
    raw = jllama.fuse_params({k: jnp.asarray(v) for k, v in numpy_weights().items()}, P_J)
    jp = jcore.quantize_param_tree(
        raw, bits=4, group_size=128,
        predicate=lambda name, a: a.ndim == 2 and name.endswith("kernel"))
    return jp, jax_to_torch_params(jp)


def _close(out, ref, what):
    # as tests/test_torch_llama.py: f32 model, same algorithms; a K/V value
    # on a quantizer rounding boundary moves one code (measured there up to
    # 2.2e-3 of the logit range); the bound leaves 4x
    tol = 1e-2 * float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_model_matches_jax(weights, jax_kernels, kv_bits):
    jp, tp = weights
    ps, n_slots, n_pages = 16, 5, 14
    jc = jpkv.PagedKVCache.create(P_J, n_pages, ps, quantized=True, flat=True,
                                  kv_bits=kv_bits)
    tc = tpkv.PagedKVCache.create(P_T, n_pages, ps, quantized=True, kv_bits=kv_bits,
                                   device="cpu")
    rng = np.random.default_rng(11)
    order = 1 + rng.permutation(n_pages - 1)   # shuffled pool pages
    table = np.zeros((n_slots, 4), np.int32)
    table[0, :1] = order[0:1]                  # 5-token prompt, bucket 16
    table[2, :4] = order[1:5]                  # 40-token prompt, bucket 64
    table[1, :3] = [table[2, 0], table[2, 1], order[5]]  # shares 2 of slot 2's pages
    table[3, :3] = order[6:9]                  # 30 tokens in chunks of 16
    vocab = SMALL["vocab_size"]
    short, long = rng.integers(0, vocab, 5), rng.integers(0, vocab, 40)
    chunked = rng.integers(0, vocab, 30)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    first = np.zeros(n_slots, np.int32)

    def both_prefill(slot, toks, n):
        nonlocal jc
        jl, jc = jllama.prefill_paged(jp, P_J, jnp.asarray(toks), jc, jt, jnp.int32(slot),
                                      jnp.int32(n))
        tl, _ = tllama.prefill_paged(tp, P_T, torch.from_numpy(toks).long(), tc, tt, slot, n)
        return np.asarray(jl), to_np(tl)

    def both_suffix(slot, toks, start, n, window):
        nonlocal jc
        jl, jc = jllama.prefill_paged_suffix(jp, P_J, jnp.asarray(toks), jc, jt,
                                             jnp.int32(slot), jnp.int32(start), jnp.int32(n),
                                             window=window)
        tl, _ = tllama.prefill_paged_suffix(tp, P_T, torch.from_numpy(toks).long(), tc, tt,
                                            slot, start, n, window=window)
        return np.asarray(jl), to_np(tl)

    for slot, prompt, bucket in ((0, short, 16), (2, long, 64)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(prompt)] = prompt
        jl, tl = both_prefill(slot, toks, len(prompt))
        _close(tl, jl, f"prefill_paged slot {slot}")
        first[slot] = np.argmax(jl[0])
        assert np.argmax(tl[0]) == first[slot]
    # slot 1: the same 40 tokens, the first 32 from slot 2's pages
    toks = np.zeros((1, 16), np.int32)
    toks[0, :8] = long[32:]
    jl, tl = both_suffix(1, toks, 32, 8, 48)
    _close(tl, jl, "prefill_paged_suffix")
    first[1] = np.argmax(jl[0])
    assert np.argmax(tl[0]) == first[1]
    # slot 3: chunked prefill through the suffix path
    for c0 in (0, 16):
        n = min(16, len(chunked) - c0)
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = chunked[c0:c0 + n]
        jl, tl = both_suffix(3, toks, c0, n, -(-(c0 + 16) // ps) * ps)
        _close(tl, jl, f"chunk {c0}")
    first[3] = np.argmax(jl[0])
    assert np.argmax(tl[0]) == first[3]

    # the pools hold the same codes (one code apart where a value sits on a
    # quantizer rounding boundary)
    for name in ("k", "v"):
        a, b = np.asarray(getattr(jc, name)), to_np(getattr(tc, name))
        if kv_bits == 4:
            a = np.asarray(jllama.unpack_kv_codes(jnp.asarray(a)))
            b = to_np(tllama.unpack_kv_codes(torch.from_numpy(b)))
        a, b = a.astype(np.int32), b.astype(np.int32)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3
    carried = interop.paged_cache_from_numpy(*(np.asarray(x) for x in
                                               (jc.k, jc.v, jc.k_scale, jc.v_scale)),
                                             device="cpu")
    assert carried.k.dtype == tc.k.dtype and carried.k_scale.shape == tc.k_scale.shape

    # 8 greedy decode steps over a 3-page window; slot 4 stays inactive and
    # slot 3 crosses into its third page
    pos = np.array([5, 40, 40, 30, -1], np.int32)
    j_tok, t_tok = first.copy(), first.copy()
    j_seq, t_seq = [], []
    for step in range(8):
        jl, jc = jllama.decode_step_paged(jp, P_J, jnp.asarray(j_tok), jc, jt,
                                          jnp.asarray(pos), window=48)
        tl, _ = tllama.decode_step_paged(tp, P_T, torch.from_numpy(t_tok).long(), tc, tt,
                                         torch.from_numpy(pos), window=48)
        jl, tl = np.asarray(jl), to_np(tl)
        _close(tl, jl, f"decode_step_paged {step}")
        assert np.all(tl[4] == 0.0)
        j_tok, t_tok = (np.argmax(x, axis=-1).astype(np.int32) for x in (jl, tl))
        j_seq.append(j_tok[:4])
        t_seq.append(t_tok[:4])
        pos = np.where(pos >= 0, pos + 1, pos)
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(j_seq))


def test_decode_step_paged_writes_active_rows_only():
    """In-place writes land at (layer, table[s, pos // ps], pos % ps) for
    active slots; the zero page and inactive slots' pages stay untouched."""
    p = P_T
    params = tllama.fuse_params(tllama.init_params(p, dtype=torch.float32, device="cpu",
                                                   seed=1), p)
    cache = tpkv.PagedKVCache.create(p, 6, 16, quantized=True, kv_bits=4, device="cpu")
    cache.k.fill_(0x5A)
    cache.k_scale.fill_(7.0)
    table = torch.tensor([[3, 5], [2, 0], [4, 1]], dtype=torch.int32)
    pos = torch.tensor([17, -1, 0], dtype=torch.int32)
    tllama.decode_step_paged(params, p, torch.tensor([1, 2, 3]), cache, table, pos)
    written = {(5, 1), (4, 0)}
    for page in range(6):
        for off in range(16):
            untouched = bool(torch.all(cache.k[:, page, off] == 0x5A))
            assert untouched == ((page, off) not in written), (page, off)
    assert torch.all(cache.k_scale[:, 5, :2, 1] != 7.0)
    assert torch.all(cache.k_scale[:, 5, 2:, 1] == 0.0)  # pad8 rows hold zeros
