"""Meshes whose tensor_parallel does not divide n_kv_heads (MQA and narrow
GQA at a wide tp): tpuserve_torch keeps every kv head on every tp rank, as
the JAX package's GSPMD path replicates the cache's head axis over tp
(tpuserve/parallel/sharding.py::shard_cache), and attends by einsum.

- `attention_heads`: the kv groups a rank attends over cover its rows of
  the row-sharded wo, and the columns it keeps tile qd over tp, a wo shard
  of 1.5 heads included;
- the cache and pool blocks: every head on every tp rank, the JAX rule
  (its shard_cache's shards byte for byte);
- whole steps under a live mesh, every rank a thread with its weight and
  cache blocks (`ThreadComm` doing the collectives), at tp 2 over 8/1
  heads, tp 4 over 8/2, tp 2 x dp 2 and tp 2 x sp 2 over 8/1, and tp 8
  over 12/2: decode_step, prefill_chunk and verify_step against the JAX
  functions jitted over the same mesh (GSPMD), logits within 1e-4 (rtol
  and atol), each rank's cache against the JAX cache at its block within
  1e-6 (codes exactly), the tp replicas of a block byte-equal. The JAX
  package fails two of these: its sp decode island (shard_map) cannot cut
  one kv head over tp, so tp 2 x sp 2's decode step is held to JAX over
  the sp mesh without tp (the same merge); and its paged pool cannot be
  placed (shard_paged_cache cuts the 5D pool's heads over tp), so the
  paged forms (decode_step_paged, prefill_paged_suffix, verify_step_paged)
  are held to the JAX functions on one device;
- a MoE decode step at tp 2 over one kv head, experts over tp;
- the engine (spawned gloo ranks on the CPU): greedy tokens at tp 2 over
  one kv head, contiguous and paged with prefix sharing and speculation,
  equal to the port's one-rank engine under TPUSERVE_DECODE_ATTN=xla and
  to the JAX engine (on the same mesh; paged on one device), and the tp
  replicas' caches byte-equal after the wave (the ranks' cache
  checksums); the JAX engine's refusals (int4 KV under such a tp,
  pipeline_parallel with it).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpuserve.models import llama as jllama
from tpuserve.parallel import mesh as jmesh
from tpuserve.parallel import sharding as jshard
from tpuserve.serving.paged_kv import PagedKVCache as JPagedKVCache
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.parallel import sharding as tshard
from tpuserve_torch.serving.paged_kv import PagedKVCache
from test_torch_parallel import fake_mesh, run_ranks
from torch_parity import SMALL, jax_to_torch_params, to_np, write_model

torch.set_num_threads(1)

# name -> (tp, dp, sp, n_heads, n_kv_heads)
MESHES = {
    "tp2-mqa": (2, 1, 1, 8, 1),
    "tp4-gqa2": (4, 1, 1, 8, 2),
    "tp2dp2-mqa": (2, 2, 1, 8, 1),
    "tp2sp2-mqa": (2, 1, 2, 8, 1),
    "tp8-12over2": (8, 1, 1, 12, 2),    # a wo shard of 1.5 heads
}
FNS = ("decode", "chunk", "verify", "decode_paged", "suffix_paged", "verify_paged")
CASES = [(m, f) for m in MESHES for f in FNS
         if not (f.endswith("paged") and MESHES[m][2] > 1)]   # sp refuses paged KV
N_SLOTS, MAX_LEN, HD, PS = 4, 32, 8, 8
POSITIONS = np.array([5, 14, -1, 27], np.int32)      # slot 1 straddles the sp halves
LENGTHS = np.array([4, 4, 0, 2], np.int32)
TOKENS = np.array([[7, 9, 11, 3], [3, 5, 8, 1], [0, 0, 0, 0], [12, 40, 0, 0]], np.int32)
TABLE = np.array([[1, 2, 3, 4], [5, 6, 11, 0], [0, 0, 0, 0], [7, 8, 9, 10]], np.int32)
SUFFIX = dict(slot=3, start=16, length=5, window=32)  # slot 3's third and fourth pages


def _dims(n_heads, n_kv_heads, n_layers=2, **kw):
    return dict(dict(vocab_size=128, dim=32, n_layers=n_layers, n_heads=n_heads,
                     n_kv_heads=n_kv_heads, head_dim=HD, ffn_dim=64), **kw)


_PARAMS = {}


def _params(n_heads, n_kv_heads, **kw):
    """The JAX model (f32, from a seed) and its torch copy, one per shape."""
    key = (n_heads, n_kv_heads, tuple(sorted(kw.items())))
    if key not in _PARAMS:
        jp = jllama.LlamaParams(**_dims(n_heads, n_kv_heads, **kw))
        params = jllama.init_params(jax.random.PRNGKey(1), jp, dtype=jnp.float32)
        _PARAMS[key] = (jp, params, jax_to_torch_params(params),
                        tllama.LlamaParams(**_dims(n_heads, n_kv_heads, **kw)))
    return _PARAMS[key]


def _cache_state(n_kv, rng, n_layers=2):
    """A 5D int8 cache holding context (the JAX engine's layout on such a
    mesh) and its head-major f32 scales."""
    shape = (n_layers, N_SLOTS, MAX_LEN, n_kv, HD)
    sshape = (n_layers, N_SLOTS, n_kv, MAX_LEN)
    return (rng.integers(-127, 128, size=shape).astype(np.int8),
            rng.integers(-127, 128, size=shape).astype(np.int8),
            rng.uniform(0.005, 0.02, size=sshape).astype(np.float32),
            rng.uniform(0.005, 0.02, size=sshape).astype(np.float32))


def _pool_state(n_kv, rng, n_pages=12):
    """A 5D int8 page pool holding context and its pad8 scale pool."""
    shape = (2, n_pages, PS, n_kv, HD)
    k = rng.integers(-127, 128, size=shape).astype(np.int8)
    v = rng.integers(-127, 128, size=shape).astype(np.int8)
    ks = np.zeros((2, n_pages, 8, PS), np.float32)
    vs = np.zeros((2, n_pages, 8, PS), np.float32)
    ks[:, :, :n_kv] = rng.uniform(0.005, 0.02, size=(2, n_pages, n_kv, PS))
    vs[:, :, :n_kv] = rng.uniform(0.005, 0.02, size=(2, n_pages, n_kv, PS))
    return k, v, ks, vs


def _t(state):
    return [None if a is None else torch.from_numpy(a.copy()) for a in state]


def _jax_contiguous(fn, jp, params, state, mesh):
    """The JAX function over `mesh` (GSPMD) on the cache state: (logits,
    (k, v, k_scale, v_scale) as numpy)."""
    k, v, ks, vs = state
    jcache = jshard.shard_cache(jllama.KVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        flat=False), mesh)
    sparams = jshard.shard_llama_params(params, mesh)
    dp_put = (lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp"))))
    jshard.set_active_mesh(mesh)
    try:
        if fn == "decode":
            out, c = jax.jit(lambda pr, t, cc, ps: jllama.decode_step(pr, jp, t, cc, ps))(
                sparams, dp_put(TOKENS[:, 0]), jcache, dp_put(POSITIONS))
        elif fn == "verify":
            out, c = jax.jit(lambda pr, t, cc, ps, ln: jllama.verify_step(pr, jp, t, cc, ps, ln))(
                sparams, dp_put(TOKENS), jcache, dp_put(POSITIONS), dp_put(LENGTHS))
        else:   # chunk: slot 1's positions 8..15 after its context
            out, c = jax.jit(lambda pr, t, cc: jllama.prefill_chunk(
                pr, jp, t, cc, jnp.int32(1), jnp.int32(8), jnp.int32(6), 16))(
                sparams, jnp.asarray(TOKENS[:2].reshape(1, 8)), jcache)
    finally:
        jshard.set_active_mesh(None)
    return np.asarray(out), tuple(np.asarray(a) for a in (c.k, c.v, c.k_scale, c.v_scale))


_PAGED_REFS = {}


def _jax_paged(fn, jp, params, state):
    """The JAX paged function on one device (its pool cannot be placed on
    such a mesh): (logits, the pool as numpy), one per function and shape."""
    key = (fn, jp.n_heads, jp.n_kv_heads)
    if key not in _PAGED_REFS:
        _PAGED_REFS[key] = _jax_paged_run(fn, jp, params, state)
    return _PAGED_REFS[key]


def _jax_paged_run(fn, jp, params, state):
    k, v, ks, vs = (jnp.asarray(a) for a in state)
    pool = JPagedKVCache(k=k, v=v, k_scale=ks, v_scale=vs, flat=False)
    table = jnp.asarray(TABLE)
    if fn == "decode_paged":
        out, c = jax.jit(lambda pr, cc: jllama.decode_step_paged(
            pr, jp, jnp.asarray(TOKENS[:, 0]), cc, table, jnp.asarray(POSITIONS), window=32))(
            params, pool)
    elif fn == "verify_paged":
        out, c = jax.jit(lambda pr, cc: jllama.verify_step_paged(
            pr, jp, jnp.asarray(TOKENS), cc, table, jnp.asarray(POSITIONS),
            jnp.asarray(LENGTHS), window=32))(params, pool)
    else:
        out, c = jax.jit(lambda pr, cc: jllama.prefill_paged_suffix(
            pr, jp, jnp.asarray(TOKENS[:2].reshape(1, 8)), cc, table,
            jnp.int32(SUFFIX["slot"]), jnp.int32(SUFFIX["start"]), jnp.int32(SUFFIX["length"]),
            SUFFIX["window"]))(params, pool)
    return np.asarray(out), tuple(np.asarray(a) for a in (c.k, c.v, c.k_scale, c.v_scale))


def _torch_step(fn, local, p, cache):
    if fn == "decode":
        return tllama.decode_step(local, p, torch.from_numpy(TOKENS[:, 0]).long(), cache,
                                  torch.from_numpy(POSITIONS))[0]
    if fn == "verify":
        return tllama.verify_step(local, p, torch.from_numpy(TOKENS).long(), cache,
                                  torch.from_numpy(POSITIONS), torch.from_numpy(LENGTHS))[0]
    if fn == "chunk":
        return tllama.prefill_chunk(local, p, torch.from_numpy(TOKENS[:2].reshape(1, 8)).long(),
                                    cache, 1, 8, 6, 16)[0]
    table = torch.from_numpy(TABLE)
    if fn == "decode_paged":
        return tllama.decode_step_paged(local, p, torch.from_numpy(TOKENS[:, 0]).long(), cache,
                                        table, torch.from_numpy(POSITIONS), window=32)[0]
    if fn == "verify_paged":
        return tllama.verify_step_paged(local, p, torch.from_numpy(TOKENS).long(), cache, table,
                                        torch.from_numpy(POSITIONS), torch.from_numpy(LENGTHS),
                                        window=32)[0]
    return tllama.prefill_paged_suffix(local, p, torch.from_numpy(TOKENS[:2].reshape(1, 8)).long(),
                                       cache, table, **SUFFIX)[0]


def _contiguous_block(arrays, coords, dp, sp):
    """A rank's block of the whole cache (k, v [n_layers, S, L, Hkv, hd],
    scales [n_layers, S, Hkv, L]): its dp slots and sp window, every head."""
    s, l = N_SLOTS // dp, MAX_LEN // sp
    s0, l0 = coords["dp"] * s, coords["sp"] * l
    k, v, ks, vs = arrays
    return (k[:, s0:s0 + s, l0:l0 + l], v[:, s0:s0 + s, l0:l0 + l],
            ks[:, s0:s0 + s, :, l0:l0 + l], vs[:, s0:s0 + s, :, l0:l0 + l])


# ---------------------------------------------------------------- rank layout
@pytest.mark.parametrize("name", list(MESHES))
def test_attention_heads_cover_wo_rows(name):
    """Each tp rank's kv groups hold the query heads of its qd/tp rows of
    wo, the columns it keeps are those rows, and the ranks' rows tile qd;
    the rank's K/V and cache hold every kv head (`llama._rank_heads`)."""
    tp, dp, sp, h, hkv = MESHES[name]
    p = tllama.LlamaParams(**_dims(h, hkv))
    qd, rep = h * HD, h // hkv
    rows = []
    for r in range(tp * dp * sp):
        m = fake_mesh(tp, dp, sp, r)
        assert tshard.kv_replicated(p, m)
        kv, cols = tshard.attention_heads(p, m)
        pl, pa, hs, kv_mesh = tllama._rank_heads(p, m)
        assert (pa.n_kv_heads, pa.n_heads) == (kv.stop - kv.start, (kv.stop - kv.start) * rep)
        assert pl == p and hs == kv and kv_mesh is None
        lo = kv.start * rep * HD + cols.start
        assert cols.stop - cols.start == qd // tp and cols.stop <= pa.n_heads * HD
        assert lo == m.coords["tp"] * qd // tp
        rows.append((lo, lo + qd // tp))
    assert sorted(set(rows)) == [(t * qd // tp, (t + 1) * qd // tp) for t in range(tp)]
    assert tshard.attention_heads(p, fake_mesh(1, dp, sp)) is None


@pytest.mark.parametrize("name", ["tp2-mqa", "tp4-gqa2", "tp2sp2-mqa"])
def test_cache_blocks_match_jax(name):
    """shard_cache keeps every head on every tp rank of a 5D cache whose
    Hkv tp does not divide, as the JAX shard_cache (its shards byte for
    byte: slots over dp, L over sp); the 5D pool (JAX cannot place it:
    its shard_paged_cache cuts the heads) stays whole on every rank, and
    paged_cache_block makes it so."""
    tp, dp, sp, h, hkv = MESHES[name]
    state = _cache_state(hkv, np.random.default_rng(0))
    mesh = jmesh.make_mesh(tp=tp, dp=dp, sp=sp)
    jc = jshard.shard_cache(jllama.KVCache(*(jnp.asarray(a) for a in state), flat=False), mesh)
    full = tllama.KVCache(*_t(state))
    for r in range(tp * dp * sp):
        m = fake_mesh(tp, dp, sp, r)
        blk = tshard.shard_cache(full, m)
        for got, arr in zip((blk.k, blk.v, blk.k_scale, blk.v_scale), (jc.k, jc.v, jc.k_scale,
                                                                        jc.v_scale)):
            shard = next(s for s in arr.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(to_np(got), np.asarray(shard.data))
        if sp == 1:
            pool = PagedKVCache(*_t(_pool_state(hkv, np.random.default_rng(1))))
            pblk = tshard.shard_paged_cache(pool, m)
            assert all(torch.equal(a, b) for a, b in zip(
                (pblk.k, pblk.v, pblk.k_scale, pblk.v_scale),
                (pool.k, pool.v, pool.k_scale, pool.v_scale)))
            made = tshard.paged_cache_block(tllama.LlamaParams(**_dims(h, hkv)), m, 12, PS, True,
                                            device="cpu")
            assert made.k.shape == pool.k.shape and made.k_scale.shape == pool.k_scale.shape


# ---------------------------------------------------------------- whole steps
@pytest.mark.parametrize("name,fn", CASES, ids=[f"{m}-{f}" for m, f in CASES])
def test_steps_match_jax(name, fn):
    """One step under a live mesh whose tp does not divide n_kv_heads,
    every rank a thread with its blocks, against the JAX function (see the
    module docstring for where the JAX mesh could not run it): logits
    within 1e-4; each rank's cache or pool within 1e-6 of the JAX one's at
    its block (codes exactly; a pool, replicated over dp, at the pages its
    dp group's slots own), every tp replica of a block byte-equal."""
    tp, dp, sp, h, hkv = MESHES[name]
    jp, params, tparams, p = _params(h, hkv)
    paged = fn.endswith("paged")
    state = (_pool_state if paged else _cache_state)(hkv, np.random.default_rng(3))
    if paged:
        ref, jstate = _jax_paged(fn, jp, params, state)
    else:
        # JAX's sp decode island cannot cut one kv head over tp: the same
        # merge over the sp mesh without tp
        jm = jmesh.make_mesh(tp=1 if (fn == "decode" and sp > 1) else tp, dp=dp, sp=sp)
        ref, jstate = _jax_contiguous(fn, jp, params, state, jm)

    def body(m):
        local = tshard.shard_llama_params(tparams, m)
        if paged:
            cache = tshard.shard_paged_cache(PagedKVCache(*_t(state)), m)
        else:
            cache = tshard.shard_cache(tllama.KVCache(*_t(state)), m)
        return m.coords, to_np(_torch_step(fn, local, p, cache)), cache

    blocks = {}
    for coords, out, cache in run_ranks(tp, dp, sp, body):
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        got = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        if paged:   # a pool replicated over dp: the pages its dp group's slots own
            own = [i for i in range(N_SLOTS) if i * dp // N_SLOTS == coords["dp"]]
            pages = sorted({int(t) for i in own for t in TABLE[i]})
            got, want = [t[:, pages] for t in got], [a[:, pages] for a in jstate]
        else:
            want = _contiguous_block(jstate, coords, dp, sp)
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), w.astype(np.float32), rtol=0, atol=1e-6)
        first = blocks.setdefault((coords["dp"], coords["sp"]), got)
        assert all(torch.equal(a, b) for a, b in zip(first, got)), coords


def test_moe_decode_step_matches_jax():
    """A MoE model (4 experts, top-2) over one kv head at tp 2: the
    experts over tp (the rank's two, one psum), the attention on every kv
    head; the decode step's logits within 1e-4 of the JAX one jitted over
    the same mesh, both ranks' caches byte-equal and at the JAX cache."""
    jp, params, tparams, p = _params(8, 1, n_experts=4, n_experts_per_tok=2)
    state = _cache_state(1, np.random.default_rng(4))
    ref, jstate = _jax_contiguous("decode", jp, params, state, jmesh.make_mesh(tp=2))

    def body(m):
        cache = tshard.shard_cache(tllama.KVCache(*_t(state)), m)
        out = _torch_step("decode", tshard.shard_llama_params(tparams, m), p, cache)
        return to_np(out), cache

    (out0, c0), (out1, c1) = run_ranks(2, 1, 1, body)
    for out in (out0, out1):
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    for a, b, w in zip((c0.k, c0.v, c0.k_scale, c0.v_scale), (c1.k, c1.v, c1.k_scale,
                                                             c1.v_scale), jstate):
        assert torch.equal(a, b)
        np.testing.assert_allclose(to_np(a), w.astype(np.float32), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- the engine
def _engine_config(name, sharding, **gen):
    """SMALL over one kv head (4 query heads of 128), int4 g128 weights and
    int8 KV (the JAX package refuses int4 KV on such a mesh)."""
    generation = dict(max_seq_len=32, max_slots=4, eos_token_id=-1, max_new_tokens=8,
                      prefill_chunk=0, decode_horizon=2)
    generation.update(gen)
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL, n_kv_heads=1),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int8"},
            "generation": generation, "sharding": sharding}


STEM = [5, 17, 100, 42, 7]
ENGINES = {
    "contiguous": {},
    # 16-token pages, a shared first page, drafts from the prompts
    "paged-spec": dict(paged=True, page_size=16, prefix_sharing=True, speculation_tokens=3,
                       speculation_min_gain=0),
}


def _serve(engine, prompts, n=8):
    reqs = [engine.submit(q, max_new_tokens=n) for q in prompts]
    out = []
    for r in reqs:
        assert r.done.wait(timeout=180), "a request did not finish"
        assert r.error is None, r.error
        out.append(list(r.output_ids))
    return out


@pytest.fixture()
def jax_quantize_jitted(monkeypatch):
    """The JAX engine quantizes its weights jitted: one compile for the tree
    instead of one a primitive (5.1 -> 0.7 s a load here). The int4 codes
    are the eager quantizer's; a scale may move one f32 ulp."""
    import tpuserve.serving.engine as jengine

    eager = jengine.quantize_param_tree
    monkeypatch.setattr(jengine, "quantize_param_tree",
                        lambda raw, **kw: jax.jit(lambda tree: eager(tree, **kw))(raw))


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_one_rank_and_jax(tmp_path, monkeypatch, jax_quantize_jitted, case):
    """The engine at tensor_parallel 2 over one kv head (spawned gloo ranks
    on the CPU) serves the port's one-rank engine's greedy tokens under
    TPUSERVE_DECODE_ATTN=xla (the einsum arithmetic a replicated head
    takes) and the JAX engine's: on the same mesh contiguous; on one
    device paged (its pool cannot be placed on the mesh). Speculation
    drafted and accepted on the paged engine, with a prefix hit. After
    the wave the two tp ranks' caches are byte-equal (their checksums)."""
    from tpuserve.repository.config import ModelConfig as JModelConfig
    from tpuserve.serving.engine import GenerationEngine as JEngine
    from tpuserve_torch.repository.config import ModelConfig
    from tpuserve_torch.serving.engine import GenerationEngine

    monkeypatch.setenv("TPUSERVE_DIST_TIMEOUT", "60")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for key in ("TPUSERVE_COORDINATOR", "TPUSERVE_NUM_PROCESSES", "TPUSERVE_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    gen = ENGINES[case]
    cfg = _engine_config(case, {"tensor_parallel": 2}, **gen)
    vdir = write_model(str(tmp_path), case, cfg)
    shared = list(range(30, 46))                      # one whole page
    monkeypatch.setenv("TPUSERVE_DECODE_ATTN", "xla")
    one = GenerationEngine(vdir, ModelConfig.from_dict(dict(cfg, sharding={})), device="cpu")
    one.start()
    try:
        # the head walks a fixed token chain: a prompt holding it drafts it
        (chain,) = _serve(one, [STEM])
        prompts = [STEM + chain + STEM, shared + [3, 1], shared + [9], [3, 1, 4, 1, 5, 9]] \
            if gen.get("paged") else [STEM + chain[:3], [3, 1, 4, 1, 5, 9], list(range(30, 40))]
        ref = _serve(one, prompts[:1]) + _serve(one, prompts[1:])
    finally:
        one.stop()
    monkeypatch.delenv("TPUSERVE_DECODE_ATTN")
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        got = _serve(eng, prompts[:1]) + _serve(eng, prompts[1:])
        stats, ranks = eng.serving_stats(), eng.rank_stats(cache=True)
    finally:
        eng.stop()
    assert got == ref
    assert ranks[0]["cache_fingerprint"] == ranks[1]["cache_fingerprint"]
    assert ranks[0]["cache_bytes"] == ranks[1]["cache_bytes"]
    if gen.get("paged"):
        assert stats["prefix_hits"] > 0
        assert stats["spec_drafted"] > 0 and stats["spec_accepted"] > 0
    jcfg = dict(cfg, name="j" + case, sharding={} if gen.get("paged") else cfg["sharding"])
    jeng = JEngine(vdir, JModelConfig.from_dict(jcfg))
    jeng.start()
    try:
        jref = _serve(jeng, prompts[:1]) + _serve(jeng, prompts[1:])
    finally:
        jeng.stop()
    assert got == jref


@pytest.mark.parametrize("sharding,kv,msg", [
    ({"tensor_parallel": 2}, "int4", "kv_cache int4 under tp needs tp \\| n_kv_heads"),
    ({"tensor_parallel": 2, "pipeline_parallel": 2}, "int8",
     "n_heads/n_kv_heads/ffn_dim must divide by tensor_parallel 2 under pipeline_parallel"),
], ids=["int4_kv", "pipeline"])
def test_jax_refusals_kept(tmp_path, sharding, kv, msg):
    """What the JAX engine refuses on such a mesh stays refused with its
    words, before any rank starts: int4 KV (one kv head of 256 at tp 2,
    which the port's old check let through) and pipeline_parallel."""
    from tpuserve_torch.repository.config import ModelConfig
    from tpuserve_torch.serving.engine import GenerationEngine
    from tpuserve_torch.utils.errors import BackendError

    cfg = _engine_config("refused", sharding, prefill_chunk=0)
    cfg["model_params"] = dict(cfg["model_params"], n_heads=8, head_dim=256)
    cfg["quantization"]["kv_cache"] = kv
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match=msg):
        eng.start()
    assert eng._followers == [] and not torch.distributed.is_initialized()
