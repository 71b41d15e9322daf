"""Speculative decoding across ranks (tpuserve_torch's verify_step and
verify_step_paged under a live tp/dp/sp mesh, the sharded speculative
engine) against the JAX package on the conftest's 8-device CPU mesh.

- `verify_step` under (tp, dp, sp) meshes, int8 KV and bf16 and f32
  caches, every rank a thread of this process with its weight and cache
  blocks (`ThreadComm` doing the collectives), against the JAX verify_step
  jitted over the same mesh (GSPMD einsums): logits of every slot and
  candidate within 1e-4 (rtol and atol), the tolerance of
  tests/test_torch_parallel.py::test_decode_step_sharded_matches_jax, under
  sp too (the verify's softmax split over sp as GSPMD splits it); each
  rank's cache block against the JAX cache's shard;
- `verify_step_paged` under tp 2 and dp 2 against the JAX paged verify
  under the same mesh, within 1e-4;
- the helpers the two bodies share (the rank's inputs, the rows it writes,
  the verify's softmax over sp against one softmax, the ranks' agreement);
- a verify that fails on one rank raises on every rank, under a time
  limit of its own;
- the sharded speculative engine (spawned gloo ranks on the CPU): greedy
  tokens equal to the one-rank speculative engine's and the JAX engine's
  on the same config, contiguous, paged and MoE (a port of
  tests/test_speculative.py::test_spec_with_tp_dp_sharding).
"""

import os
import threading

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
from tpuserve_torch import interop
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.parallel import sharding as tshard
from test_torch_parallel import fake_mesh, jax_block, run_ranks
from torch_parity import SMALL, jax_to_torch_params, to_np, write_model

STEM = [5, 17, 100, 42, 7]

torch.set_num_threads(1)

P_TINY = dict(vocab_size=128, dim=32, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=8,
              ffn_dim=64)
N_SLOTS, MAX_LEN, C = 4, 32, 4
# slot 1's candidates straddle the sp halves [0, 16) and [16, 32); slot 2 is
# inactive; slot 3 drafts less than C - 1
POSITIONS = np.array([5, 14, -1, 27], np.int32)
LENGTHS = np.array([4, 4, 0, 2], np.int32)
TOKENS = np.array([[7, 9, 11, 3], [3, 5, 8, 1], [0, 0, 0, 0], [12, 40, 0, 0]], np.int32)


def _cache_state(kind, rng):
    """A cache holding context: int8 codes with f32 scales, or bf16 values."""
    shape = (P_TINY["n_layers"], N_SLOTS, MAX_LEN, P_TINY["n_kv_heads"], P_TINY["head_dim"])
    sshape = (P_TINY["n_layers"], N_SLOTS, P_TINY["n_kv_heads"], MAX_LEN)
    if kind == "int8":
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, size=sshape).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, size=sshape).astype(np.float32)
        return k, v, ks, vs
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return k, v, None, None


@pytest.mark.parametrize("tp,dp,sp,kind", [
    (2, 1, 1, "int8"), (1, 2, 1, "int8"), (2, 2, 1, "int8"), (1, 1, 2, "int8"),
    (1, 2, 2, "int8"), (2, 2, 1, "bf16"), (1, 2, 2, "bf16"), (1, 2, 2, "f32")])
def test_verify_step_sharded_matches_jax(tp, dp, sp, kind):
    """A whole verify_step under a live mesh, every rank a thread with its
    blocks, against the JAX package's verify_step jitted over the same mesh
    (GSPMD: its einsum attention, as a mesh forces there): logits [S, C, V]
    within 1e-4, under sp too: its softmax takes the global max and sum
    before it normalizes, so the bf16 probabilities round as the JAX
    softmax's do (the decode step's flash-decoding merge, which rounds
    unnormalized ones and pre-scales q, missed this by up to 1.1e-3 here);
    each rank's cache block after the step equal to the JAX cache's shard
    within 1e-6 (codes exactly)."""
    jp = jllama.LlamaParams(**P_TINY)
    params = jllama.init_params(jax.random.PRNGKey(1), jp, dtype=jnp.float32)
    k0, v0, ks0, vs0 = _cache_state(kind, np.random.default_rng(3))
    flat = sp == 1
    fl = (lambda a: a.reshape(a.shape[:3] + (-1,))) if flat else (lambda a: a)
    jdt = {"int8": jnp.int8, "bf16": jnp.bfloat16, "f32": jnp.float32}[kind]
    mesh = jmesh.make_mesh(tp=tp, dp=dp, sp=sp)
    jcache = jshard.shard_cache(jllama.KVCache(
        k=jnp.asarray(fl(k0), jdt), v=jnp.asarray(fl(v0), jdt),
        k_scale=None if ks0 is None else jnp.asarray(ks0),
        v_scale=None if vs0 is None else jnp.asarray(vs0), flat=flat), mesh)
    sparams = jshard.shard_llama_params(params, mesh)
    dp_spec = NamedSharding(mesh, P("dp"))
    jshard.set_active_mesh(mesh)
    try:
        ref, jcache = jax.jit(lambda pr, t, c, ps, ln: jllama.verify_step(pr, jp, t, c, ps, ln))(
            sparams, jax.device_put(jnp.asarray(TOKENS), dp_spec), jcache,
            jax.device_put(jnp.asarray(POSITIONS), dp_spec),
            jax.device_put(jnp.asarray(LENGTHS), dp_spec))
    finally:
        jshard.set_active_mesh(None)
    ref = np.asarray(ref)
    tparams = jax_to_torch_params(params)
    p = tllama.LlamaParams(**P_TINY)
    tdt = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}[kind]
    full = interop.kv_cache_from_numpy(fl(k0), fl(v0), ks0, vs0, device="cpu")
    full.k, full.v = full.k.to(tdt), full.v.to(tdt)

    def step(m):
        local = tshard.shard_llama_params(tparams, m)
        cache = tshard.shard_cache(full, m)
        logits, _ = tllama.verify_step(local, p, torch.from_numpy(TOKENS).long(), cache,
                                       torch.from_numpy(POSITIONS), torch.from_numpy(LENGTHS))
        return m.rank, to_np(logits), cache

    for rank, out, cache in run_ranks(tp, dp, sp, step):
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        for got, want in ((cache.k, jcache.k), (cache.v, jcache.v),
                          (cache.k_scale, jcache.k_scale), (cache.v_scale, jcache.v_scale)):
            if got is None:
                continue
            got, want = to_np(got), jax_block(want, rank).astype(np.float32)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _pools(rng, n_layers=2, n_pages=12, ps=8, n_kv=4, hd=8):
    w = n_kv * hd
    kp = rng.integers(-127, 128, size=(n_layers, n_pages, ps, w)).astype(np.int8)
    vp = rng.integers(-127, 128, size=(n_layers, n_pages, ps, w)).astype(np.int8)
    ks = np.zeros((n_layers, n_pages, 8, ps), np.float32)
    vs = np.zeros((n_layers, n_pages, 8, ps), np.float32)
    ks[:, :, :n_kv] = rng.uniform(0.005, 0.02, size=(n_layers, n_pages, n_kv, ps))
    vs[:, :, :n_kv] = rng.uniform(0.005, 0.02, size=(n_layers, n_pages, n_kv, ps))
    return kp, vp, ks, vs


@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2)])
def test_verify_step_paged_sharded_matches_jax(tp, dp):
    """verify_step_paged under a live tp/dp mesh (the rank's slots' rows,
    its kv heads of the pool; the scale pool replicated and its rows
    gathered over tp) against the JAX paged verify under the same mesh:
    logits within 1e-4; each rank's pool equal to the JAX pool (within
    1e-6) on the rows its dp group wrote and on the context it was given."""
    jp = jllama.LlamaParams(**P_TINY)
    params = jllama.init_params(jax.random.PRNGKey(1), jp, dtype=jnp.float32)
    kp, vp, ks, vs = _pools(np.random.default_rng(5))
    ps = 8
    table = np.zeros((N_SLOTS, 4), np.int32)
    table[0, :2] = [1, 2]
    table[1, :3] = [3, 4, 5]
    table[3, :4] = [6, 7, 8, 9]
    mesh = jmesh.make_mesh(tp=tp, dp=dp)
    jcache = jshard.shard_paged_cache(JPagedKVCache(
        k=jnp.asarray(kp), v=jnp.asarray(vp), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        flat=True), mesh)
    sparams = jshard.shard_llama_params(params, mesh)
    jshard.set_active_mesh(mesh)
    try:
        ref, jcache = jax.jit(lambda pr, t, c, tb, pos, ln: jllama.verify_step_paged(
            pr, jp, t, c, tb, pos, ln, window=32))(
            sparams, jnp.asarray(TOKENS), jcache, jnp.asarray(table), jnp.asarray(POSITIONS),
            jnp.asarray(LENGTHS))
    finally:
        jshard.set_active_mesh(None)
    ref = np.asarray(ref)
    tparams = jax_to_torch_params(params)
    p = tllama.LlamaParams(**P_TINY)
    full = interop.paged_cache_from_numpy(kp, vp, ks, vs, device="cpu")

    def body(m):
        local = tshard.shard_llama_params(tparams, m)
        cache = tshard.shard_paged_cache(full, m)
        logits, _ = tllama.verify_step_paged(
            local, p, torch.from_numpy(TOKENS).long(), cache, torch.from_numpy(table),
            torch.from_numpy(POSITIONS), torch.from_numpy(LENGTHS), window=32)
        return m.coords, to_np(logits), cache

    jscale = (np.asarray(jcache.k_scale), np.asarray(jcache.v_scale))
    for coords, out, cache in run_ranks(tp, dp, 1, body):
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        # the pages this rank's dp slots own, and the context no slot wrote
        own = [i for i in range(N_SLOTS) if i * dp // N_SLOTS == coords["dp"]]
        pages = sorted({int(t) for i in own for t in table[i] if t} | {10, 11})
        w = P_TINY["n_kv_heads"] * P_TINY["head_dim"] // tp
        for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
            blk = np.asarray(want)[..., coords["tp"] * w:(coords["tp"] + 1) * w]
            np.testing.assert_array_equal(to_np(got)[:, pages], blk[:, pages])
        for got, want in zip((cache.k_scale, cache.v_scale), jscale):
            np.testing.assert_allclose(to_np(got)[:, pages], want[:, pages], rtol=0, atol=1e-6)


# ---------------------------------------------------------------- shared helpers
@pytest.mark.parametrize("tp,dp,sp", [(2, 2, 1), (1, 2, 2), (1, 1, 2)])
def test_local_verify_inputs_and_rows(tp, dp, sp):
    """The rank's dp slots' rows of the verify's inputs, and the rows it
    writes: the valid ones of its slots whose position lies in its L
    window, with their position in the window; every valid row is written
    by exactly one rank of each tp index."""
    toks, pos, lens = (torch.from_numpy(a) for a in (TOKENS, POSITIONS, LENGTHS))
    table = torch.arange(N_SLOTS * 4).reshape(N_SLOTS, 4)
    valid_all = (pos[:, None] >= 0) & (torch.arange(C)[None, :] < lens[:, None])
    pos_c_all = pos.clamp_min(0)[:, None].long() + torch.arange(C)[None, :]
    seen = {}
    l_loc = MAX_LEN // sp
    for r in range(tp * dp * sp):
        m = fake_mesh(tp, dp, sp, r)
        t, ps_, ln, tb = tshard.local_verify_inputs(m, toks, pos, lens, table)
        lo, hi = tshard.local_slots(m, N_SLOTS)
        assert torch.equal(t, toks[lo:hi]) and torch.equal(tb, table[lo:hi])
        assert torch.equal(ps_, pos[lo:hi]) and torch.equal(ln, lens[lo:hi])
        l_off = m.coords["sp"] * l_loc
        si, ci, lp = tshard.verify_write_rows(valid_all[lo:hi], pos_c_all[lo:hi], l_off,
                                              l_loc if sp > 1 else None)
        for a, b, c_ in zip(si.tolist(), ci.tolist(), lp.tolist()):
            g = int(pos_c_all[lo + a, b])
            assert l_off <= g < l_off + l_loc and c_ == g - l_off
            key = (m.coords["tp"], lo + a, b)
            assert key not in seen
            seen[key] = r
    want = {(t, int(i), int(j)) for t in range(tp) for i, j in torch.nonzero(valid_all).tolist()}
    assert set(seen) == want


def test_per_candidate_sp_partials_merge_to_softmax():
    """seq_partial on a chunk's rows (qpos = each row's own position,
    straddling the two halves; a prefill chunk under sp) merged over sp 2
    by hand equals one softmax over the whole window, per row, within
    1e-5."""
    rng = np.random.default_rng(9)
    s, c, h, hkv, hd, l = 2, 4, 4, 2, 8, 32
    q = torch.from_numpy(rng.normal(size=(s, c, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(s, l, hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(s, l, hkv, hd)).astype(np.float32))
    qpos = torch.tensor([[13, 14, 15, 16], [3, 4, 5, 6]])
    parts = [tshard.seq_partial(q, k[:, i * 16:(i + 1) * 16], v[:, i * 16:(i + 1) * 16], None,
                                None, qpos, i * 16) for i in range(2)]
    m_g = torch.maximum(parts[0][1], parts[1][1])
    o = sum(o_ * torch.exp(m_ - m_g)[..., None] for o_, m_, _ in parts)
    mass = sum(ma * torch.exp(m_ - m_g) for _, m_, ma in parts)
    got = tshard.seq_finish(o, mass, qpos)
    qg = q.reshape(s, c, hkv, h // hkv, hd)
    scores = torch.einsum("schrd,slhd->schrl", qg, k)
    mask = torch.arange(l)[None, None, :] <= qpos[:, :, None]
    probs = torch.softmax(torch.where(mask[:, :, None, None, :], scores, -1e30), dim=-1)
    want = torch.einsum("schrl,slhd->schrd", probs, v).reshape(s, c, h, hd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
def test_verify_softmax_over_sp_matches_one_softmax(kind):
    """attend_seq_softmax over sp 2 (ranks as threads) on a verify's rows,
    whose positions straddle the two halves, against the one-rank verify's
    attention over the whole window (`_attend_window`: bf16 dots for int8
    and bf16 caches, scores scaled after the dot, one softmax): within
    1e-5 (f32 sums in another order), rounding included."""
    rng = np.random.default_rng(11)
    s, c, h, hkv, hd, l = 2, 4, 4, 2, 8, 32
    q = torch.from_numpy(rng.normal(size=(s, c, h, hd)).astype(np.float32))
    if kind == "int8":
        k = torch.from_numpy(rng.integers(-127, 128, size=(s, l, hkv, hd)).astype(np.int8))
        v = torch.from_numpy(rng.integers(-127, 128, size=(s, l, hkv, hd)).astype(np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, size=(s, hkv, l)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, size=(s, hkv, l)).astype(np.float32))
    else:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        k = torch.from_numpy(rng.normal(size=(s, l, hkv, hd)).astype(np.float32)).to(dt)
        v = torch.from_numpy(rng.normal(size=(s, l, hkv, hd)).astype(np.float32)).to(dt)
        ks = vs = None
    qpos = torch.tensor([[13, 14, 15, 16], [3, 4, 5, 6]])
    p = tllama.LlamaParams(**dict(P_TINY, n_heads=h, n_kv_heads=hkv, head_dim=hd))
    mask = torch.arange(l)[None, None, :] <= qpos[:, :, None]
    want = tllama._attend_window(q, k.reshape(s, l, -1), v.reshape(s, l, -1), ks, vs, mask, p)

    def rank(m):
        lo = m.coords["sp"] * (l // 2)
        cut = slice(lo, lo + l // 2)
        return tshard.attend_seq_softmax(q, k[:, cut], v[:, cut],
                                         None if ks is None else ks[..., cut],
                                         None if vs is None else vs[..., cut], qpos, m,
                                         float(np.sqrt(hd)))

    for got in run_ranks(1, 1, 2, rank):
        np.testing.assert_allclose(got.reshape(s, c, -1).numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------- failures
def _agree_on_ranks(tp, dp, sp, prep_fail=(), body_fail=(), limit=60):
    """run_agreed on every rank of a mesh (threads); returns each rank's
    outcome ("ok" or the exception), within `limit` seconds or fails."""
    done = threading.Event()
    box = {}

    def call(m):
        def prep():
            if m.rank in prep_fail:
                raise RuntimeError("prep failed here")
            return m.rank

        def body(st):
            if m.rank in body_fail:
                raise RuntimeError("body failed here")
            return m.psum(torch.ones(1), "tp")

        try:
            tshard.run_agreed(m, "cpu", prep, body)
            return "ok"
        except tshard.VerifyFailed as e:
            return e

    def runner():
        box["out"] = run_ranks(tp, dp, sp, call)
        done.set()

    th = threading.Thread(target=runner, daemon=True)
    th.start()
    assert done.wait(limit), "a rank was left waiting"
    return box["out"]


@pytest.mark.parametrize("where", ["prepare", "run"])
def test_failed_verify_raises_on_every_rank(where):
    """A verify that fails to prepare on one rank (a follower) raises
    VerifyFailed on every rank, before any collective of the step; one that
    fails in the step on every rank raises on every rank too; none waits
    past the test's own 60 s limit."""
    if where == "prepare":
        outs = _agree_on_ranks(2, 2, 1, prep_fail=(3,))
    else:
        outs = _agree_on_ranks(2, 1, 2, body_fail=(0, 1, 2, 3))
    assert all(isinstance(o, tshard.VerifyFailed) for o in outs), outs
    assert all(where in str(o) for o in outs)
    assert "failed here" in str(outs[3 if where == "prepare" else 0])
    assert _agree_on_ranks(2, 2, 1) == ["ok"] * 4


# ---------------------------------------------------------------- the engine
def _expected_rows(log, n_slots, max_len, dp, sp):
    """Rows each (dp, sp) block should have taken over the verifies in
    `log`: each slot's lens[i] candidates at positions[i] + j, in the dp
    group owning the slot and the sp window holding the position."""
    want = {}
    for positions, lens in log:
        for i, (pos, n) in enumerate(zip(positions, lens)):
            for j in range(int(n) if pos >= 0 else 0):
                key = (i * dp // n_slots, (int(pos) + j) * sp // max_len)
                want[key] = want.get(key, 0) + 1
    return want


def _engine_config(name, sharding, **gen):
    generation = dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=12,
                      prefill_chunk=16, decode_horizon=2, speculation_tokens=3,
                      speculation_rounds=4, speculation_min_gain=0)
    generation.update(gen)
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL, n_kv_heads=4),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int8"},
            "generation": generation, "sharding": sharding}


def _moe_config(name, sharding, **gen):
    from test_torch_moe import TINY

    cfg = _engine_config(name, sharding, **gen)
    cfg.update(architecture="mixtral", model_params=dict(TINY, n_experts=4))
    cfg["quantization"]["group_size"] = 32
    return cfg


def _serve_tokens(engine, prompts, n=12):
    reqs = [engine.submit(p, max_new_tokens=n) for p in prompts]
    out = []
    for r in reqs:
        assert r.done.wait(timeout=180), "a request did not finish"
        assert r.error is None, r.error
        out.append(list(r.output_ids))
    return out


SPEC_MESHES = {
    "contiguous-dp2tp2": ({"tensor_parallel": 2, "data_parallel": 2}, {}),
    "paged-tp2": ({"tensor_parallel": 2}, {"paged": True, "page_size": 16,
                                           "prefix_sharing": True}),
    "moe-tp2": ({"tensor_parallel": 2}, {}),
}


@pytest.mark.parametrize("case", list(SPEC_MESHES))
def test_sharded_spec_engine_matches_one_rank_and_jax(tmp_path, monkeypatch, case):
    """The port of tests/test_speculative.py::test_spec_with_tp_dp_sharding:
    the engine with speculation on at each mesh (spawned gloo ranks on the
    CPU) serves the one-rank speculative engine's greedy tokens and the JAX
    engine's on the same config and checkpoint (its mesh on the conftest's
    devices); drafts were made and accepted, every rank ran the same
    number of verifies, and each wrote the candidate rows of its own slots
    and no others."""
    from test_torch_moe import P_J, moe_weights
    from tpuserve.repository.config import ModelConfig as JModelConfig
    from tpuserve.serving.engine import GenerationEngine as JEngine
    from tpuserve_torch.repository.config import ModelConfig
    from tpuserve_torch.serving.engine import GenerationEngine

    monkeypatch.setenv("TPUSERVE_DIST_TIMEOUT", "60")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for key in ("TPUSERVE_COORDINATOR", "TPUSERVE_NUM_PROCESSES", "TPUSERVE_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    sharding, gen = SPEC_MESHES[case]
    moe = case.startswith("moe")
    cfg = (_moe_config if moe else _engine_config)(case, sharding, **gen)
    if moe:
        import dataclasses
        import json
        from safetensors.numpy import save_file

        vdir = os.path.join(str(tmp_path), case, "1")
        os.makedirs(vdir)
        with open(os.path.join(vdir, "config.json"), "w") as fh:
            json.dump(cfg, fh)
        save_file(moe_weights(dataclasses.replace(P_J, n_experts=4)),
                  os.path.join(vdir, "model.safetensors"))
    else:
        vdir = write_model(str(tmp_path), case, cfg)
    one = GenerationEngine(vdir, ModelConfig.from_dict(dict(cfg, sharding={})), device="cpu")
    one.start()
    try:
        # the head walks a fixed token chain: a prompt holding it drafts it
        (chain,) = _serve_tokens(one, [STEM])
        prompts = [STEM + chain + STEM, [3, 1, 4, 1, 5, 9, 2, 6], [9, 9, 8, 8, 7, 7] * 3]
        ref = _serve_tokens(one, prompts)
    finally:
        one.stop()
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        before = eng.rank_stats()
        got = _serve_tokens(eng, prompts)
        after = eng.rank_stats()
        stats = eng.serving_stats()
        log, mesh = list(eng.verify_log), dict(eng.mesh.shape)
    finally:
        eng.stop()
    assert got == ref
    assert stats["spec_drafted"] > 0 and stats["spec_accepted"] > 0
    calls = [a["verify_calls"] - b["verify_calls"] for a, b in zip(after, before)]
    assert calls[0] > 0 and len(set(calls)) == 1 and len(log) == calls[0], calls
    assert not any(a["spec_disabled"] for a in after)
    want = _expected_rows(log, cfg["generation"]["max_slots"], cfg["generation"]["max_seq_len"],
                          mesh["dp"], mesh["sp"])
    for a, b in zip(after, before):
        key = (a["coords"]["dp"], a["coords"]["sp"])
        assert a["verify_rows_written"] - b["verify_rows_written"] == want.get(key, 0), key
    cfg_j = dict(cfg, name="j" + case)
    jeng = JEngine(vdir, JModelConfig.from_dict(cfg_j))
    jeng.start()
    try:
        jref = _serve_tokens(jeng, prompts)
    finally:
        jeng.stop()
    assert got == jref
