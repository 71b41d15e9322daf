"""Paged KV under a tp/dp mesh (tpuserve_torch.parallel.sharding's paged
pool rules and the paged core per shard, llama's paged entry points under a
live mesh) against the JAX package on the conftest's 8-device CPU mesh.

- `decode_attention_paged_sharded` on every rank's shard (its slots' table
  rows and positions, its kv heads of the pool, its rows of the scale pool)
  against JAX's shard_map island at tp 2 and at dp 2 x tp 2, the setting of
  tests/test_parallel.py's test_paged_island_matches_unsharded (the JAX
  island takes the gathered [S, Hkv, win] scales of the same pool);
- `shard_paged_cache` blocks against the JAX shard_paged_cache's shards,
  flat and 5D pools (scales cut over tp only where the JAX rule cuts them);
- prefill_paged, prefill_paged_suffix and decode_step_paged under a live
  mesh (every rank a thread) against the JAX functions under the same mesh.

Tolerances: the island as tests/test_parallel.py holds it (rtol 5e-2 /
atol 1e-2 on int8 pools, q and P requantized to int8 per block; 1e-5 /
1e-6 on float pools); blocks exactly; whole steps within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.parallel import mesh as jmesh
from tpuserve.parallel import sharding as jshard
from tpuserve.serving.paged_kv import PagedKVCache as JPagedKVCache
from tpuserve_torch import interop
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.parallel import mesh as tmesh
from tpuserve_torch.parallel import sharding as tshard
from tpuserve_torch.serving.paged_kv import PagedKVCache, pad8
from test_torch_parallel import jax_block, run_ranks
from torch_parity import jax_to_torch_params, to_np

torch.set_num_threads(1)


def _pools(quantized, rng, n_layers=2, n_pages=9, ps=8, n_kv=4, hd=32):
    w = n_kv * hd
    if quantized:
        kp = rng.integers(-127, 127, size=(n_layers, n_pages, ps, w)).astype(np.int8)
        vp = rng.integers(-127, 127, size=(n_layers, n_pages, ps, w)).astype(np.int8)
        hp = pad8(n_kv)
        ks = rng.uniform(0.001, 0.02, size=(n_layers, n_pages, hp, ps)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(n_layers, n_pages, hp, ps)).astype(np.float32)
        ks[:, :, n_kv:] = 0.0
        vs[:, :, n_kv:] = 0.0
    else:
        kp = rng.normal(size=(n_layers, n_pages, ps, w)).astype(np.float32)
        vp = rng.normal(size=(n_layers, n_pages, ps, w)).astype(np.float32)
        ks = vs = None
    return kp, vp, ks, vs


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)])
def test_paged_island_matches_jax(tp, dp, quantized):
    """Every rank's paged core over its shard against the JAX island on
    the same pool and table; inactive slots zero."""
    from tpuserve.parallel.sharding import decode_attention_paged_sharded as jisland

    rng = np.random.default_rng(6)
    n_layers, s, n_kv, rep, hd, ps, max_pages = 2, 4, 4, 2, 32, 8, 4
    h = n_kv * rep
    q = (rng.normal(size=(s, h, hd)) / np.sqrt(hd)).astype(np.float32)
    kp, vp, ks, vs = _pools(quantized, rng, n_kv=n_kv, hd=hd, ps=ps)
    win = max_pages * ps
    table = rng.permutation(np.arange(1, 9)).reshape(s // 2, 4).repeat(2, 0)[:s].astype(np.int32)
    positions = np.array([5, -1, win - 1, 12], np.int32)
    layer = 1
    mesh = jmesh.make_mesh(tp=tp, dp=dp)
    if quantized:   # the JAX island's form: this layer's pages gathered [S, Hkv, win]
        def gathered(pool):
            return jnp.asarray(pool[layer][table].transpose(0, 2, 1, 3).reshape(
                s, -1, win)[:, :n_kv])
        jks, jvs = gathered(ks), gathered(vs)
    else:
        jks = jvs = None
    ref = np.asarray(jisland(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jks, jvs,
                             jnp.asarray(table), jnp.asarray(positions), layer, mesh,
                             window=win))
    full = interop.paged_cache_from_numpy(kp, vp, ks, vs, device="cpu")

    def body(m):
        cache = tshard.shard_paged_cache(full, m)
        lo, hi = tshard.local_slots(m, s)
        n_loc = n_kv // tp
        ksr, vsr = tshard.paged_scale_rows(cache, n_loc, m)
        h0 = m.coords["tp"] * n_loc * rep
        out = tshard.decode_attention_paged_sharded(
            torch.from_numpy(q[lo:hi, h0:h0 + n_loc * rep]), cache.k, cache.v, ksr, vsr,
            torch.from_numpy(table[lo:hi]), torch.from_numpy(positions[lo:hi]), layer, m,
            window=win)
        return lo, h0, to_np(out)

    tol = dict(rtol=5e-2, atol=1e-2) if quantized else dict(rtol=1e-5, atol=1e-6)
    for lo, h0, out in run_ranks(tp, dp, 1, body):
        np.testing.assert_allclose(out, ref[lo:lo + out.shape[0], h0:h0 + out.shape[1]], **tol)
    assert np.all(ref[1] == 0.0)


@pytest.mark.parametrize("flat,n_kv,tp,dp", [(True, 4, 2, 1), (True, 4, 2, 2),
                                             (False, 8, 2, 2), (False, 4, 2, 1),
                                             (True, 8, 4, 2)])
def test_shard_paged_cache_blocks_match_jax(flat, n_kv, tp, dp):
    """Each rank's block of an int8 pool equals the JAX shard on its device:
    kv heads over tp, replicated over dp; the scale pool cut over tp only
    where its padded rows split into whole head groups (a 5D pool with Hkv a
    multiple of 8), else whole. paged_cache_block makes a flat pool's block
    at the same shapes."""
    rng = np.random.default_rng(2)
    kp, vp, ks, vs = _pools(True, rng, n_kv=n_kv, hd=16)
    shape5 = kp.shape[:3] + (n_kv, 16)
    if not flat:
        kp, vp = kp.reshape(shape5), vp.reshape(shape5)
    mesh = jmesh.make_mesh(tp=tp, dp=dp)
    jc = jshard.shard_paged_cache(JPagedKVCache(
        k=jnp.asarray(kp), v=jnp.asarray(vp), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        flat=flat), mesh)
    tc = PagedKVCache(k=torch.from_numpy(kp), v=torch.from_numpy(vp),
                      k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    split = not flat and n_kv % 8 == 0
    for r in range(tp * dp):
        m = tmesh.Mesh(tp, dp, 1, r)
        blk = tshard.shard_paged_cache(tc, m)
        for got, want in ((blk.k, jc.k), (blk.v, jc.v), (blk.k_scale, jc.k_scale),
                          (blk.v_scale, jc.v_scale)):
            np.testing.assert_array_equal(got.numpy(), jax_block(want, r))
        assert (blk.k_scale.shape[2] < ks.shape[2]) == split
        if flat:
            p = tllama.LlamaParams(n_layers=2, n_kv_heads=n_kv, head_dim=16, n_heads=n_kv)
            made = tshard.paged_cache_block(p, m, kp.shape[1], kp.shape[2], True,
                                            device="cpu")
            for a, b in ((made.k, blk.k), (made.k_scale, blk.k_scale)):
                assert a.shape == b.shape and a.dtype == b.dtype


P_TINY = dict(vocab_size=128, dim=32, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=8,
              ffn_dim=64)


@pytest.mark.parametrize("quantized,idle", [(False, False), (True, False), (True, True)],
                         ids=["f32", "kv8", "kv8-idle-dp-group"])
@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2), (1, 2)])
def test_paged_steps_under_mesh_match_jax(tp, dp, quantized, idle):
    """prefill_paged into slot 2, a prefix-shared suffix prefill into slot
    3 (its first page is slot 2's) and a decode step over all slots, every
    rank on its weight and pool blocks, against the JAX package's functions
    under the same mesh (its sharded pool, GSPMD): logits within 1e-4; the
    replicated scale pool of every rank within 1e-6 (scales of about 1e-3)
    of the JAX pool on the rows its dp group wrote. With `idle` the first
    two slots are inactive (under dp 2 a dp group with no live slot)."""
    jp = jllama.LlamaParams(**P_TINY)
    params = jllama.init_params(jax.random.PRNGKey(1), jp, dtype=jnp.float32)
    n_pages, ps, s = 12, 8, 4
    table = np.zeros((s, 4), np.int32)
    table[2, :3] = [3, 4, 5]
    table[3, :3] = [3, 6, 7]
    table[0, 0], table[1, 0] = 8, 9
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :11] = [7, 11, 23, 5, 19, 3, 1, 2, 9, 4, 6]
    suffix = np.zeros((1, 16), np.int32)
    suffix[0, :3] = [9, 8, 7]
    positions = np.array([-1, -1, 11, 11] if idle else [0, 0, 11, 11], np.int32)
    mesh = jmesh.make_mesh(tp=tp, dp=dp)
    sparams = jshard.shard_llama_params(params, mesh)
    jcache = jshard.shard_paged_cache(JPagedKVCache.create(
        jp, n_pages, ps, quantized=quantized, flat=True,
        dtype=None if quantized else jnp.float32), mesh)
    jshard.set_active_mesh(mesh)
    try:
        ref_p, jcache = jax.jit(lambda pr, t, c, tb: jllama.prefill_paged(
            pr, jp, t, c, tb, jnp.int32(2), jnp.int32(11)))(
            sparams, jnp.asarray(prompt), jcache, jnp.asarray(table))
        ref_s, jcache = jax.jit(lambda pr, t, c, tb: jllama.prefill_paged_suffix(
            pr, jp, t, c, tb, jnp.int32(3), jnp.int32(8), jnp.int32(3), 24))(
            sparams, jnp.asarray(suffix), jcache, jnp.asarray(table))
        tokens = np.array([3, 9, int(jnp.argmax(ref_p[0])), int(jnp.argmax(ref_s[0]))],
                          np.int32)
        ref_d, jcache = jax.jit(lambda pr, t, c, tb, pos: jllama.decode_step_paged(
            pr, jp, t, c, tb, pos, window=32))(
            sparams, jnp.asarray(tokens), jcache, jnp.asarray(table), jnp.asarray(positions))
    finally:
        jshard.set_active_mesh(None)
    tparams = jax_to_torch_params(params)
    p = tllama.LlamaParams(**P_TINY)

    def body(m):
        local = tshard.shard_llama_params(tparams, m)
        cache = tshard.shard_paged_cache(PagedKVCache.create(
            p, n_pages, ps, quantized, dtype=torch.float32, device="cpu"), m)
        tb = torch.from_numpy(table)
        lp, _ = tllama.prefill_paged(local, p, torch.from_numpy(prompt).long(), cache, tb, 2,
                                     11)
        ls, _ = tllama.prefill_paged_suffix(local, p, torch.from_numpy(suffix).long(), cache,
                                            tb, 3, 8, 3, 24)
        ld, _ = tllama.decode_step_paged(local, p, torch.from_numpy(tokens).long(), cache, tb,
                                         torch.from_numpy(positions), window=32)
        return m.coords, to_np(lp), to_np(ls), to_np(ld), cache

    for coords, lp, ls, ld, cache in run_ranks(tp, dp, 1, body):
        for got, want in ((lp, ref_p), (ls, ref_s), (ld, ref_d)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)
        if quantized:
            # rows the prefills wrote (every dp group runs them) and this
            # rank's dp slots' decode rows; the other groups' decode rows
            # are not in this copy of the pool
            rows = [(3, o) for o in range(8)] + [(4, o) for o in range(3)] \
                + [(6, o) for o in range(3)]
            pages = table[np.arange(s), positions // ps]
            rows += [(int(pages[i]), int(positions[i] % ps)) for i in range(s)
                     if i * dp // s == coords["dp"] and positions[i] >= 0]
            pg, off = np.array(rows).T
            for got, want in ((cache.k_scale, jcache.k_scale), (cache.v_scale, jcache.v_scale)):
                np.testing.assert_allclose(to_np(got)[:, pg, :, off],
                                           np.asarray(want)[:, pg, :, off], rtol=0, atol=1e-6)


def test_scale_rows_view_reaches_the_core(monkeypatch):
    """A tp rank's rows of a replicated scale pool (a view from its first
    head row, not contiguous) go to the paged core in place: the C entry
    gets the view's address and the whole pool's rows per page as hp, and
    the plain version is never taken for a CUDA tensor."""
    from test_torch_ops import _FakeCuda, _plain_must_not_run
    from tpuserve_torch import kernels
    from tpuserve_torch.ops import decode_attention as tda

    seen = []

    class Lib:
        def tpuserve_decode_attention_core(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(kernels, "lib", lambda: Lib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "check", lambda code, what: None)
    monkeypatch.setattr(tda, "decode_attention_wide_paged_plain", _plain_must_not_run)
    rng = np.random.default_rng(4)
    kp, vp, ks, vs = _pools(True, rng, n_kv=4, hd=128, ps=16)
    full = interop.paged_cache_from_numpy(kp, vp, ks, vs, device="cpu")
    m = tmesh.Mesh(2, 1, 1, 1)
    blk = tshard.shard_paged_cache(full, m)
    ksr, vsr = tshard.paged_scale_rows(blk, 2, m)
    assert not ksr.is_contiguous() and ksr.data_ptr() == blk.k_scale.data_ptr() + 2 * 16 * 4
    q = torch.Tensor._make_subclass(_FakeCuda, torch.zeros((4, 4, 128)))
    table = torch.ones((4, 2), dtype=torch.int32)
    tda.decode_attention_wide_paged(q, blk.k, blk.v, ksr, vsr, table,
                                    torch.zeros(4, dtype=torch.int32), 1)
    (args,) = seen
    assert args[3] == ksr.data_ptr() and args[4] == vsr.data_ptr()
    assert args[22] == blk.k_scale.shape[2] == 8      # hp: the whole pool's rows a page
    with pytest.raises(ValueError, match="scale pools must be"):
        tda.decode_attention_wide_paged(q, blk.k, blk.v, ksr[:, :, :1], vsr[:, :, :1], table,
                                        torch.zeros(4, dtype=torch.int32), 1)
