"""The layer pipeline (tpuserve_torch.parallel.pipeline) against the JAX
package's (tpuserve.parallel.pipeline) on the conftest's 8-device CPU mesh,
with the JAX tests' settings (tests/test_pipeline.py: a 4-layer model of
width 32, weights from PRNGKey(5), int8/int4 in groups of 16).

Every rank of the port is a thread of this process holding its stage block
and its block of the 5D stage cache (or page pool); ThreadComm
(tests/test_torch_parallel.py) runs the collectives, the rotation as one
exchange or, as over gloo, built from an all_reduce. The JAX side runs its
shard_map island on the virtual mesh.

Tolerances: stacks, blocks, the rank layout and the rotation exactly;
logits of every rank within 1e-4 (rtol and atol) for f32 weights and
within 1e-4 of the logits' range for int8 and int4 weights (the sharded
quant-matmul and decode-step tests' tolerances); stage caches after the
steps within 1e-5 (float) or one code (int8, with scales within 1e-6
relative), since a code may round the other way on an f32 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.parallel import pipeline as jpipe
from tpuserve.parallel.mesh import make_pipeline_mesh
from tpuserve.quant.core import quantize_param_tree as jquantize_tree
from tpuserve.serving.paged_kv import PagedKVCache as JPagedKVCache
from tpuserve_torch import interop
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.parallel import mesh as tmesh
from tpuserve_torch.parallel import pipeline as tpipe
from tpuserve_torch.quant.core import QExperts
from tpuserve_torch.serving.paged_kv import PagedKVCache
from test_torch_parallel import jax_block, run_ranks
from torch_parity import jax_tree_to_numpy, to_np

torch.set_num_threads(1)

P4 = dict(vocab_size=128, dim=32, n_layers=4, n_heads=4, n_kv_heads=2, head_dim=8, ffn_dim=64)
P_MOE = dict(P4, n_experts=4, n_experts_per_tok=2)
N_SLOTS, MAX_LEN = 8, 32
PROMPT = [7, 11, 23, 5, 19, 3]
POSITIONS = np.array([0, 0, 6, -1, 0, 0, -1, 0], np.int32)


def _jax_params(dims, quant=None):
    jp = jllama.LlamaParams(**dims)
    raw = jllama.fuse_params(jllama.init_params(jax.random.PRNGKey(5), jp, dtype=jnp.float32), jp)
    if quant:
        raw = jquantize_tree(raw, bits=quant, group_size=16,
                             predicate=lambda n, a: a.ndim in (2, 3) and n.endswith("kernel")
                             and "router" not in n)
    return jp, raw


def _np_leaf(v):
    if isinstance(v, dict):
        return np.asarray(v["q"]), np.asarray(v["scale"])
    return (np.asarray(v),)


def _torch_leaf(v):
    if hasattr(v, "q"):
        return to_np(v.q) if v.q.dtype.is_floating_point else v.q.numpy(), to_np(v.scale)
    return (to_np(v) if v.dtype.is_floating_point else v.numpy(),)


def _assert_trees_equal(tparams, jtree):
    assert set(tparams) == set(jtree)
    for name, v in tparams.items():
        for a, b in zip(_torch_leaf(v), _np_leaf(jtree[name])):
            np.testing.assert_array_equal(a, np.asarray(b, a.dtype), err_msg=name)


# ---------------------------------------------------------------- the mesh
@pytest.mark.parametrize("pp,tp,dp,sp", [(2, 1, 1, 1), (4, 2, 1, 1), (2, 2, 2, 1),
                                         (2, 1, 2, 1), (2, 1, 1, 2), (2, 1, 2, 2)])
def test_pipeline_rank_layout_matches_jax_mesh(pp, tp, dp, sp):
    """Rank r sits where make_pipeline_mesh puts jax.devices()[r], under the
    same axis names, and each axis group is the devices along that axis."""
    mesh = make_pipeline_mesh(pp, tp, dp, sp)
    n = pp * tp * dp * sp
    m = tmesh.make_pipeline_mesh(pp, tp, dp, sp, comm=object())
    assert m.axis_names == tuple(mesh.axis_names)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    names = list(mesh.axis_names)
    for r in range(n):
        c = tmesh.rank_coords(r, tp, dp, sp, pp)
        where = tuple(c[a] for a in names)
        assert ids[where] == jax.devices()[r].id
        assert tmesh.coords_rank(c, tp, dp, sp, pp) == r
    for axis in names:
        got = set(tmesh.axis_groups(axis, tp, dp, sp, pp))
        moved = np.moveaxis(ids, names.index(axis), -1).reshape(-1, mesh.shape[axis])
        assert got == {tuple(int(i) for i in row) for row in moved}


def test_pipeline_sp_tp_refused():
    with pytest.raises(ValueError, match="sp x tp"):
        tmesh.make_pipeline_mesh(2, tp=2, sp=2, comm=object())
    with pytest.raises(ValueError, match="sp x tp"):
        make_pipeline_mesh(2, 2, 1, 2)


@pytest.mark.parametrize("p2p", [True, False], ids=["exchange", "all_reduce"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_ppermute_rotates_bit_for_bit(p2p, dtype):
    """The rotation i -> i+1 (mod pp) within each pp group of a dp 2 x pp 4
    mesh: every rank gets its predecessor's tensor bit for bit, through the
    exchange and through the zero-padded all_reduce gloo ranks use."""
    def fn(m):
        x = (torch.arange(6, dtype=torch.float32) * 0.1 + m.rank).to(dtype)
        return m.coords, m.ppermute(x, "pp")

    outs = run_ranks(1, 2, 1, fn, pp=4, p2p=p2p)
    for r, (c, got) in enumerate(outs):
        prev = tmesh.coords_rank(dict(c, pp=(c["pp"] - 1) % 4), 1, 2, 1, 4)
        want = (torch.arange(6, dtype=torch.float32) * 0.1 + prev).to(dtype)
        assert torch.equal(got, want), r


# ---------------------------------------------------------------- stacking
@pytest.mark.parametrize("quant,tp", [(None, 1), (8, 1), (4, 2), (None, 2)])
def test_stack_layer_params_match_jax(quant, tp):
    """The port's stacks equal the JAX package's (QTensor layers as QExperts
    stacks, fused columns regrouped rank-major under tp), carried back to
    numpy too, and a layer view gives back the layer."""
    jp, raw = _jax_params(P4, quant)
    tparams = interop.params_from_numpy(jax_tree_to_numpy(raw), "cpu")
    p = tllama.LlamaParams(**P4)
    stacked = tpipe.stack_layer_params(tparams, p, tp=tp)
    jstacked = jax_tree_to_numpy(jpipe.stack_layer_params(raw, jp, tp=tp))
    _assert_trees_equal(stacked, jstacked)
    back = interop.params_to_numpy(stacked)   # the way back, as the JAX package's numpy form
    for name, v in back.items():
        for a, b in zip(_np_leaf(v), _np_leaf(jstacked[name])):
            np.testing.assert_array_equal(a, b, err_msg=name)
    if tp == 1:
        view = tpipe._layer_view(stacked, 2)
        for key, val in view.items():
            orig = tparams["layers.2/" + key[len("L/"):]]
            for a, b in zip(_torch_leaf(val), _torch_leaf(orig)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shuffle_cols_roundtrip(tp):
    """_tp_shuffle_cols equals the JAX regroup, a permutation that its
    inverse undoes; a width that does not divide tp is refused."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 16, 32 + 16 + 16)).astype(np.float32)
    segs = [32, 16, 16]
    got = tpipe._tp_shuffle_cols(torch.from_numpy(w), segs, tp)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpipe._tp_shuffle_cols(jnp.asarray(w), segs, tp)))
    inverse = np.argsort(tpipe._tp_perm(segs, tp))
    np.testing.assert_array_equal(got.numpy()[..., inverse], w)
    with pytest.raises(ValueError, match="must divide"):
        tpipe._tp_shuffle_cols(torch.from_numpy(w), [30, 17, 17], tp)


@pytest.mark.parametrize("quant,pp,tp,dp", [(None, 2, 1, 1), (8, 2, 2, 1), (4, 2, 2, 2),
                                            (8, 4, 1, 2)])
def test_stage_blocks_match_jax_shards(quant, pp, tp, dp):
    """Each rank's stage block (place_pipeline_params on the port's stacks,
    the JAX stacks carried by interop, and StageBlock cutting each layer as
    it is drawn) equals the shard the JAX place_pipeline_params puts on its
    device, byte for byte; shared params whole."""
    jp, raw = _jax_params(P4, quant)
    jstacked = jpipe.stack_layer_params(raw, jp, tp=tp)
    mesh = make_pipeline_mesh(pp, tp, dp)
    placed = jpipe.place_pipeline_params(jstacked, mesh)
    p = tllama.LlamaParams(**P4)
    tparams = interop.params_from_numpy(jax_tree_to_numpy(raw), "cpu")
    stacked_np = jax_tree_to_numpy(jstacked)
    for r in range(pp * tp * dp):
        m = tmesh.Mesh(tp, dp, 1, r, pp=pp)
        want = {}
        for name, v in placed.items():
            if hasattr(v, "q"):
                want[name] = dataclasses.replace(v, q=jax_block(v.q, r),
                                                 scale=jax_block(v.scale, r))
            else:
                want[name] = jax_block(v, r)
        want = {k: (dict(q=v.q, scale=v.scale) if hasattr(v, "q") else v)
                for k, v in want.items()}
        blocks = [tpipe.place_pipeline_params(tpipe.stack_layer_params(tparams, p, tp=tp), m),
                  interop.stage_block_from_numpy(stacked_np, m, "cpu")]
        stage = tpipe.StageBlock(p, m)
        kept = {name: stage.keep(name, val) for name, val in tparams.items()}
        blocks.append(stage.finish(kept))
        for blk in blocks:
            assert set(blk) == set(want)
            for name, v in blk.items():
                ref = want[name]
                pairs = zip(_torch_leaf(v), (ref["q"], ref["scale"]) if isinstance(ref, dict)
                            else (ref,))
                for a, b in pairs:
                    np.testing.assert_array_equal(a, np.asarray(b, a.dtype), err_msg=name)
                if isinstance(v, QExperts) and v.q.dim() == 3:
                    k = v.q.shape[1] * (2 if v.bits == 4 else 1)
                    assert v.orig_shape == (p.n_layers // pp, k, v.q.shape[2])


def test_qexperts_scale_groups_refused_under_tp():
    """A row-cut stack whose scale groups do not divide tp is refused, as in
    the JAX package (no clean local dequantization)."""
    jp, raw = _jax_params(P4, 8)
    p = tllama.LlamaParams(**P4)
    tparams = interop.params_from_numpy(jax_tree_to_numpy(raw), "cpu")
    stacked = tpipe.stack_layer_params(tparams, p, tp=4)
    # wo: K = 32 in groups of 16 -> 2 groups over tp 4
    with pytest.raises(ValueError, match="scale groups 2 must divide tp 4"):
        tpipe.pipeline_pspecs(stacked, tp=4)
    with pytest.raises(ValueError, match="scale groups 2 must divide tp 4"):
        jpipe.pipeline_pspecs(jpipe.stack_layer_params(raw, jp, tp=4), tp=4)


# ---------------------------------------------------------------- decode / prefill
def _jax_steps(jp, raw, mesh, tp, quant_kv, moe=False):
    jstacked = jpipe.place_pipeline_params(jpipe.stack_layer_params(raw, jp, tp=tp), mesh)
    cache = jllama.KVCache.create(jp, N_SLOTS, MAX_LEN, quantized=quant_kv,
                                  dtype=None if quant_kv else jnp.float32)
    cache = jpipe.shard_cache_pp(cache, mesh)
    prompt = jnp.asarray([PROMPT], jnp.int32)
    logits_p, cache = jax.jit(
        lambda pr, t, c, s, ln: jpipe.pp_prefill(pr, jp, t, c, s, ln, mesh),
        donate_argnums=(2,))(jstacked, prompt, cache, jnp.int32(2), jnp.int32(len(PROMPT)))
    tokens = np.array([3, 9, int(jnp.argmax(logits_p[0])), 1, 0, 5, 2, 8], np.int32)
    logits_d, cache = jax.jit(
        lambda pr, t, c, pos: jpipe.pp_decode_step(pr, jp, t, c, pos, mesh),
        donate_argnums=(2,))(jstacked, jnp.asarray(tokens), cache, jnp.asarray(POSITIONS))
    return np.asarray(logits_p), tokens, np.asarray(logits_d), cache


def _port_steps(dims, raw, tp, dp, sp, pp, quant_kv, tokens, p2p=True):
    p = tllama.LlamaParams(**dims)
    tparams = interop.params_from_numpy(jax_tree_to_numpy(raw), "cpu")
    stacked = tpipe.stack_layer_params(tparams, p, tp=tp)

    def fn(m):
        blk = tpipe.place_pipeline_params(stacked, m)
        cache = tpipe.stage_cache(p, m, N_SLOTS, MAX_LEN, quant_kv, dtype=torch.float32,
                                  device="cpu")
        cut = tpipe.shard_cache_pp(tllama.KVCache.create(
            p, N_SLOTS, MAX_LEN, quant_kv, dtype=torch.float32, device="cpu", flat=False), m)
        for a, b in ((cache.k, cut.k), (cache.k_scale, cut.k_scale)):
            assert (a is None and b is None) or (a.shape == b.shape and a.dtype == b.dtype)
        tok = torch.zeros((1, 16), dtype=torch.long)
        tok[0, :len(PROMPT)] = torch.tensor(PROMPT)
        lp, _ = tpipe.pp_prefill(blk, p, tok[:, :len(PROMPT)], cache, 2, len(PROMPT), m)
        ld, _ = tpipe.pp_decode_step(blk, p, torch.from_numpy(tokens).long(), cache,
                                     torch.from_numpy(POSITIONS), m)
        return to_np(lp), to_np(ld), cache

    return run_ranks(tp, dp, sp, fn, pp=pp, p2p=p2p)


def _check_logits(got, ref, quant):
    if quant is None:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        rel = np.max(np.abs(got.astype(np.float64) - ref)) / max(np.max(np.abs(ref)), 1e-30)
        assert rel < 1e-4, rel


def _check_cache(tcache, jcache, r, quant_kv):
    for t, j in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        want = jax_block(j, r)
        if quant_kv:
            assert np.max(np.abs(t.numpy().astype(np.int32) - want.astype(np.int32))) <= 1
        else:
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-5, atol=1e-5)
    if quant_kv:
        for t, j in ((tcache.k_scale, jcache.k_scale), (tcache.v_scale, jcache.v_scale)):
            np.testing.assert_allclose(to_np(t), jax_block(j, r), rtol=1e-6, atol=1e-9)


CASES = {
    "pp2-f32": (2, 1, 1, 1, None, False),
    "pp2-f32-kv8": (2, 1, 1, 1, None, True),
    "pp2-int8-kv8": (2, 1, 1, 1, 8, True),
    "pp2-int4": (2, 1, 1, 1, 4, False),
    "pp2tp2-f32": (2, 2, 1, 1, None, False),
    "pp2tp2-int8-kv8": (2, 2, 1, 1, 8, True),
    "pp2tp2-int4-kv8": (2, 2, 1, 1, 4, True),
    "dp2pp2-f32-kv8": (2, 1, 2, 1, None, True),
    "dp2pp2-int4": (2, 1, 2, 1, 4, False),
    "dp2pp2tp2-int8": (2, 2, 2, 1, 8, False),
    "pp2sp2-f32": (2, 1, 1, 2, None, False),
    "pp2sp2-int8-kv8": (2, 1, 1, 2, 8, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pp_prefill_and_decode_match_jax(case):
    """pp_prefill into slot 2, then a decode step over all 8 slots (the JAX
    tests' tokens and positions: a context of 6, fresh slots, inactive ones)
    on every rank of the mesh, against the JAX island: every rank's logits
    ([1, V] and [S, V]) and its stage cache block after both steps (made at
    its size, the shape of shard_cache_pp's cut). The pp 2 cases rotate
    through the all_reduce form gloo ranks use."""
    pp, tp, dp, sp, quant, quant_kv = CASES[case]
    jp, raw = _jax_params(P4, quant)
    mesh = make_pipeline_mesh(pp, tp, dp, sp)
    ref_p, tokens, ref_d, jcache = _jax_steps(jp, raw, mesh, tp, quant_kv)
    outs = _port_steps(P4, raw, tp, dp, sp, pp, quant_kv, tokens,
                       p2p=(tp, dp, sp) != (1, 1, 1))
    for r, (lp, ld, cache) in enumerate(outs):
        _check_logits(lp, ref_p, quant)
        _check_logits(ld, ref_d, quant)
        assert np.all(ld[[3, 6]] == 0.0)   # inactive slots
        _check_cache(cache, jcache, r, quant_kv)


@pytest.mark.parametrize("quant", [None, 8])
def test_pp_moe_matches_jax(quant):
    """pp 2 x MoE (4 experts, top-2; tensor_parallel stays 1, as the JAX
    engine requires): expert stacks nest as [L, E, ...] QExperts; prefill
    and decode logits against the JAX island."""
    jp, raw = _jax_params(P_MOE, quant)
    mesh = make_pipeline_mesh(2)
    ref_p, tokens, ref_d, _ = _jax_steps(jp, raw, mesh, 1, False, moe=True)
    for lp, ld, _ in _port_steps(P_MOE, raw, 1, 1, 1, 2, False, tokens):
        _check_logits(lp, ref_p, quant)
        _check_logits(ld, ref_d, quant)


# ---------------------------------------------------------------- 5D paged pool
def test_paged_pool_5d_layout_and_reshape_roundtrip():
    """PagedKVCache.create(flat=False) has the JAX 5D pool's shapes; the
    flat and 5D layouts hold the same bytes: JAX's 5D pool state carried
    over as numpy (interop flattens it) reshapes back to the 5D arrays, and
    flat again, without a copy."""
    jp = jllama.LlamaParams(**P4)
    p = tllama.LlamaParams(**P4)
    for q in (False, True):
        j5 = JPagedKVCache.create(jp, 12, 8, quantized=q, flat=False)
        t5 = PagedKVCache.create(p, 12, 8, quantized=q, dtype=torch.float32, device="cpu",
                                 flat=False)
        assert t5.k.dim() == 5 and tuple(t5.k.shape) == j5.k.shape
        if q:
            assert tuple(t5.k_scale.shape) == j5.k_scale.shape
    rng = np.random.default_rng(1)
    k = rng.integers(-128, 128, size=(4, 12, 8, 2, 8)).astype(np.int8)
    v = rng.integers(-128, 128, size=(4, 12, 8, 2, 8)).astype(np.int8)
    ks = rng.random((4, 12, 8, 8)).astype(np.float32)
    flat = interop.paged_cache_from_numpy(k, v, ks, ks, device="cpu")
    assert flat.k.dim() == 4
    five = flat.k.view(flat.k.shape[:3] + (p.n_kv_heads, p.head_dim))
    np.testing.assert_array_equal(five.numpy(), k)
    assert five.data_ptr() == flat.k.data_ptr()
    np.testing.assert_array_equal(five.flatten(-2).numpy(), k.reshape(4, 12, 8, 16))
    np.testing.assert_array_equal(flat.v.view(five.shape).numpy(), v)


@pytest.mark.parametrize("quant_kv,idle", [(False, False), (True, False), (True, True)],
                         ids=["f32", "kv8", "kv8-idle-microbatch"])
def test_pp_paged_matches_jax(quant_kv, idle):
    """pp_prefill_paged into slot 2's pages and pp_decode_step_paged over a
    page table (invalid rows aimed at the zero page, a window trimming the
    table) on the 5D pool, against the JAX island at pp 2: logits and each
    stage's pool block; with `idle` the second microbatch has no live
    slot (nothing to write there)."""
    jp, raw = _jax_params(P4)
    mesh = make_pipeline_mesh(2)
    n_pages, ps = 16, 8
    table = np.zeros((N_SLOTS, 4), np.int32)
    table[2, :2] = [3, 4]
    for s, pg in ((0, 5), (1, 6), (4, 7), (5, 8), (7, 9)):
        table[s, 0] = pg
    jstacked = jpipe.place_pipeline_params(jpipe.stack_layer_params(raw, jp), mesh)
    jcache = jpipe.shard_paged_cache_pp(
        JPagedKVCache.create(jp, n_pages, ps, quantized=quant_kv, flat=False,
                             dtype=jnp.float32), mesh)
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(PROMPT)] = PROMPT
    ref_p, jcache = jax.jit(
        lambda pr, t, c, tb, s, ln: jpipe.pp_prefill_paged(pr, jp, t, c, tb, s, ln, mesh),
        donate_argnums=(2,))(jstacked, jnp.asarray(prompt), jcache, jnp.asarray(table),
                             jnp.int32(2), jnp.int32(len(PROMPT)))
    tokens = np.array([3, 9, int(jnp.argmax(ref_p[0])), 1, 0, 5, 2, 8], np.int32)
    positions = POSITIONS.copy()
    if idle:
        positions[4:] = -1
    ref_d, jcache = jax.jit(
        lambda pr, t, c, tb, pos: jpipe.pp_decode_step_paged(pr, jp, t, c, tb, pos, mesh,
                                                             window=16),
        donate_argnums=(2,))(jstacked, jnp.asarray(tokens), jcache, jnp.asarray(table),
                             jnp.asarray(positions))
    p = tllama.LlamaParams(**P4)
    stacked = tpipe.stack_layer_params(
        interop.params_from_numpy(jax_tree_to_numpy(raw), "cpu"), p)

    def fn(m):
        blk = tpipe.place_pipeline_params(stacked, m)
        cache = tpipe.shard_paged_cache_pp(
            PagedKVCache.create(p, n_pages, ps, quantized=quant_kv, dtype=torch.float32,
                                device="cpu", flat=False), m)
        lp, _ = tpipe.pp_prefill_paged(blk, p, torch.from_numpy(prompt).long(), cache,
                                       torch.from_numpy(table), 2, len(PROMPT), m)
        ld, _ = tpipe.pp_decode_step_paged(blk, p, torch.from_numpy(tokens).long(), cache,
                                           torch.from_numpy(table),
                                           torch.from_numpy(positions), m, window=16)
        return to_np(lp), to_np(ld), cache

    for r, (lp, ld, cache) in enumerate(run_ranks(1, 1, 1, fn, pp=2)):
        np.testing.assert_allclose(lp, np.asarray(ref_p), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ld, np.asarray(ref_d), rtol=1e-4, atol=1e-4)
        _check_cache(cache, jcache, r, quant_kv)
