"""Sharded serving's per-shard bodies (tpuserve_torch.parallel) against the
JAX package's on the conftest's 8-device CPU mesh, in one process.

Every rank of the port is a process that holds its block of each tensor.
Here each rank's body runs on its block in turn and the collective is done
by hand (a sum or a max over the ranks of an axis), or, for a whole decode
step, every rank runs as a thread of this process with `ThreadComm` doing
the collectives. The JAX side runs its shard_map islands on the virtual
mesh, its Pallas kernels in interpret mode where tests/test_parallel.py
runs them so.

Tolerances: parameter blocks, the mesh layout and the packed int4 KV bytes
exactly; the quant-matmul within 1e-4 of the output's range (the plain
version against XLA's dequantize-then-matmul, f32 x); the flat core on
int8 and packed int4 KV within rtol 5e-2 / atol 1e-2 (q and P requantized
to int8 per block, as tests/test_parallel.py holds the JAX island against
the unsharded kernel); the sequence-parallel merge within 1e-5 in f32 and
1e-2 relative on int8 KV (bf16 dots); the MoE FFN within 1e-5 of its
range; whole decode steps within 1e-4, as the JAX test
test_decode_step_sp_matches_single_device.
"""

import collections
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
from tpuserve.quant import core as jcore
from tpuserve_torch import interop
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.parallel import mesh as tmesh
from tpuserve_torch.parallel import sharding as tshard
from torch_parity import jax_qt_to_torch, jax_to_torch_params, to_np

torch.set_num_threads(1)


class ThreadComm:
    """Collectives among the threads of one process, one thread a rank:
    every member of a group deposits its tensor, the last to arrive reduces
    them in rank order (a sum or a max; the pipeline's rotation hands each
    member its predecessor's), and each member copies the result back.
    `p2p` (the rotation as one exchange, as NCCL's send/recv): with False
    the mesh builds it from all_reduce, as over gloo."""

    def __init__(self, p2p=True):
        self.cv = threading.Condition()
        self.slots = {}
        self.seq = collections.defaultdict(int)
        self.p2p = p2p

    def _exchange(self, rank, t, ranks, combine):
        with self.cv:
            n = self.seq[(ranks, rank)]
            self.seq[(ranks, rank)] += 1
            e = self.slots.setdefault((ranks, n), {"vals": {}, "out": None, "read": 0})
            e["vals"][rank] = t.clone()
            if len(e["vals"]) == len(ranks):
                e["out"] = combine(e["vals"])
                self.cv.notify_all()
            while e["out"] is None:
                if not self.cv.wait(timeout=120):
                    raise TimeoutError("a rank never reached the collective")
            e["read"] += 1
            out = e["out"]
            if e["read"] == len(ranks):
                del self.slots[(ranks, n)]
        return out

    def bind(self, rank):
        comm = self

        class RankComm:
            p2p = comm.p2p

            def all_reduce(self, t, op, ranks):
                def combine(vals):
                    out = vals[ranks[0]].clone()
                    for r in ranks[1:]:
                        v = vals[r]
                        out = torch.maximum(out, v) if op == "max" else out + v
                    return out

                t.copy_(comm._exchange(rank, t, ranks, combine))
                return t

            def ppermute(self, t, ranks):
                prev = ranks[(ranks.index(rank) - 1) % len(ranks)]
                return comm._exchange(rank, t, ranks, dict)[prev].clone()

        return RankComm()


def run_ranks(tp, dp, sp, fn, pp=1, p2p=True):
    """fn(mesh) on every rank of a tp x dp x sp (x pp) mesh, each in a
    thread with its mesh active; returns the results in rank order."""
    comm = ThreadComm(p2p)
    n = tp * dp * sp * pp
    out, errors = [None] * n, []

    def body(r):
        try:
            mesh = tmesh.Mesh(tp, dp, sp, r, comm.bind(r), pp=pp)
            with tshard.use_mesh(mesh):
                out[r] = fn(mesh)
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return out


def fake_mesh(tp=1, dp=1, sp=1, rank=0):
    """A rank's mesh for the per-shard bodies (no collective is made)."""
    return tmesh.Mesh(tp, dp, sp, rank, comm=None)


def jax_block(arr, rank):
    """The addressable shard of a global jax.Array on device `rank`."""
    dev = jax.devices()[rank]
    for s in arr.addressable_shards:
        if s.device == dev:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {dev}")


def _rel(out, ref):
    return float(np.max(np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64)))
                 / max(float(np.max(np.abs(ref))), 1e-30))


# ---------------------------------------------------------------- mesh layout
@pytest.mark.parametrize("tp,dp,sp", [(4, 2, 1), (2, 2, 2), (2, 1, 4), (1, 8, 1), (8, 1, 1)])
def test_rank_layout_matches_jax_mesh(tp, dp, sp):
    """Rank r sits where the JAX mesh puts jax.devices()[r], and each axis
    group is the devices along that mesh axis."""
    mesh = jmesh.make_mesh(tp=tp, dp=dp, sp=sp)
    devs = mesh.devices.reshape(dp, sp, tp)
    ids = {d.id: i for i, d in enumerate(jax.devices())}
    for r in range(tp * dp * sp):
        c = tmesh.rank_coords(r, tp, dp, sp)
        assert ids[devs[c["dp"], c["sp"], c["tp"]].id] == r
        assert tmesh.coords_rank(c, tp, dp, sp) == r
    got = set(tmesh.axis_groups("tp", tp, dp, sp))
    assert got == {tuple(ids[d.id] for d in devs[i, j, :]) for i in range(dp) for j in range(sp)}
    got = set(tmesh.axis_groups("sp", tp, dp, sp))
    assert got == {tuple(ids[d.id] for d in devs[i, :, j]) for i in range(dp) for j in range(tp)}
    got = set(tmesh.axis_groups("dp", tp, dp, sp))
    assert got == {tuple(ids[d.id] for d in devs[:, i, j]) for i in range(sp) for j in range(tp)}
    m = fake_mesh(tp, dp, sp, tp * dp * sp - 1)
    assert m.axis_names == tuple(jmesh.make_mesh(tp=tp, dp=dp, sp=sp).axis_names)


def test_make_mesh_needs_the_ranks():
    with pytest.raises(ValueError, match="need 16 ranks for dp=2 sp=1 tp=8, have 1"):
        tmesh.make_mesh(tp=8, dp=2)


# ---------------------------------------------------------------- parameter blocks
def _param_tree(seed=0):
    """A small Llama param dict in numpy: per-channel int8 rows, int4 g16
    rows whose group count (3) does not divide tp, and stacked MoE experts."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)
    return {
        "embed/weight": n(64, 32), "final_norm/scale": np.ones((32,), np.float32),
        "lm_head/kernel": n(32, 64),
        "layers.0/attn_norm/scale": np.ones((32,), np.float32),
        "layers.0/wqkv/kernel": n(32, 96), "layers.0/wo/kernel": n(48, 32),
        "layers.0/w_gateup/kernel": n(32, 128), "layers.0/w_down/kernel": n(64, 32),
        "layers.0/router/kernel": n(32, 4),
        "layers.0/moe_gateup/kernel": n(4, 32, 64), "layers.0/moe_down/kernel": n(4, 32, 32),
    }


def _quantized_trees(tree):
    """The tree quantized by the JAX package in three ways, each with its
    torch twin: int8 per channel, int4 in groups of 16 (wo's 3 groups), and
    int4 expert stacks."""
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    out = {}
    for tag, bits, gs in (("int8_per_channel", 8, 0), ("int4_g16", 4, 16)):
        q = jcore.quantize_param_tree(
            jt, bits=bits, group_size=gs,
            predicate=lambda name, a: a.ndim in (2, 3) and name.endswith("kernel")
            and "router" not in name)
        out[tag] = (q, jax_to_torch_params(q))
    return out


@pytest.mark.parametrize("tag", ["int8_per_channel", "int4_g16"])
@pytest.mark.parametrize("tp,dp,sp", [(2, 2, 2), (4, 2, 1)])
def test_param_blocks_match_jax_shards(tag, tp, dp, sp):
    """Each rank's block of every parameter is the JAX NamedSharding's
    addressable shard on device r, bytes equal: per-channel scales (G == 1)
    and group counts that do not divide tp replicate on row shards, expert
    stacks split E over tp."""
    jq, tq = _quantized_trees(_param_tree())[tag]
    mesh = jmesh.make_mesh(tp=tp, dp=dp, sp=sp)
    jsh = jshard.shard_llama_params(jq, mesh)
    assert tq["layers.0/wo/kernel"].scale.shape[0] in (1, 3)   # G == 1, or G % tp != 0
    for r in range(tp * dp * sp):
        local = tshard.shard_llama_params(tq, fake_mesh(tp, dp, sp, r))
        for name, jv in jsh.items():
            tv = local[name]
            if isinstance(jv, (jcore.QTensor, jcore.QExperts)):
                pairs = ((jv.q, tv.q), (jv.scale, tv.scale))
                k_loc = tv.q.shape[-2] * (2 if tv.bits == 4 else 1)
                assert tv.orig_shape[-2:] == (k_loc, tv.q.shape[-1])
            else:
                pairs = ((jv, tv),)
            for j, t in pairs:
                np.testing.assert_array_equal(to_np(t), jax_block(j, r), err_msg=f"{name} r{r}")


def test_param_pspecs_match_jax():
    """The specs of every parameter and of the KV cache, and the flat core's
    divisibility predicate, are the JAX package's."""
    jq, tq = _quantized_trees(_param_tree())["int4_g16"]
    js, ts = jshard.llama_param_pspecs(jq, tp=2), tshard.llama_param_pspecs(tq, tp=2)
    for name, spec in js.items():
        if isinstance(spec, (jcore.QTensor, jcore.QExperts)):
            assert (tuple(spec.q), tuple(spec.scale)) == (ts[name].q, ts[name].scale), name
        else:
            assert tuple(spec) == ts[name], name
    for sp in (False, True):
        jc, tc = jshard.cache_pspec(sp), tshard.cache_pspec(sp)
        assert [tuple(x) for x in (jc.k, jc.v, jc.k_scale, jc.v_scale)] == \
            [tc.k, tc.v, tc.k_scale, tc.v_scale]
    for tp, dp, sp in ((4, 2, 1), (2, 2, 2)):
        jm, tm = jmesh.make_mesh(tp=tp, dp=dp, sp=sp), fake_mesh(tp, dp, sp)
        for s, hkv in ((4, 4), (3, 4), (4, 2)):
            assert tshard.can_shard_decode_attention(tm, s, hkv) == \
                jshard.can_shard_decode_attention(jm, s, hkv)


# ---------------------------------------------------------------- sharded qmatmul
QMM_CASES = {
    # name, K, N, bits, group size, tp
    "column_int8": ("layers.0/wqkv/kernel", 64, 128, 8, 32, 4),
    "column_int4": ("layers.0/w_gateup/kernel", 64, 128, 4, 32, 4),
    "row_int8": ("layers.0/wo/kernel", 128, 64, 8, 32, 4),
    "row_int4": ("layers.0/w_down/kernel", 128, 64, 4, 32, 4),
    "row_int8_per_channel": ("layers.0/wo/kernel", 128, 64, 8, 0, 4),
    # G = 2 over tp = 4: each shard's 16 rows inside one group of 32
    "replicated_scale_int8": ("layers.0/wo/kernel", 64, 64, 8, 32, 4),
    # G = 3 over tp = 2: shards of 48 rows straddle groups of 32
    "straddling_int8": ("layers.0/w_down/kernel", 96, 64, 8, 32, 2),
}


@pytest.mark.parametrize("case", list(QMM_CASES))
def test_qmatmul_sharded_matches_jax(case):
    """Column shards' outputs side by side and row shards' partials summed
    by hand equal the JAX island's qmatmul_sharded on a (dp=2, tp) mesh."""
    name, k, n, bits, gs, tp = QMM_CASES[case]
    rng = np.random.RandomState(7)
    w = rng.randn(k, n).astype(np.float32) * 0.1
    x = rng.randn(8, k).astype(np.float32)
    jqt = jcore.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    mesh = jmesh.make_mesh(tp=tp, dp=2)
    ref = np.asarray(jshard.qmatmul_sharded(jnp.asarray(x), jqt, name, mesh))
    tqt = jax_qt_to_torch(jqt)
    row = tshard._row_sharded(name)
    parts = []
    for t in range(tp):
        block = tshard.shard_llama_params({name: tqt}, fake_mesh(tp, 2, 1, t))[name]
        xl = torch.from_numpy(x[:, t * k // tp:(t + 1) * k // tp] if row else x)
        parts.append(tshard.qmatmul_local(xl, block, name, t, tp))
    out = sum(parts) if row else torch.cat(parts, dim=-1)
    assert _rel(to_np(out), ref) < 1e-4, case


def test_qmatmul_int4_row_shard_cutting_a_group_raises():
    """int4 codes pack split-half per group: a row shard of 16 rows of a
    group of 32 would pair nibbles with the wrong rows (the JAX island does
    so); the port raises, and the engine refuses such configs."""
    rng = np.random.RandomState(3)
    jqt = jcore.quantize(jnp.asarray(rng.randn(64, 32).astype(np.float32)), bits=4,
                         group_size=32)
    block = tshard.shard_llama_params({"layers.0/wo/kernel": jax_qt_to_torch(jqt)},
                                      fake_mesh(4, 1, 1, 1))["layers.0/wo/kernel"]
    assert tshard.row_shard_cuts_group(64, 32, 4) and not tshard.row_shard_cuts_group(64, 32, 2)
    with pytest.raises(ValueError, match="cuts a packing group"):
        tshard.qmatmul_local(torch.zeros((2, 16)), block, "layers.0/wo/kernel", 1, 4)


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("tp,dp", [(2, 1), (2, 2)])
def test_blocks_cut_as_drawn_equal_whole_cut(moe, tp, dp):
    """A rank that cuts each parameter to its block as it is drawn (the
    engine under a mesh, so the device never holds the whole model) keeps
    the blocks that cutting the whole model gives: the draws are the same,
    bytes and block_fingerprint equal; another rank's blocks differ."""
    from tpuserve_torch.models.llama_bench import init_quantized_params

    p = tllama.LlamaParams(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
                           head_dim=8, ffn_dim=64, n_experts=4 if moe else 0,
                           n_experts_per_tok=2 if moe else 0)
    whole = init_quantized_params(p, bits=4, group_size=16, device="cpu", seed=3)
    prints = []
    for r in range(tp * dp):
        mesh = fake_mesh(tp, dp, 1, r)
        cut = init_quantized_params(
            p, bits=4, group_size=16, device="cpu", seed=3,
            keep=lambda name, v: tshard.shard_llama_params({name: v}, mesh)[name])
        ref = tshard.shard_llama_params(whole, mesh)
        assert list(cut) == list(ref)
        for name, v in ref.items():
            for a, b in ((v.q, cut[name].q), (v.scale, cut[name].scale)) \
                    if hasattr(v, "q") else ((v, cut[name]),):
                assert torch.equal(a, b), (name, r)
                # a block owns its bytes: no view keeps the whole tensor alive
                assert b.untyped_storage().nbytes() == b.numel() * b.element_size(), (name, r)
        prints.append(tshard.block_fingerprint(cut))
        assert prints[-1] == tshard.block_fingerprint(ref)
    assert prints[0] != prints[1]
    raw = tllama.init_params(p, dtype=torch.float32, device="cpu", seed=3)
    kept = tllama.init_params(p, dtype=torch.float32, device="cpu", seed=3,
                              keep=lambda _, t: t.clone())
    assert list(raw) == list(kept) and all(torch.equal(raw[k], kept[k]) for k in raw)


def test_kernel_operand_per_shard_kind():
    """What qmatmul_local hands the kernel: a column shard's block itself; a
    row shard inside one group of a replicated scale, that group's scale as
    one group of its rows; a row shard straddling groups, None (plain
    torch)."""
    rng = np.random.RandomState(4)
    w = jnp.asarray(rng.randn(96, 16).astype(np.float32))
    col = jax_qt_to_torch(jcore.quantize(w, bits=8, group_size=32))
    assert tshard.kernel_operand(col, "layers.0/wqkv/kernel", 1, 2) is col
    one = jax_qt_to_torch(jcore.quantize(w, bits=8, group_size=32))   # 3 groups, tp 6
    block = tshard.shard_llama_params({"layers.0/wo/kernel": one},
                                      fake_mesh(6, 1, 1, 3))["layers.0/wo/kernel"]
    op = tshard.kernel_operand(block, "layers.0/wo/kernel", 3, 6)
    assert op.group_size == 0 and torch.equal(op.scale, one.scale[1:2])
    block = tshard.shard_llama_params({"layers.0/wo/kernel": one},
                                      fake_mesh(4, 1, 1, 1))["layers.0/wo/kernel"]
    assert tshard.kernel_operand(block, "layers.0/wo/kernel", 1, 4) is None


# ---------------------------------------------------------------- KV bytes
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_pack_kv_codes_chunks_byte_equal(chunks):
    """pack_kv_codes(codes, chunks) is the JAX package's, byte for byte; its
    unpack inverts it; and chunk c's bytes are chunk c's codes packed alone
    (a tp rank's cache block)."""
    rng = np.random.default_rng(chunks)
    codes = rng.integers(-8, 8, size=(3, 5, 256)).astype(np.int8)
    jp = np.asarray(jllama.pack_kv_codes(jnp.asarray(codes), chunks))
    tp_ = tllama.pack_kv_codes(torch.from_numpy(codes), chunks)
    np.testing.assert_array_equal(tp_.numpy(), jp)
    from tpuserve_torch.ops.decode_attention import unpack_kv_codes

    np.testing.assert_array_equal(unpack_kv_codes(tp_, chunks).numpy(), codes)
    np.testing.assert_array_equal(
        unpack_kv_codes(tp_, chunks).numpy(),
        np.asarray(jllama.unpack_kv_codes(jnp.asarray(jp), chunks)))
    wc = 256 // chunks
    for c in range(chunks):
        np.testing.assert_array_equal(
            jp[..., c * wc // 2:(c + 1) * wc // 2],
            tllama.pack_kv_codes(torch.from_numpy(codes[..., c * wc:(c + 1) * wc])).numpy())


def _attention_inputs(kind, s=4, l=64, n_kv=4, rep=2, hd=128, n_layers=2, seed=5):
    rng = np.random.default_rng(seed)
    h = n_kv * rep
    q = (rng.normal(size=(s, h, hd)) / np.sqrt(hd)).astype(np.float32)
    positions = np.array([3, -1, l - 1, 37], np.int32)[:s]
    if kind == "f32":
        k = rng.normal(size=(n_layers, s, l, n_kv, hd)).astype(np.float32)
        v = rng.normal(size=(n_layers, s, l, n_kv, hd)).astype(np.float32)
        return q, k, v, None, None, positions
    lim = 8 if kind == "int4" else 127
    k = rng.integers(-lim, lim, size=(n_layers, s, l, n_kv, hd)).astype(np.int8)
    v = rng.integers(-lim, lim, size=(n_layers, s, l, n_kv, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, size=(n_layers, s, n_kv, l)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, size=(n_layers, s, n_kv, l)).astype(np.float32)
    return q, k, v, ks, vs, positions


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_attention_sharded_matches_jax(kind):
    """The flat core on each rank's slots (dp) and kv heads (tp), with no
    collective, equals the JAX island on a (dp=2, tp=2) mesh. Packed int4:
    the global cache packed with chunks = tp, each rank's bytes its own
    W/tp positions, which the core reads as a cache of its own."""
    tp, dp, layer = 2, 2, 1
    q, k, v, ks, vs, positions = _attention_inputs(kind)
    n_layers, s, l, n_kv, hd = k.shape
    flat_k, flat_v = k.reshape(n_layers, s, l, -1), v.reshape(n_layers, s, l, -1)
    if kind == "int4":
        flat_k = np.asarray(jllama.pack_kv_codes(jnp.asarray(flat_k), tp))
        flat_v = np.asarray(jllama.pack_kv_codes(jnp.asarray(flat_v), tp))
    mesh = jmesh.make_mesh(tp=tp, dp=dp)
    ref = np.asarray(jshard.decode_attention_sharded(
        jnp.asarray(q), jnp.asarray(flat_k), jnp.asarray(flat_v), jnp.asarray(ks[layer]),
        jnp.asarray(vs[layer]), jnp.asarray(positions), layer, mesh))
    full = interop.kv_cache_from_numpy(flat_k, flat_v, ks, vs, device="cpu")
    out = np.zeros_like(ref)
    for r in range(tp * dp):
        m = fake_mesh(tp, dp, 1, r)
        c = tshard.shard_cache(full, m)
        lo, hi = tshard.local_slots(m, s)
        hq = q.shape[1] // tp
        t = m.coords["tp"]
        ql = torch.from_numpy(q[lo:hi, t * hq:(t + 1) * hq])
        o = tshard.decode_attention_sharded(ql, c.k, c.v, c.k_scale[layer], c.v_scale[layer],
                                            torch.from_numpy(positions[lo:hi]), layer)
        out[lo:hi, t * hq:(t + 1) * hq] = to_np(o)
    np.testing.assert_allclose(out, ref, rtol=5e-2, atol=1e-2)
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("kind", ["int8", "f32"])
def test_seq_sharded_merge_matches_jax(kind):
    """Sequence parallelism: each sp shard's partial over its L window
    (seq_partial), merged by hand with the flash-decoding rule (one max, two
    sums over sp), equals the JAX island on a (dp=2, sp=2, tp=2) mesh; a
    slot whose context ends inside the first shard and an inactive slot
    included."""
    tp, dp, sp, layer = 2, 2, 2, 1
    q, k, v, ks, vs, positions = _attention_inputs(kind, hd=32, seed=11)
    positions = np.array([31, -1, 63, 7], np.int32)
    mesh = jmesh.make_mesh(tp=tp, dp=dp, sp=sp)
    ref = np.asarray(jshard.decode_attention_seq_sharded(
        jnp.asarray(q), jnp.asarray(k[layer]), jnp.asarray(v[layer]),
        None if ks is None else jnp.asarray(ks[layer]),
        None if vs is None else jnp.asarray(vs[layer]), jnp.asarray(positions), mesh))
    full = interop.kv_cache_from_numpy(k, v, ks, vs, device="cpu")
    s, hq = q.shape[0], q.shape[1] // tp
    out = np.zeros_like(ref)
    for d in range(dp):
        for t in range(tp):
            parts = []
            for j in range(sp):
                m = fake_mesh(tp, dp, sp, tmesh.coords_rank({"dp": d, "sp": j, "tp": t}, tp, dp, sp))
                c = tshard.shard_cache(full, m)
                lo, hi = tshard.local_slots(m, s)
                ql = torch.from_numpy(q[lo:hi, t * hq:(t + 1) * hq])[:, None]
                qpos = torch.from_numpy(positions[lo:hi]).long()[:, None]
                parts.append(tshard.seq_partial(
                    ql, c.k[layer], c.v[layer], None if ks is None else c.k_scale[layer],
                    None if vs is None else c.v_scale[layer], qpos, j * c.max_len))
            m_g = torch.stack([m_ for _, m_, _ in parts]).amax(0)
            w = [torch.exp(m_ - m_g) for _, m_, _ in parts]
            o = sum(o_ * w_[..., None] for (o_, _, _), w_ in zip(parts, w))
            mass = sum(s_ * w_ for (_, _, s_), w_ in zip(parts, w))
            res = tshard.seq_finish(o, mass, qpos)[:, 0]
            out[lo:hi, t * hq:(t + 1) * hq] = to_np(res)
    if kind == "f32":
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(out, ref) < 1e-2
    assert np.all(out[1] == 0.0)


@pytest.mark.parametrize("bits", [4, 8])
def test_moe_ffn_sharded_matches_jax(bits):
    """Expert parallelism: each tp rank's E/tp whole experts over every row,
    summed over tp by hand, equal the JAX island (int4 and int8 expert
    stacks through the quant-matmul per expert view)."""
    p = jllama.LlamaParams(vocab_size=64, dim=32, n_layers=1, n_heads=4, n_kv_heads=2,
                           head_dim=8, ffn_dim=32, n_experts=4, n_experts_per_tok=2)
    rng = np.random.default_rng(9)
    h = rng.normal(size=(6, 32)).astype(np.float32)
    logits = rng.normal(size=(6, 4)).astype(np.float32) * 3
    gu = jcore.quantize_experts(jnp.asarray(rng.normal(size=(4, 32, 64)) * 0.1), bits=bits,
                                group_size=16)
    dn = jcore.quantize_experts(jnp.asarray(rng.normal(size=(4, 32, 32)) * 0.1), bits=bits,
                                group_size=16)
    w_se = np.array(jllama.moe_combine_weights(jnp.asarray(logits), 4, 2))
    tp = 2
    mesh = jmesh.make_mesh(tp=tp, dp=1)
    ref = np.asarray(jshard.moe_ffn_sharded(jnp.asarray(h), jnp.asarray(w_se), gu, dn, p, mesh))
    tw = jax_to_torch_params({"layers.0/moe_gateup/kernel": gu, "layers.0/moe_down/kernel": dn})
    tp_p = tllama.LlamaParams(**{f: getattr(p, f) for f in ("vocab_size", "dim", "n_layers",
                                                             "n_heads", "n_kv_heads", "head_dim",
                                                             "ffn_dim", "n_experts",
                                                             "n_experts_per_tok")})
    out = 0
    for t in range(tp):
        local = tshard.shard_llama_params(tw, fake_mesh(tp, 1, 1, t))
        assert local["layers.0/moe_gateup/kernel"].n_experts == 2
        out = out + tshard.moe_ffn_local(torch.from_numpy(h), torch.from_numpy(w_se),
                                         local["layers.0/moe_gateup/kernel"],
                                         local["layers.0/moe_down/kernel"], tp_p, t)
    assert _rel(to_np(out), ref) < 1e-5


# ---------------------------------------------------------------- whole decode steps
P_TINY = dict(vocab_size=128, dim=32, n_layers=2, n_heads=8, n_kv_heads=4, head_dim=8,
              ffn_dim=64)


@pytest.mark.parametrize("tp,dp,sp", [(2, 2, 2), (2, 2, 1), (1, 1, 4)])
def test_decode_step_sharded_matches_jax(tp, dp, sp):
    """A whole decode_step under a live mesh, every rank a thread with its
    weight and cache blocks, against the JAX package's decode_step jitted
    over the same mesh (its test_decode_step_sp_matches_single_device's
    setting, with a cache holding context); logits of every slot, gathered
    over dp and tp, within 1e-4."""
    jp = jllama.LlamaParams(**P_TINY)
    params = jllama.init_params(jax.random.PRNGKey(1), jp, dtype=jnp.float32)
    n_slots, max_len = 4, 32
    rng = np.random.default_rng(3)
    shape = (jp.n_layers, n_slots, max_len, jp.n_kv_heads, jp.head_dim)
    k0 = rng.normal(size=shape).astype(np.float32)
    v0 = rng.normal(size=shape).astype(np.float32)
    tokens = np.array([7, 9, 0, 3], np.int32)
    positions = np.array([5, 17, -1, 30], np.int32)
    mesh = jmesh.make_mesh(tp=tp, dp=dp, sp=sp)
    sparams = jshard.shard_llama_params(params, mesh)
    jcache = jllama.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), k_scale=None, v_scale=None)
    scache = jshard.shard_cache(jcache, mesh)
    jshard.set_active_mesh(mesh)
    try:
        ref, _ = jax.jit(lambda pr, t, c, ps: jllama.decode_step(pr, jp, t, c, ps))(
            sparams, jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("dp"))),
            scache, jax.device_put(jnp.asarray(positions), NamedSharding(mesh, P("dp"))))
    finally:
        jshard.set_active_mesh(None)
    ref = np.asarray(ref)
    tparams = jax_to_torch_params(params)
    p = tllama.LlamaParams(**P_TINY)
    full = interop.kv_cache_from_numpy(k0 if sp > 1 else k0.reshape(shape[:3] + (-1,)),
                                       v0 if sp > 1 else v0.reshape(shape[:3] + (-1,)),
                                       device="cpu")

    def step(m):
        local = tshard.shard_llama_params(tparams, m)
        cache = tshard.shard_cache(full, m)
        logits, _ = tllama.decode_step(local, p, torch.from_numpy(tokens).long(), cache,
                                       torch.from_numpy(positions))
        return to_np(logits)

    outs = run_ranks(tp, dp, sp, step)
    for out in outs:
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
