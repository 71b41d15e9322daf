"""Mixture-of-Experts: tpuserve_torch's MoE path against tpuserve's, on the
CPU with seeded numpy inputs, at a tiny Mixtral-style model (2 layers, dim
64, 4 heads, 2 KV heads, head_dim 16, E = 8 or 4, top-2).

The JAX side runs its Pallas quant-matmul in interpret mode (the
`jax_kernels` fixture, as tests/test_torch_llama.py does); the port runs
the kernel's plain version. Routing is compared before values: the two
packages compute the router logits with sums in other orders, so a token
whose 2nd and 3rd logits sat within a rounding step could pick another
expert there; the routers here have wide margins, and every test asserts
that the chosen experts are equal.

Tolerances: the dense loop and the dispatch in f32 within 1e-5 relative
(the same products, f32 sums in another order); the gate values of
moe_combine_weights within 2 ulps (XLA's CPU exp is not PyTorch's); the
selection and its tie-breaking exactly; model logits within 1e-2 of their
range, as test_torch_llama.py holds the dense model (measured there: 2.2e-3
with int8 KV, 2.4e-4 with int4 KV).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.serving.engine import GenerationEngine as JEngine
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.models import llama_bench
from tpuserve_torch.quant import core as tcore
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving.engine import GenerationEngine
from torch_parity import jax_to_torch_params, to_np

TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            ffn_dim=64, n_experts=8, n_experts_per_tok=2)
P_J = jllama.LlamaParams(**TINY)
P_T = tllama.LlamaParams(**TINY)


@pytest.fixture()
def jax_kernels(monkeypatch):
    """Force the JAX package onto its Pallas quant-matmul (interpret mode)."""
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


@pytest.fixture()
def routes(monkeypatch):
    """Record every moe_combine_weights result of both packages, in call
    order: {"jax": [...], "torch": [...]} as numpy arrays."""
    seen = {"jax": [], "torch": []}
    for mod, key, conv in ((jllama, "jax", np.asarray), (tllama, "torch", to_np)):
        fn = mod.moe_combine_weights

        def rec(logits, n_experts, k, _fn=fn, _key=key, _conv=conv):
            w = _fn(logits, n_experts, k)
            seen[_key].append(_conv(w))
            return w

        monkeypatch.setattr(mod, "moe_combine_weights", rec)
    return seen


def _same_routes(seen):
    """Both packages routed every token of every call to the same experts."""
    assert len(seen["jax"]) == len(seen["torch"]) > 0
    for j, t in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(j.reshape(-1, j.shape[-1]) != 0,
                                      t.reshape(-1, t.shape[-1]) != 0)


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _knobs(monkeypatch, cf=None, decode_t=None):
    for key, val in (("TPUSERVE_MOE_CF", cf), ("TPUSERVE_MOE_DECODE_DISPATCH_T", decode_t)):
        if val is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, str(val))


def moe_weights(p: jllama.LlamaParams, seed=0):
    """Float weights of a MoE model. The head is the embedding under a
    permutation (as torch_parity.write_model makes it), so greedy margins
    are many bf16 steps wide; the router's logits have a spread of ~8, so
    the top-2 margins dwarf the packages' rounding differences."""
    rng = np.random.default_rng(seed)
    d, f, v, e_n = p.dim, p.ffn_dim, p.vocab_size, p.n_experts
    qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim

    def n(*shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    emb = n(v, d, std=1.0)
    perm = rng.permutation(v)
    w = {"embed/weight": emb, "final_norm/scale": np.ones((d,), np.float32),
         "lm_head/kernel": np.ascontiguousarray(emb[perm].T / np.sqrt(d))}
    for layer in range(p.n_layers):
        pre = f"layers.{layer}"
        w[f"{pre}/attn_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/mlp_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/wq/kernel"] = n(d, qd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wk/kernel"] = n(d, kvd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wv/kernel"] = n(d, kvd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wo/kernel"] = n(qd, d, std=1.0 / np.sqrt(qd))
        w[f"{pre}/router/kernel"] = n(d, e_n, std=1.0)
        w[f"{pre}/moe_gateup/kernel"] = n(e_n, d, 2 * f, std=1.0 / np.sqrt(d))
        w[f"{pre}/moe_down/kernel"] = n(e_n, f, d, std=1.0 / np.sqrt(f))
    return w


def _quantized(p, bits=4, group_size=32, act_bits=0, seed=0):
    """The model's weights quantized by the JAX package (experts stacked),
    and the same bytes in the port."""
    raw = jllama.fuse_params({k: jnp.asarray(v) for k, v in moe_weights(p, seed).items()}, p)
    jp = jcore.quantize_param_tree(
        raw, bits=bits, group_size=group_size, act_bits=act_bits,
        predicate=lambda name, a: a.ndim in (2, 3) and name.endswith("kernel")
        and "router" not in name)
    return jp, jax_to_torch_params(jp)


# ---------------------------------------------------------------- routing
def test_combine_weights_match_jax():
    """Top-k selection equal to jax.lax.top_k's, ties to the lower index
    (rows of all-equal logits, ties inside the top 2 and at its edge); the
    gates within 2 ulps."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(512, 8)) * 3).astype(np.float32)
    logits[:40] = 0.0
    logits[:8] = 1.0                    # all equal: experts 0 and 1
    logits[8:16, :4] = 2.0              # four equal tops: 0 and 1
    logits[16:24, 1::2] = 5.0           # 1, 3, 5, 7 tie: 1 and 3
    logits[24:32] = np.arange(8)[::-1]  # distinct, descending
    logits[32:40, 6] = 9.0              # one clear top, a tie for second
    logits[32:40, [2, 5]] = 4.0
    for k in (1, 2, 3):
        j = np.asarray(jllama.moe_combine_weights(jnp.asarray(logits), 8, k))
        t = to_np(tllama.moe_combine_weights(torch.from_numpy(logits), 8, k))
        np.testing.assert_array_equal(j != 0, t != 0)
        np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=0)
    t = to_np(tllama.moe_combine_weights(torch.from_numpy(logits), 8, 2))
    np.testing.assert_array_equal(np.nonzero(t[0])[0], [0, 1])
    np.testing.assert_array_equal(np.nonzero(t[16])[0], [1, 3])
    np.testing.assert_array_equal(np.nonzero(t[32])[0], [2, 6])
    np.testing.assert_array_equal(t[:16][t[:16] != 0], 0.5)


# ---------------------------------------------------------------- quantized experts
@pytest.mark.parametrize("bits,group_size,act_bits", [
    (4, 32, 0), (4, 0, 0), (8, 32, 0), (4, 32, 8), (8, 0, 8)])
def test_quantize_experts_match_jax(bits, group_size, act_bits):
    """quantize_experts and quantize_param_tree's 3-D branch give the JAX
    package's bytes, each expert as its own 2-D quantize; expert(e) is a
    view of the stack; W8A8 codes are K-major per expert; interop carries
    JAX's QExperts across byte for byte."""
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(3, 64, 96)) * 0.1).astype(np.float32)
    tree = {"layers.0/moe_gateup/kernel": w}
    jq = jcore.quantize_param_tree({k: jnp.asarray(v) for k, v in tree.items()}, bits=bits,
                                   group_size=group_size, act_bits=act_bits)
    tq = tcore.quantize_param_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                                   bits=bits, group_size=group_size, act_bits=act_bits)
    jq, tq = jq["layers.0/moe_gateup/kernel"], tq["layers.0/moe_gateup/kernel"]
    assert isinstance(tq, tcore.QExperts) and tq.n_experts == 3
    assert (tq.bits, tq.group_size, tq.orig_shape, tq.act_bits) == \
        (jq.bits, jq.group_size, jq.orig_shape, jq.act_bits)
    np.testing.assert_array_equal(to_np(tq.q), np.asarray(jq.q))
    np.testing.assert_array_equal(to_np(tq.scale), np.asarray(jq.scale))
    assert tq.nbytes == jq.nbytes
    for e in range(3):
        te = tq.expert(e)
        assert te.q.data_ptr() == tq.q[e].data_ptr() and te.q._base is not None
        assert te.scale.data_ptr() == tq.scale[e].data_ptr()
        assert te.orig_shape == (64, 96) and te.act_bits == act_bits
        ref = tcore.quantize(torch.from_numpy(w[e]), bits=bits, group_size=jq.group_size or 0)
        assert torch.equal(te.q, ref.q) and torch.equal(te.scale, ref.scale)
        if bits == 8 and act_bits == 8:
            assert te.q.stride() == (1, 64)
    carried = jax_to_torch_params({"x": jq})["x"]
    assert isinstance(carried, tcore.QExperts) and carried.orig_shape == (3, 64, 96)
    assert torch.equal(carried.q, tq.q) and torch.equal(carried.scale, tq.scale)
    alone = tcore.quantize_experts(torch.from_numpy(w), bits=bits, group_size=group_size)
    jalone = jcore.quantize_experts(jnp.asarray(w), bits=bits, group_size=group_size)
    np.testing.assert_array_equal(to_np(alone.q), np.asarray(jalone.q))


def test_quantize_param_tree_default_predicate():
    """The default predicate takes a 3-D stack only by a MoE/expert name
    and only where its K groups evenly, as the JAX package's does."""
    rng = np.random.default_rng(2)
    tree = {"layers.0/moe_down/kernel": rng.normal(size=(2, 64, 32)),
            "layers.0/expert_w": rng.normal(size=(2, 64, 32)),
            "layers.0/stack/kernel": rng.normal(size=(2, 64, 32)),
            "layers.0/moe_odd/kernel": rng.normal(size=(2, 80, 32)),
            "layers.0/wo/kernel": rng.normal(size=(64, 32))}
    jq = jcore.quantize_param_tree({k: jnp.asarray(v, jnp.float32) for k, v in tree.items()},
                                   bits=4, group_size=32)
    tq = tcore.quantize_param_tree({k: torch.from_numpy(v).float() for k, v in tree.items()},
                                   bits=4, group_size=32)
    kinds = {jcore.QExperts: "experts", jcore.QTensor: "tensor",
             tcore.QExperts: "experts", tcore.QTensor: "tensor"}
    for name in tree:
        assert kinds.get(type(tq[name]), "dense") == kinds.get(type(jq[name]), "dense"), name
    assert isinstance(tq["layers.0/moe_down/kernel"], tcore.QExperts)
    assert isinstance(tq["layers.0/stack/kernel"], torch.Tensor)


def test_init_quantized_params_moe():
    """The bench init makes a seeded bf16 router and stacked int4 experts
    (random codes, constant scales) on the device, and param_bytes counts
    the stacks."""
    params = llama_bench.init_quantized_params(P_T, bits=4, group_size=32, device="cpu")
    router = params["layers.1/router/kernel"]
    gu, dn = params["layers.1/moe_gateup/kernel"], params["layers.1/moe_down/kernel"]
    assert router.dtype == torch.bfloat16 and tuple(router.shape) == (64, 8)
    assert 0.015 < router.float().std().item() < 0.025
    assert isinstance(gu, tcore.QExperts) and gu.orig_shape == (8, 64, 128)
    assert tuple(gu.q.shape) == (8, 32, 128) and tuple(gu.scale.shape) == (8, 2, 128)
    assert tuple(dn.q.shape) == (8, 32, 64) and dn.group_size == 32
    assert "layers.0/w_gateup/kernel" not in params
    again = llama_bench.init_quantized_params(P_T, bits=4, group_size=32, device="cpu")
    assert torch.equal(again["layers.1/moe_gateup/kernel"].q, gu.q)
    assert llama_bench.param_bytes(params) == sum(
        v.nbytes if isinstance(v, (tcore.QTensor, tcore.QExperts))
        else v.numel() * v.element_size() for v in params.values())
    assert tllama.active_param_count(P_T) == jllama.active_param_count(P_J)
    mixtral = tllama.LlamaParams.mixtral_8x7b()
    assert tllama.active_param_count(mixtral) == jllama.active_param_count(
        jllama.LlamaParams(**dataclasses.asdict(mixtral)))


# ---------------------------------------------------------------- expert FFN
def _ffn_setup(t=24, d=16, f=32, e_n=8, k=2, seed=5, quant=None):
    """tests/test_moe.py's _setup in both packages: h [t, d], combine
    weights from random logits, stacked experts (dense f32, or quantized by
    the JAX package and carried across), and the dense reference."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    gu = (rng.normal(size=(e_n, d, 2 * f)) * 0.1).astype(np.float32)
    dn = (rng.normal(size=(e_n, f, d)) * 0.1).astype(np.float32)
    logits = rng.normal(size=(t, e_n)).astype(np.float32)
    if quant:
        bits, gs, act = quant
        jgu = jcore.quantize_experts(jnp.asarray(gu), bits=bits, group_size=gs)
        jdn = jcore.quantize_experts(jnp.asarray(dn), bits=bits, group_size=gs)
        if act:
            jgu = dataclasses.replace(jgu, act_bits=act)
            jdn = dataclasses.replace(jdn, act_bits=act)
        jw = (jgu, jdn)
        tw = tuple(jax_to_torch_params({"gu": jgu, "dn": jdn}).values())
    else:
        jw = (jnp.asarray(gu), jnp.asarray(dn))
        tw = (torch.from_numpy(gu), torch.from_numpy(dn))
    return dict(h=h, logits=logits, jw=jw, tw=tw, f=f, e_n=e_n, k=k,
                jp=jllama.LlamaParams(dim=d, ffn_dim=f, n_experts=e_n, n_experts_per_tok=k),
                tp=tllama.LlamaParams(dim=d, ffn_dim=f, n_experts=e_n, n_experts_per_tok=k))


@pytest.mark.parametrize("quant", [None, (4, 8, 0), (8, 8, 0), (4, 8, 8)],
                         ids=["f32", "int4", "int8", "w4a8"])
def test_expert_forward_matches_jax(jax_kernels, quant):
    """One expert's gated-silu FFN over all rows, every expert, dense and
    quantized (the quant-matmul's plain version against the Pallas kernel
    in interpret mode), from a view of the stack."""
    s = _ffn_setup(quant=quant)
    for e in range(s["e_n"]):
        j = jllama.expert_forward(jnp.asarray(s["h"]), jllama._expert_slice(s["jw"][0], e),
                                  jllama._expert_slice(s["jw"][1], e), s["f"])
        t = tllama.expert_forward(torch.from_numpy(s["h"]), tllama._expert_slice(s["tw"][0], e),
                                  tllama._expert_slice(s["tw"][1], e), s["f"])
        assert _rel_err(to_np(t), np.asarray(j)) <= 1e-5, e


def _dispatch(s, cap):
    jw2 = jllama.moe_combine_weights(jnp.asarray(s["logits"]), s["e_n"], s["k"])
    tw2 = tllama.moe_combine_weights(torch.from_numpy(s["logits"]), s["e_n"], s["k"])
    j = jllama._moe_dispatch(jnp.asarray(s["h"]), jw2, *s["jw"], s["jp"], cap)
    t = tllama._moe_dispatch(torch.from_numpy(s["h"]), tw2, *s["tw"], s["tp"], cap)
    return to_np(t), np.asarray(j)


@pytest.mark.parametrize("quant", [None, (4, 8, 0)], ids=["f32", "int4"])
@pytest.mark.parametrize("cap", [24, 12, 5, 1], ids=["full", "balanced", "overflow", "cap1"])
def test_dispatch_matches_jax(jax_kernels, quant, cap):
    """The static-capacity dispatch at full capacity (cap = T), at 2x the
    balanced load with no expert overflowing (this seed), and past
    capacity: at cap 5 three experts overflow (their later pairs in
    arrival order are dropped), at cap 1 most pairs are: the same pairs
    dropped, the same values within 1e-5 relative."""
    s = _ffn_setup(quant=quant)
    counts = np.bincount(np.argsort(-s["logits"], axis=1, kind="stable")[:, :2].ravel(),
                         minlength=8)
    assert (counts.max() <= cap) == (cap >= 12), counts
    t, j = _dispatch(s, cap)
    assert np.isfinite(t).all()
    assert _rel_err(t, j) <= 1e-5


def _moe_params(s, seed):
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(s["h"].shape[1], s["e_n"])).astype(np.float32)
    jparams = {"x/router/kernel": jnp.asarray(router),
               "x/moe_gateup/kernel": s["jw"][0], "x/moe_down/kernel": s["jw"][1]}
    tparams = {"x/router/kernel": torch.from_numpy(router),
               "x/moe_gateup/kernel": s["tw"][0], "x/moe_down/kernel": s["tw"][1]}
    return jparams, tparams, router


@pytest.mark.parametrize("quant", [None, (4, 8, 0), (4, 8, 8)], ids=["f32", "int4", "w4a8"])
@pytest.mark.parametrize("case", ["prefill-dense", "prefill-dispatch", "decode-64",
                                  "decode-128", "decode-cf0"])
def test_moe_ffn_matches_jax(jax_kernels, monkeypatch, routes, quant, case):
    """_moe_ffn through its routes, as tests/test_moe.py drives JAX's: 3-D
    (prefill) input under TPUSERVE_MOE_CF=0 (dense loop) and the default
    2.0 (dispatch, no expert past capacity with this seed); 2-D (decode)
    input of 64 rows at TPUSERVE_MOE_DECODE_DISPATCH_T 64 (dispatch) and
    128 (dense loop), and under CF=0. The chosen experts equal, the values
    within 1e-5 relative, and the dispatch taken exactly where the JAX
    package takes it."""
    s = _ffn_setup(quant=quant)
    jparams, tparams, router = _moe_params(s, 6 if case.startswith("prefill") else 7)
    rng = np.random.default_rng(8)
    h = rng.normal(size=(2, 12, 16) if case.startswith("prefill") else (64, 16))
    h = h.astype(np.float32)
    cf = 0 if case.endswith(("dense", "cf0")) else None
    decode_t = 128 if case == "decode-128" else (64 if case == "decode-64" else None)
    _knobs(monkeypatch, cf=cf, decode_t=decode_t)
    taken = []
    real = tllama._moe_dispatch
    monkeypatch.setattr(tllama, "_moe_dispatch",
                        lambda *a: (taken.append(a[-1]), real(*a))[1])
    # no expert past capacity (else the dispatch is a different function)
    t_rows = h.reshape(-1, 16).shape[0]
    counts = np.bincount(np.argsort(-(h.reshape(-1, 16) @ router), axis=1,
                                    kind="stable")[:, :2].ravel(), minlength=8)
    cap = max(8, int(np.ceil(t_rows * 2 / 8 * 2)))
    assert counts.max() <= cap, counts
    j = np.asarray(jllama._moe_ffn(jparams, "x", jnp.asarray(h), s["jp"]))
    t = to_np(tllama._moe_ffn(tparams, "x", torch.from_numpy(h), s["tp"]))
    _same_routes(routes)
    assert t.shape == h.shape
    assert _rel_err(t, j) <= 1e-5
    dispatched = case in ("prefill-dispatch", "decode-64")
    assert taken == ([cap] if dispatched else [])
    # the dense loop and the dispatch agree when nothing overflows
    _knobs(monkeypatch, cf=0)
    dense = to_np(tllama._moe_ffn(tparams, "x", torch.from_numpy(h), s["tp"]))
    assert _rel_err(t, dense) <= 1e-5


def test_moe_ffn_bf16_matches_jax(jax_kernels, monkeypatch, routes):
    """bf16 activations and int4 experts (the served types), dense loop and
    dispatch: within one bf16 step of the output's largest value, as the
    quant-matmul's bf16 tests hold it (bf16 rounds at other points in the
    two frameworks; measured here: 4.3e-8 of it)."""
    s = _ffn_setup(quant=(4, 8, 0))
    jparams, tparams, _ = _moe_params(s, 7)
    h = np.random.default_rng(9).normal(size=(64, 16)).astype(np.float32)
    hj, ht = jnp.asarray(h, jnp.bfloat16), torch.from_numpy(h).to(torch.bfloat16)
    for decode_t in (64, 128):
        _knobs(monkeypatch, decode_t=decode_t)
        j = np.asarray(jllama._moe_ffn(jparams, "x", hj, s["jp"]).astype(jnp.float32))
        t = to_np(tllama._moe_ffn(tparams, "x", ht, s["tp"]))
        assert _rel_err(t, j) <= 2 ** -8, decode_t
    _same_routes(routes)


def test_moe_ffn_every_expert_every_call(monkeypatch):
    """Whatever the routing, a call runs every expert (2 quant-matmuls
    each), dense loop and dispatch alike, even where no token routes to an
    expert: the kernels a call launches never depend on the data."""
    s = _ffn_setup(quant=(4, 8, 0))
    _, tparams, _ = _moe_params(s, 7)
    tparams["x/router/kernel"] = torch.zeros((16, 8))
    tparams["x/router/kernel"][:, 0] = 1.0          # every token to experts 0 and 1
    h = torch.from_numpy(np.abs(np.random.default_rng(3).normal(size=(64, 16))).astype(
        np.float32))
    calls = []
    real = tllama.qmatmul
    monkeypatch.setattr(tllama, "qmatmul", lambda x, qt: (calls.append(x.shape[0]),
                                                          real(x, qt))[1])
    for decode_t in (64, 128):
        _knobs(monkeypatch, decode_t=decode_t)
        calls.clear()
        out = tllama._moe_ffn(tparams, "x", h, s["tp"])
        assert torch.isfinite(out).all()
        assert len(calls) == 2 * 8
        assert set(calls) == ({32} if decode_t == 64 else {64})


# ---------------------------------------------------------------- the model
def _window(end, max_len):
    window = 16
    while window < min(end, max_len):
        window *= 2
    return window


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefill_chunk_decode_match_jax(jax_kernels, monkeypatch, routes, kv_bits):
    """The tiny MoE (int4 g32 experts): a prompt in chunks of 16 and
    whole-prompt prefills into buckets of 16 (3-D: dispatch at cap 8), then
    decode steps over 10 slots, all live, so both packages
    put the same tokens through the capacity: first under the default
    knobs (2-D at T = 10 < 64: the dense loop), then at
    TPUSERVE_MOE_DECODE_DISPATCH_T=10 (dispatch at cap 8). Logits close,
    greedy tokens equal, every call routed alike."""
    jp, tp = _quantized(P_J)
    slots, max_len = 10, 64
    jc = jllama.KVCache.create(P_J, slots, max_len, quantized=True, flat=True, kv_bits=kv_bits)
    tc = tllama.KVCache.create(P_T, slots, max_len, quantized=True, kv_bits=kv_bits,
                               device="cpu")
    rng = np.random.default_rng(7)
    lens = rng.integers(3, 16, slots)
    lens[0] = 37
    taken = []
    real = tllama._moe_dispatch
    monkeypatch.setattr(tllama, "_moe_dispatch",
                        lambda *a: (taken.append(a[-1]), real(*a))[1])

    def close(t, j, what):
        tol = 1e-2 * float(np.abs(j).max())
        assert float(np.abs(t - j).max()) <= tol, what

    toks = np.zeros(slots, np.int32)
    for slot in range(slots):
        prompt = rng.integers(0, P_J.vocab_size, lens[slot])
        if slot == 0:  # in chunks of 16
            for c0 in range(0, lens[slot], 16):
                n = min(16, lens[slot] - c0)
                ct = np.zeros((1, 16), np.int32)
                ct[0, :n] = prompt[c0:c0 + n]
                w = _window(c0 + 16, max_len)
                jl, jc = jllama.prefill_chunk(jp, P_J, jnp.asarray(ct), jc, jnp.int32(slot),
                                              jnp.int32(c0), jnp.int32(n), window=w)
                tl, tc = tllama.prefill_chunk(tp, P_T, torch.from_numpy(ct).long(), tc, slot,
                                              c0, n, window=w)
        else:          # whole-prompt prefill into a power-of-two bucket
            pt = np.zeros((1, _window(lens[slot], max_len)), np.int32)
            pt[0, :lens[slot]] = prompt
            jl, jc = jllama.prefill(jp, P_J, jnp.asarray(pt), jc, jnp.int32(slot),
                                    jnp.int32(lens[slot]))
            tl, tc = tllama.prefill(tp, P_T, torch.from_numpy(pt).long(), tc, slot,
                                    int(lens[slot]))
        close(to_np(tl), np.asarray(jl), f"prefill slot {slot}")
        toks[slot] = int(np.argmax(np.asarray(jl)[0]))
        assert int(torch.argmax(tl[0])) == toks[slot]
    assert set(taken) == {8}
    pos = lens.astype(np.int32)
    jt, tt = toks.copy(), toks.copy()
    for step in range(3):
        if step == 1:
            _knobs(monkeypatch, decode_t=slots)
        taken.clear()
        jl, jc = jllama.decode_step(jp, P_J, jnp.asarray(jt), jc, jnp.asarray(pos))
        tl, tc = tllama.decode_step(tp, P_T, torch.from_numpy(tt).long(), tc,
                                    torch.from_numpy(pos))
        jl, tl = np.asarray(jl), to_np(tl)
        close(tl, jl, f"decode step {step}")
        assert taken == ([8] * P_T.n_layers if step >= 1 else [])
        jt = np.argmax(jl, axis=-1).astype(np.int32)
        tt = np.argmax(tl, axis=-1).astype(np.int32)
        np.testing.assert_array_equal(tt, jt)
        pos = pos + 1
    _same_routes(routes)


# ---------------------------------------------------------------- the engine
def _moe_config(name):
    return {
        "name": name, "platform": "llm", "architecture": "mixtral",
        "model_params": dict(TINY),
        "quantization": {"weights": "int4", "group_size": 32, "kv_cache": "int4"},
        "generation": dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=6,
                           prefill_chunk=16, decode_horizon=2),
    }


def write_moe_model(root, name, cfg, seed=0):
    from safetensors.numpy import save_file

    vdir = os.path.join(root, name, "1")
    os.makedirs(vdir)
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    save_file(moe_weights(P_J, seed), os.path.join(vdir, "model.safetensors"))
    return vdir


def test_engine_greedy_tokens_match_jax(tmp_path, jax_kernels):
    """Both engines serve one MoE checkpoint (bf16 weights quantized at
    load: int4 g32 experts, bf16 router; packed int4 KV): greedy tokens
    equal for concurrent requests, one of them admitted in chunks (3-D
    chunks of 16: dispatch at cap 8)."""
    cfg = _moe_config("moe")
    vdir = write_moe_model(str(tmp_path), "moe", cfg)
    prompts = [[5, 17, 100, 42, 7], list(range(30, 70)), [3, 1, 4, 1, 5, 9, 2, 6]]

    def run(engine, check=lambda engine: None):
        engine.start()
        try:
            check(engine)
            reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
            out = []
            for r in reqs:
                assert r.done.wait(timeout=300)
                assert r.error is None, r.error
                out.append(list(r.output_ids))
            return out
        finally:
            engine.stop()

    def loaded(engine):
        assert isinstance(engine.params["layers.0/moe_gateup/kernel"], tcore.QExperts)
        assert engine.params["layers.0/router/kernel"].dtype == torch.bfloat16
        assert engine.memory_usage_bytes() > llama_bench.param_bytes(engine.params) > 0

    ref = run(JEngine(vdir, JModelConfig.from_dict(cfg)))
    out = run(GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu"), loaded)
    assert all(len(o) == 6 for o in out)
    assert out == ref


# ---------------------------------------------------------------- the A/B script
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ab_moe_decode_runs_on_cpu(monkeypatch, capsys, dtype):
    """tpuserve_torch.scripts.ab_moe_decode (the port of
    scripts/ab_moe_decode.py) end to end at a tiny width with --device cpu:
    both modes at batch sizes 8 and 64, their outputs close, a line each;
    --device cuda without a card refuses."""
    from tpuserve_torch.scripts import ab_moe_decode

    for key, val in (("DIM", "64"), ("FFN", "32"), ("ROUNDS", "1"), ("DEPTHS", "1,2"),
                     ("DTYPE", dtype)):
        monkeypatch.setenv(f"TPUSERVE_AB_MOE_{key}", val)
    records = ab_moe_decode.main(["--device", "cpu"])
    assert [r["bs"] for r in records] == [8, 64]
    assert all("failed" not in r and r["max_abs_diff"] < 0.05 for r in records)
    out = capsys.readouterr().out
    assert "bs=8: dense" in out and "bs=64: dense" in out and "host clock" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        ab_moe_decode.main(["--device", "cuda"])
