"""Calibrated quantization in the port against the JAX package, on the CPU.

The same numpy inputs, from a seed, go through tpuserve.quant.gptq and
tpuserve_torch.quant.gptq (GPTQ with act-order, LoRC factors, the layer-by-
layer collection), through both packages' `_mm` with LoRC, `Llama.apply`
and engines loading one GPTQ+LoRC checkpoint. Where the JAX side reaches
the quant-matmul's Pallas kernel it runs in interpret mode; the port runs
the kernel's plain version. (The synthetic generator and the accuracy
script: tests/test_torch_eval_accuracy.py.)

Tolerances: gptq_quantize is float64 in both packages in the same order,
so codes and scales agree exactly here (held to >= 99.9% of codes and 1e-6
relative). LoRC factors are rounded to bf16, and the SVD's signs are
arbitrary, so A @ B is compared, within the bf16 rounding of A and B. The
collection runs each layer's f32 forward in two packages whose f32 sums
differ in order, so later layers' Hessians differ in their last bits.
"""


import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.quant import gptq as jgptq
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.serving.engine import GenerationEngine as JEngine
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.quant import core as tcore
from tpuserve_torch.quant import gptq as tgptq
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.scripts import eval_accuracy as teval
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, jax_to_torch_params, numpy_weights, write_model

_CFG_KEYS = teval._CFG_KEYS

P_J = jllama.LlamaParams(**SMALL)
P_T = tllama.LlamaParams(**SMALL)


@pytest.fixture(autouse=True)
def _one_thread():
    """GPTQ's row loop issues thousands of small torch ops, and the JAX
    package's thousands of small numpy ones. With other test workers on the
    same cores, torch's intra-op pool and numpy's BLAS threads spend them
    waiting for their threads (a GPTQ load on the CPU ran 240x slower with
    six workers), so these tests run both on one thread."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture()
def jax_kernels(monkeypatch):
    """The JAX package's quant-matmul on its Pallas kernel (interpret mode)."""
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


def _problem(seed=0, k=256, n=64, t=512):
    """tests/test_gptq.py's problem: a weight and correlated activations."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    mixer = rng.normal(size=(k, k)) * 0.1 + np.eye(k)
    x = rng.normal(size=(t, k)) @ mixer
    return w, x, x.T @ x


def _codes_j(qt) -> np.ndarray:
    return np.asarray(jcore.unpack_int4(qt.q, qt.group_size) if qt.bits == 4 else qt.q)


def _codes_t(qt) -> np.ndarray:
    return (tcore.unpack_int4(qt.q, qt.group_size) if qt.bits == 4 else qt.q).cpu().numpy()


def _werr(w, dq, h) -> float:
    """The calibration-weighted error tr(E^T H E), E = W - dq(Q)."""
    e = np.asarray(w, np.float64) - np.asarray(dq, np.float64)
    return float(np.trace(e.T @ h @ e))


def _assert_qt_match(tq, jq, scale_rtol=1e-6, what=""):
    assert isinstance(tq, tcore.QTensor), what
    assert (tq.bits, tq.group_size, tuple(tq.orig_shape)) == \
        (jq.bits, jq.group_size, tuple(jq.orig_shape)), what
    assert tuple(tq.q.shape) == tuple(jq.q.shape) and tq.q.dtype == {
        4: torch.uint8, 8: torch.int8}[jq.bits], what
    same = (_codes_t(tq) == _codes_j(jq)).mean()
    assert same >= 0.999, f"{what}: {same:.5f} of codes equal"
    np.testing.assert_allclose(tq.scale.cpu().numpy(), np.asarray(jq.scale),
                               rtol=scale_rtol, err_msg=what)


# ------------------------------------------------------------------ gptq_quantize
@pytest.mark.parametrize("bits,gs,act_order,case", [
    (bits, gs, ao, "plain") for bits in (4, 8) for gs in (64, 128, 0) for ao in (True, False)
] + [(4, 128, True, "dead"), (8, 0, False, "dead"), (4, 64, True, "few"), (8, 128, False, "few")])
def test_gptq_quantize_matches_jax(bits, gs, act_order, case):
    """Codes, scales and the weighted error of the port's GPTQ against the
    JAX package's on one problem: every group layout, act-order on and off,
    inputs never activated (frozen to 0) and fewer samples than K (the
    damping toward the diagonal)."""
    w, x, h = _problem()
    n_samples = None
    if case == "dead":
        x[:, [3, 100, 200]] = 0.0
        h = x.T @ x
    elif case == "few":
        n_samples = 96
    jq = jgptq.gptq_quantize(w, h, bits=bits, group_size=gs, act_order=act_order,
                             n_samples=n_samples)
    tq = tgptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), bits=bits,
                             group_size=gs, act_order=act_order, n_samples=n_samples)
    _assert_qt_match(tq, jq)
    ej = _werr(w, jcore.dequantize(jq), h)
    et = _werr(w, tcore.dequantize(tq).numpy(), h)
    assert abs(et - ej) <= 1e-6 * ej, (et, ej)
    if case == "dead":
        assert np.abs(tcore.dequantize(tq).numpy()[[3, 100, 200]]).max() == 0.0


@pytest.mark.parametrize("bits,gs", [(4, 64), (4, 0), (8, 128)])
def test_gptq_identity_hessian_equals_rtn(bits, gs):
    """H = I: no error propagates, so GPTQ is the port's own clip-search
    RTN (codes equal, scales within f32 rounding: GPTQ searches in f64)."""
    w, _, _ = _problem()
    tq = tgptq.gptq_quantize(torch.from_numpy(w), torch.eye(w.shape[0], dtype=torch.float64) * 512.0,
                             bits=bits, group_size=gs)
    rq = tcore.quantize(torch.from_numpy(w), bits=bits, group_size=gs, clip_search=bits == 4)
    assert torch.equal(tq.q, rq.q)
    np.testing.assert_allclose(tq.scale.numpy(), rq.scale.numpy(), rtol=1e-5)


def test_gptq_refuses_bad_shapes():
    with pytest.raises(ValueError, match="2-D"):
        tgptq.gptq_quantize(torch.zeros(4, 4, 4), torch.eye(4))
    with pytest.raises(ValueError, match="Hessian shape"):
        tgptq.gptq_quantize(torch.zeros(8, 4), torch.eye(4))


# ------------------------------------------------------------------ lorc_factors
def _ab(a, b) -> np.ndarray:
    return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


def _ab_t(a, b) -> np.ndarray:
    return a.to(torch.float64).numpy() @ b.to(torch.float64).numpy()


@pytest.mark.parametrize("r", [4, 16])
def test_lorc_factors_match_jax(r):
    """A @ B of the port's LoRC against the JAX package's: within f32
    rounding when both keep f32 factors, within the bf16 rounding of A and
    B by default; and the correction lowers the weighted residual."""
    rng = np.random.default_rng(7)
    k, n = 256, 128
    w = rng.normal(0, 0.02, (k, n)).astype(np.float32)
    x = rng.normal(0, 1.0, (1024, k))
    x[:, rng.choice(k, 4, replace=False)] *= 10.0
    h = x.T @ x
    jq = jgptq.gptq_quantize(w, h, bits=4, group_size=128)
    tq = tgptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(h), bits=4, group_size=128)
    _assert_qt_match(tq, jq)
    ja, jb = jgptq.lorc_factors(w, jq, h, r, dtype=jnp.float32)
    ta, tb = tgptq.lorc_factors(torch.from_numpy(w), tq, torch.from_numpy(h), r,
                                dtype=torch.float32)
    assert tuple(ta.shape) == (k, r) and tuple(tb.shape) == (r, n)
    ref = _ab(ja, jb)
    np.testing.assert_allclose(_ab_t(ta, tb), ref, atol=1e-5 * np.abs(ref).max())
    ja, jb = jgptq.lorc_factors(w, jq, h, r)
    ta, tb = tgptq.lorc_factors(torch.from_numpy(w), tq, torch.from_numpy(h), r)
    assert ta.dtype == torch.bfloat16 and tb.dtype == torch.bfloat16
    # each factor within half a bf16 step of its exact value: |dAB| <=
    # 2 * 2^-8 * (|A| @ |B|) between two such roundings, plus the f32 gap
    bound = 2 * 2.0 ** -8 * (np.abs(np.asarray(ja, np.float64)) @ np.abs(np.asarray(jb, np.float64)))
    diff = np.abs(_ab_t(ta, tb) - _ab(ja, jb))
    assert (diff <= bound + 1e-5 * np.abs(ref).max()).all()
    resid = w - tcore.dequantize(tq).numpy()
    assert _werr(resid, _ab_t(ta, tb), h) < 0.6 * _werr(resid, 0.0, h)


# ------------------------------------------------------------------ collection
def _moe_weights(seed=3):
    """SMALL with two experts (top-2: every token reaches both, so no
    routing decision depends on rounding)."""
    rng = np.random.default_rng(seed)
    w = {k: v for k, v in numpy_weights(seed).items()
         if not k.split("/")[-2].startswith("w_")}
    d, f = SMALL["dim"], SMALL["ffn_dim"]
    for l in range(SMALL["n_layers"]):
        pre = f"layers.{l}"
        w[f"{pre}/router/kernel"] = rng.normal(size=(d, 2)).astype(np.float32)
        w[f"{pre}/moe_gateup/kernel"] = (rng.normal(size=(2, d, 2 * f)) / np.sqrt(d)).astype(np.float32)
        w[f"{pre}/moe_down/kernel"] = (rng.normal(size=(2, f, d)) / np.sqrt(f)).astype(np.float32)
    return w


def _lorc_standin(jax_side: bool):
    """A LoRC stand-in defined by the weight and its codes alone: A = the
    f32 residual's first r columns, B = the first r rows of I, both bf16.
    The SVD behind the real factors picks the top r directions of a
    residual that is close to white noise, whose leading singular values
    lie within a part in 10^3 of each other; one code that rounds the other
    way (f32 sums in another order) then rotates them by tens of percent,
    and the later layers' inputs part. The stand-in keeps the two
    collections on one path, so the test holds what collect does with the
    factors; `test_lorc_factors_match_jax` holds the factors themselves."""
    def fn(w, qt, h, r, dtype=None):
        if jax_side:
            resid = np.asarray(w, np.float32) - np.asarray(jcore.dequantize(qt))
            n = resid.shape[1]
            return (jnp.asarray(resid[:, :r], jnp.bfloat16),
                    jnp.asarray(np.eye(r, n, dtype=np.float32), jnp.bfloat16))
        resid = w.to(torch.float32) - tcore.dequantize(qt)
        return (resid[:, :r].to(torch.bfloat16),
                torch.eye(r, resid.shape[1]).to(torch.bfloat16))
    return fn


@pytest.mark.parametrize("fused,lowrank_r,act_scale,moe", [
    (True, 0, False, False), (True, 8, False, False), (False, 0, True, False),
    (True, 8, True, False), (True, 0, False, True)],
    ids=["fused", "fused-lorc8", "split-act_scale", "fused-lorc8-act_scale", "moe"])
def test_collect_and_quantize_llama_matches_jax(monkeypatch, fused, lowrank_r, act_scale, moe):
    """The layer-by-layer collection on SMALL (f32 weights, 256 calibration
    tokens: fewer than K, so the damping engages): every quantized kernel's
    codes and scales, the stored LoRC factors (the stand-in's, see
    _lorc_standin) and the folded norm scales against the JAX package's.
    A MoE model's expert stacks and routers come back untouched."""
    monkeypatch.setattr(jgptq, "lorc_factors", _lorc_standin(True))
    monkeypatch.setattr(tgptq, "lorc_factors", _lorc_standin(False))
    jp_c = dict(SMALL, n_experts=2, n_experts_per_tok=2) if moe else SMALL
    pj, pt = jllama.LlamaParams(**jp_c), tllama.LlamaParams(**jp_c)
    w = _moe_weights() if moe else numpy_weights(seed=2)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    if fused:
        jw, tw = jllama.fuse_params(jw, pj), tllama.fuse_params(tw, pt)
    calib = np.random.default_rng(5).integers(0, SMALL["vocab_size"], (8, 32)).astype(np.int32)
    kw = dict(bits=4, group_size=128, lowrank_r=lowrank_r, act_scale=act_scale)
    jo = jgptq.collect_and_quantize_llama(jw, pj, calib, **kw)
    seen = []
    timings = []
    to = tgptq.collect_and_quantize_llama(tw, pt, torch.from_numpy(calib), progress=seen.append,
                                          timings=timings, **kw)
    assert set(to) == set(jo)
    n_q = sum(isinstance(v, jcore.QTensor) for v in jo.values())
    assert len(seen) == n_q and seen[-1] == "lm_head/kernel"
    assert [t["layer"] for t in timings] == [f"layers.{l}" for l in range(pt.n_layers)] + ["lm_head"]
    assert sum(k.endswith("@lorc_a") for k in to) == (n_q if lowrank_r else 0)
    for name, jv in jo.items():
        tv = to[name]
        if isinstance(jv, jcore.QTensor):
            _assert_qt_match(tv, jv, scale_rtol=1e-5, what=name)
        else:
            # a bf16 factor within one bf16 step (its f32 source differs in
            # the last bits), the rest within f32 rounding
            rtol = 2.0 ** -7 if tv.dtype == torch.bfloat16 else 1e-5
            assert not isinstance(tv, tcore.QTensor), name
            np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32),
                                       rtol=rtol, atol=1e-7, err_msg=name)
    if act_scale:
        assert not np.allclose(np.asarray(jo["final_norm/scale"]), 1.0)
    if moe:
        for name in w:
            if "moe_" in name or "router" in name:
                assert torch.equal(to[name], tw[name]), name


def test_collect_lorc_first_factors_match_jax_and_help():
    """The real LoRC in the collection: the first factorization (layer 0's
    wqkv, the same inputs in both packages) gives A @ B within 2^-6 of its
    range of the JAX package's; and the rank-8 correction moves the
    whole-sequence logits toward the f32 model's (the JAX package's own
    serving-path check)."""
    w = numpy_weights(seed=2)
    jw = jllama.fuse_params({k: jnp.asarray(v) for k, v in w.items()}, P_J)
    tw = tllama.fuse_params({k: torch.from_numpy(v.copy()) for k, v in w.items()}, P_T)
    calib = np.random.default_rng(5).integers(0, SMALL["vocab_size"], (16, 32)).astype(np.int32)
    jo = jgptq.collect_and_quantize_llama(jw, P_J, calib, bits=4, group_size=128, lowrank_r=8)
    t0 = tgptq.collect_and_quantize_llama(tw, P_T, calib, bits=4, group_size=128)
    t8 = tgptq.collect_and_quantize_llama(tw, P_T, calib, bits=4, group_size=128, lowrank_r=8)
    name = "layers.0/wqkv/kernel"
    _assert_qt_match(t8[name], jo[name])
    ref = _ab(jo[f"{name}@lorc_a"], jo[f"{name}@lorc_b"])
    diff = np.abs(_ab_t(t8[f"{name}@lorc_a"], t8[f"{name}@lorc_b"]) - ref)
    assert diff.max() <= 2.0 ** -6 * np.abs(ref).max()
    arch = tllama.Llama({k: getattr(P_T, k) for k in _CFG_KEYS}, device="cpu")
    toks = np.random.default_rng(1).integers(0, SMALL["vocab_size"], (2, 16))
    lg = {k: arch.apply(v, {"input_ids": toks})["logits"] for k, v in
          (("fp", tw), ("r0", t0), ("r8", t8))}
    assert (lg["r8"] - lg["fp"]).abs().mean() < (lg["r0"] - lg["fp"]).abs().mean()


# ------------------------------------------------------------------ serving path
def _lorc_weight(seed=11, k=256, n=512, r=16):
    rng = np.random.default_rng(seed)
    wt = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    jq = jcore.quantize(jnp.asarray(wt), bits=4, group_size=128)
    a = (rng.normal(size=(k, r)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(r, n)) * 0.1).astype(np.float32)
    jparams = {"w/kernel": jq, "w/kernel@lorc_a": jnp.asarray(a, jnp.bfloat16),
               "w/kernel@lorc_b": jnp.asarray(b, jnp.bfloat16),
               "d/kernel": jnp.asarray(wt, jnp.bfloat16),
               "d/kernel@lorc_a": jnp.asarray(a, jnp.bfloat16),
               "d/kernel@lorc_b": jnp.asarray(b, jnp.bfloat16)}
    return jparams, jax_to_torch_params(jparams)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mm_lorc_matches_jax(jax_kernels, dtype):
    """`_mm` adds (x @ A) @ B to a QTensor's product (the quant-matmul's
    plain version here, its Pallas kernel in interpret mode there) and
    never to a dense weight's; `_mm_direct` adds it to both. bf16 x (the
    serving path) within one bf16 step of the output; f32 x (GPTQ's
    calibration pass) within f32 rounding."""
    jparams, tparams = _lorc_weight()
    x = np.random.default_rng(1).normal(size=(8, 256)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for jfn, tfn in ((jllama._mm, tllama._mm), (jllama._mm_direct, tllama._mm_direct)):
        for name in ("w/kernel", "d/kernel"):
            ref = np.asarray(jfn(jparams, name, jx), np.float32)
            out = tfn(tparams, name, tx)
            assert out.dtype == tx.dtype
            out = out.float().numpy()
            if dtype == "bfloat16":
                np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=2.0 ** -7 * 1e-2)
            else:
                np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    plain = tllama._mm_w(tx, tparams["d/kernel"])
    assert torch.equal(tllama._mm(tparams, "d/kernel", tx), plain)
    assert not torch.equal(tllama._mm_direct(tparams, "d/kernel", tx), plain)
    qt = tllama._mm_w(tx, tparams["w/kernel"])
    assert not torch.equal(tllama._mm(tparams, "w/kernel", tx), qt)


def _jax_arch(p):
    arch = jllama.Llama.__new__(jllama.Llama)
    arch.params_cfg = {k: getattr(p, k) for k in _CFG_KEYS}
    return arch


def test_llama_apply_matches_jax():
    """Whole-sequence logits of `Llama.apply` against the JAX package's,
    on SMALL's f32 weights and on an int4 tree with rank-8 LoRC factors on
    every kernel (carried across by interop), f32 activations throughout
    (the JAX side's quant-matmul dequantizes in XLA on the CPU). LoRC rounds
    x and x @ A to bf16, where f32 sums in another order can tip a value by
    one bf16 step: within 5e-4 of the logit range (measured 1e-4)."""
    w = numpy_weights(seed=4)
    jw = jllama.fuse_params({k: jnp.asarray(v) for k, v in w.items()}, P_J)
    jq = jcore.quantize_param_tree(jw, bits=4, group_size=128,
                                   predicate=lambda n, a: a.ndim == 2 and n.endswith("kernel"))
    rng = np.random.default_rng(6)
    for name in [n for n, v in jq.items() if isinstance(v, jcore.QTensor)]:
        k, n = jq[name].orig_shape
        jq[f"{name}@lorc_a"] = jnp.asarray(rng.normal(size=(k, 8)) * 0.05, jnp.bfloat16)
        jq[f"{name}@lorc_b"] = jnp.asarray(rng.normal(size=(8, n)) * 0.05, jnp.bfloat16)
    toks = np.random.default_rng(8).integers(0, SMALL["vocab_size"], (2, 12)).astype(np.int32)
    arch = tllama.Llama({k: getattr(P_T, k) for k in _CFG_KEYS}, device="cpu")
    for jparams in (jw, jq):
        ref = np.asarray(_jax_arch(P_J).apply(jparams, {"input_ids": jnp.asarray(toks)})["logits"])
        out = arch.apply(jax_to_torch_params(jparams), {"input_ids": toks})["logits"]
        assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=5e-4 * np.abs(ref).max())
    assert arch.quant_predicate("layers.0/wqkv/kernel", torch.zeros(2, 2))
    assert arch.quant_predicate("layers.0/moe_down/kernel", torch.zeros(2, 2, 2))
    assert not arch.quant_predicate("layers.0/router/kernel", torch.zeros(2, 2))
    assert not arch.quant_predicate("final_norm/scale", torch.zeros(2))


def test_engine_gptq_lorc_greedy_tokens_match_jax(tmp_path, monkeypatch):
    """Both engines load one checkpoint with `method: gptq` and
    `lowrank_correction: 16` (each calibrates on the same synthetic tokens
    and quantizes at load) and serve it: token-identical greedy outputs.
    The JAX engine runs its Pallas kernels in interpret mode."""
    cfg = {"name": "gptq", "platform": "llm", "architecture": "llama",
           "model_params": dict(SMALL),
           "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int4",
                            "method": "gptq", "lowrank_correction": 16},
           "generation": dict(max_seq_len=32, max_slots=2, eos_token_id=-1, max_new_tokens=4,
                              decode_horizon=2)}
    vdir = write_model(str(tmp_path), "gptq", cfg)
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
    prompts = [[5, 17, 100, 42, 7], [3, 1, 4, 1, 5, 9, 2, 6]]  # one prefill bucket

    def run(engine):
        engine.start()
        try:
            reqs = [engine.submit(p, max_new_tokens=4) for p in prompts]
            for r in reqs:
                r.done.wait(timeout=300)
                assert r.error is None, r.error
            return [list(r.output_ids) for r in reqs], set(engine.params)
        finally:
            engine.stop()

    ref, jnames = run(JEngine(vdir, JModelConfig.from_dict(cfg)))
    teng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    out, tnames = run(teng)
    assert out == ref and all(len(o) == 4 for o in out)
    assert tnames == jnames
    assert sum(n.endswith("@lorc_a") for n in tnames) == 4 * P_T.n_layers + 1
    assert [t["layer"] for t in teng.gptq_timings][-1] == "lm_head"


def test_engine_calibration_file(tmp_path):
    """quantization.calibration names an int32 [B, L] .npy in the version
    directory: the engine calibrates on it (one timing a layer and one for
    lm_head); a file of another rank is refused with the JAX engine's
    error."""
    cfg = {"name": "calib", "platform": "llm", "architecture": "llama",
           "model_params": dict(SMALL),
           "quantization": {"weights": "int4", "group_size": 128, "method": "gptq",
                            "calibration": "calib.npy"},
           "generation": dict(max_seq_len=32, max_slots=1, eos_token_id=-1, max_new_tokens=2)}
    vdir = write_model(str(tmp_path), "calib", cfg)
    tokens = np.random.default_rng(3).integers(0, SMALL["vocab_size"], (4, 16))
    np.save(os.path.join(vdir, "calib.npy"), tokens.astype(np.int32))
    engine = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    engine.start()
    try:
        assert [t["layer"] for t in engine.gptq_timings] == ["layers.0", "layers.1", "lm_head"]
        assert isinstance(engine.params["lm_head/kernel"], tcore.QTensor)
        assert not any("@lorc" in k for k in engine.params)
    finally:
        engine.stop()
    np.save(os.path.join(vdir, "calib.npy"), tokens.reshape(-1).astype(np.int32))
    engine = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match=r"must be int32 \[B, L\]"):
        engine.start()
