"""The int4 nibble unpack in tpuserve_torch on the CPU.

(a) The microbenchmark's five kernels (ops.unpack_probes): each plain
    version against the Pallas kernel body of scripts/unpack_microbench.py
    in interpret mode, exactly (integer sums; at 128-row blocks the port's
    every-row fold is the TPU's function), and the microbenchmark
    (tpuserve_torch.scripts.unpack_microbench) run at a tiny size.
(b) TPUSERVE_INT4_UNPACK=noop in decode attention: the flat (contiguous),
    paged and multi-candidate plain versions against the JAX kernels in
    interpret mode under the same setting, at tests/test_torch_ops.py's
    tolerance, and the default ("cur") unchanged.

The knob is read when JAX traces a kernel, so each noop case clears JAX's
caches before and after it.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpuserve.ops import decode_attention as jda
from tpuserve_torch import kernels
from tpuserve_torch.ops import decode_attention as tda
from tpuserve_torch.ops import unpack_probes as up
from tpuserve_torch.scripts import unpack_microbench as tub
from torch_parity import to_np

M, W2, BLR, N = 8, 256, 128, 512   # the TPU script's kernels at a size interpret mode runs


@pytest.fixture(scope="module")
def jub(tmp_path_factory):
    """scripts/unpack_microbench.py, imported with its compilation cache
    pointed at a temporary directory and JAX's config restored after."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    saved_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path_factory.mktemp("jax_cache"))
    try:
        mod = importlib.import_module("scripts.unpack_microbench")
    finally:
        for k, val in saved.items():
            jax.config.update(k, val)
        if saved_env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved_env
    return mod


def _pallas(kern, x, q, seed):
    """The TPU script's build() call at this file's size, in interpret mode."""
    return pl.pallas_call(
        kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(N // BLR,),
            in_specs=[pl.BlockSpec((M, W2), lambda i, *_: (0, 0)),
                      pl.BlockSpec((BLR, W2), lambda i, *_: (i, 0))],
            out_specs=pl.BlockSpec((M, 128), lambda i, *_: (0, 0))),
        out_shape=jax.ShapeDtypeStruct((M, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray([seed], jnp.int32), jnp.asarray(q), jnp.asarray(x))


def _stream(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (N, W2), dtype=np.int8)
    q = rng.integers(-8, 8, (M, W2), dtype=np.int8)
    return x, q


@pytest.mark.parametrize("name", up.VARIANTS)
@pytest.mark.parametrize("data_seed", [0, 1])
@pytest.mark.parametrize("seed", [0, 2])
def test_unpack_probe_plain_matches_pallas(jub, name, data_seed, seed):
    """Each variant's plain version equals its Pallas kernel exactly: the
    TPU's f32 output holds integers below 2^24 at this size."""
    x, q = _stream(data_seed)
    ref = np.asarray(_pallas(jub.KERNELS[name], x, q, seed))
    assert np.all(ref == np.round(ref))
    before = dict(up.launches)
    out = up.PROBES[name](torch.from_numpy(x), torch.from_numpy(q), seed, BLR)
    assert out.dtype == torch.int64 and out.shape == (M, 128)
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))
    assert up.launches == before


def test_unpack_variants_agree_and_fold_every_row():
    """unpack_cur, unpack_hi and unpack_i8 are one function (b = 16*hi + lo
    exactly); at 256-row blocks every row still reaches the fold, the seed
    counts once a block, and stream_raw sums every byte."""
    x, q = (torch.from_numpy(a) for a in _stream(3))
    outs = {n: up.PROBES[n](x, q, 5, 256) for n in up.VARIANTS}
    assert torch.equal(outs["unpack_cur"], outs["unpack_hi"])
    assert torch.equal(outs["unpack_cur"], outs["unpack_i8"])
    xi, qi = x.to(torch.int64), q.to(torch.int64)
    s = qi @ xi.T                                                   # [M, N]
    lo, hi = xi & 15, xi >> 4
    s4 = qi @ lo.T + qi @ hi.T - 8 * qi.sum(1, keepdim=True)
    n_blocks = N // 256
    assert torch.equal(outs["dot_raw"], s.reshape(M, -1, 128).sum(1) + 5 * n_blocks)
    assert torch.equal(outs["unpack_cur"], s4.reshape(M, -1, 128).sum(1) + 5 * n_blocks)
    want = torch.zeros((M, 128), dtype=torch.int64)
    want[0, 0] = xi.sum() + 5 * n_blocks
    assert torch.equal(outs["stream_raw"], want)


def test_unpack_probes_refuse_bad_inputs():
    x, q = (torch.from_numpy(a) for a in _stream(0))
    with pytest.raises(ValueError, match="multiple of 128"):
        up.dot_raw(x, q, 0, 96)
    with pytest.raises(ValueError, match="int8"):
        up.dot_raw(x.to(torch.int32), q)
    with pytest.raises(ValueError, match="W2"):
        up.dot_raw(x, q[:, :128])
    with pytest.raises(ValueError, match="unknown unpack probe"):
        up.unpack_probe_plain("unpack_lut", x, q)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _fake_lib(monkeypatch, rc):
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or rc

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "check", lambda code, what: (
        None if code == 0 else (_ for _ in ()).throw(RuntimeError(f"{what}: {code}"))))
    return calls


@pytest.mark.parametrize("rc", [0, 700])
def test_unpack_cuda_tensors_launch_the_kernel_or_raise(monkeypatch, rc):
    """A CUDA tensor goes to the kernel with the variant's code and n_blocks
    * seed, or raises; the plain version never runs, and only a launch that
    returned 0 counts."""
    calls = _fake_lib(monkeypatch, rc)

    def plain_must_not_run(*a, **kw):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(up, "unpack_probe_plain", plain_must_not_run)
    x = torch.Tensor._make_subclass(_FakeCuda, torch.zeros((1024, 256), dtype=torch.int8))
    q = torch.zeros((32, 256), dtype=torch.int8)
    before = dict(up.launches)
    for i, name in enumerate(up.VARIANTS):
        if rc == 0:
            up.PROBES[name](x, q, 3, 256)
        else:
            with pytest.raises(RuntimeError):
                up.PROBES[name](x, q, 3, 256)
        # x, q, out, N, W2, M, variant, n_blocks * seed, grid, stream
        assert calls[-1][0] == "tpuserve_unpack_probe"
        assert calls[-1][1][3:9] == (1024, 256, 32, i, 4 * 3, 132)
    assert up.launches == {n: before[n] + (rc == 0) for n in up.VARIANTS}
    with pytest.raises(ValueError, match="query rows"):
        up.dot_raw(x, torch.zeros((8, 256), dtype=torch.int8))


def test_microbench_runs_every_variant_on_the_cpu(monkeypatch, capsys):
    """`unpack_microbench --device cpu` at a tiny size: a header, one timed
    line for every variant, none failed, and the tax line."""
    monkeypatch.setattr(tub, "dims", lambda: dict(M=16, W2=256, BLR=128, N_ROWS=512))
    records = tub.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# x [512, 256] int8") and "device cpu" in lines[0]
    assert [r["variant"] for r in records] == list(up.VARIANTS)
    for line, rec in zip(lines[1:-1], records):
        assert line.startswith(rec["variant"]) and " ms/pass " in line and "FAILED" not in line
        assert rec["ms"] > 0 and rec["gb_s"] > 0
    assert lines[-1].startswith("# unpack tax: ") and lines[-1].endswith("of stream rate lost)")


def test_microbench_fails_on_a_failing_variant(monkeypatch, capsys):
    monkeypatch.setattr(tub, "dims", lambda: dict(M=16, W2=64, BLR=128, N_ROWS=256))
    monkeypatch.setenv("TPUSERVE_UNPACK_MODES", "stream_raw,unpack_lut")
    with pytest.raises(SystemExit) as e:
        tub.main(["--device", "cpu"])
    assert e.value.code == 1
    assert "unpack_lut   FAILED: KeyError" in capsys.readouterr().out


def test_microbench_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        tub.main(["--device", "cuda"])


@pytest.mark.parametrize("tree_cases", [False, True])
def test_ab_probes_turn_reads_both_checkouts(monkeypatch, capsys, tree_cases):
    """One turn of scripts/ab_probes.py against a stand-in chip_smoke: the
    parent's vector-add check has no per-dtype cases (float32 only), the
    change's has one a dtype; both give the same float32 row names, and
    every unpack variant, library call, attention probe and diag_bw copy
    form is a row."""
    import json
    import sys
    import types

    from tpuserve_torch.scripts import ab_probes

    va = dict(ms=0.005, library_ms=0.0048)
    if tree_cases:
        va["cases"] = [dict(dtype="float32", ms=0.004, library_ms=0.0048),
                       dict(dtype="bfloat16", ms=0.003, library_ms=0.0031)]
    unpack = {"unpack_stream_raw": dict(ms=0.2, library_ms=1.6),
              "unpack_dot_raw": dict(ms=0.21, library_ms=0.196),
              "unpack_cur": dict(ms=0.3, library_ms=None)}
    attn = {"probe_dma_bound": dict(ms=0.049), "probe_dot_only": dict(ms=0.055)}
    copy = dict(library_ms=0.79, cases=[dict(mode="pcopy", ms=0.051),
                                        dict(mode="pdyn", ms=0.052)])
    diag = dict(records=[dict(mode="xsum", block_l=256, us=800.0),
                         dict(mode="pcopy4d", block_l=16, us=54.0)])
    fake = types.SimpleNamespace(Timer=lambda torch: None,
                                 check_vector_add=lambda torch, timer, reps: va,
                                 check_unpack_probes=lambda torch, timer, reps: unpack,
                                 check_probes=lambda torch, timer, reps: attn,
                                 check_diag_copy=lambda torch, timer, reps: copy,
                                 phase_diag_bw=lambda torch: diag)
    monkeypatch.setitem(sys.modules, "chip_smoke", fake)
    exec(ab_probes._TURN, {})
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("AB_JSON "))
    rows = json.loads(line[len("AB_JSON "):])
    assert rows["vector_add 1M float32"] == (0.004 if tree_cases else 0.005)
    assert rows["torch.add 1M float32"] == 0.0048
    assert ("vector_add 1M bfloat16" in rows) == tree_cases
    assert rows["unpack_cur x [262144, 2048]"] == 0.3
    assert rows["library beside unpack_dot_raw"] == 0.196
    assert "library beside unpack_cur" not in rows
    assert rows["probe_dot_only K, V [64, 256, 32, 128]"] == 0.055
    assert rows["probe_dma_bound K, V [64, 256, 32, 128]"] == 0.049
    assert rows["diag_copy pdyn block_l 256"] == 0.052
    assert rows["torch.sum over the views"] == 0.79
    assert rows["diag_bw pcopy4d block_l 16 (best of 3)"] == 0.054


def test_ab_probes_runs_turns_a_b_b_a(monkeypatch, tmp_path, capsys):
    """ab_probes takes two checkouts, runs A, B, B, A with its own turn and
    prints one line a case; it refuses a missing checkout argument."""
    import json

    from tpuserve_torch.scripts import ab_attention, ab_probes

    seen = []

    def fake_turn(tree, code):
        assert code is ab_probes._TURN
        seen.append(tree)
        return {"vector_add 1M float32": 0.004 if tree == "change" else 0.0057}

    monkeypatch.setattr(ab_attention, "turn", fake_turn)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        ab_probes.main(["parent"])
    assert seen == []
    ab_probes.main(["parent", "change"])
    assert seen == ["parent", "change", "change", "parent"]
    out = capsys.readouterr().out
    assert "vector_add 1M float32: A 0.0057 / 0.0057 ms, B 0.0040 / 0.0040 ms, B/A 0.702" in out
    rec = json.loads((tmp_path / "chiprun_out" / "ab_probes.json").read_text())
    assert rec["order"] == ["a", "b", "b", "a"] and len(rec["turns"]) == 4


@pytest.mark.parametrize("name", ["base", "no_unpack", "no_wgmma", "no_ldsm", "ring_only",
                                  "two_acc"])
def test_unpack_ablations_still_match_the_kernel_source(name):
    """Each cut of scripts/unpack_ablate.py applies to csrc/unpack_probes.cu
    as it is (the script runs only on the card; this keeps it in step)."""
    from tpuserve_torch.scripts import unpack_ablate

    src = unpack_ablate.patched(name)
    assert "unpack_probe_kernel" in src
    assert (name == "base") == (src == (kernels.CSRC / "unpack_probes.cu").read_text())


def test_unpack_ablate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from tpuserve_torch.scripts import unpack_ablate

    with pytest.raises(SystemExit, match="needs the card"):
        unpack_ablate.main([])


# ------------------------------------------------------------ (b) the knob
@pytest.fixture()
def knob(monkeypatch):
    """Set TPUSERVE_INT4_UNPACK for one test, with JAX retracing on both
    sides of it (the JAX package reads the knob at trace time)."""
    def set_mode(mode):
        if mode is None:
            monkeypatch.delenv("TPUSERVE_INT4_UNPACK", raising=False)
        else:
            monkeypatch.setenv("TPUSERVE_INT4_UNPACK", mode)
        jax.clear_caches()

    yield set_mode
    jax.clear_caches()


def _flat_inputs(s=4, h=4, hkv=2, l=64, n_layers=2, seed=0):
    rng = np.random.default_rng(seed)
    w = hkv * 128
    q = (rng.normal(size=(s, h, 128)) / np.sqrt(128)).astype(np.float32)
    k, v = (rng.integers(0, 256, size=(n_layers, s, l, w // 2)).astype(np.uint8)
            for _ in range(2))
    ks, vs = ((rng.uniform(0.5, 1.5, size=(s, hkv, l)) * 0.01).astype(np.float32)
              for _ in range(2))
    return q, k, v, ks, vs


def _flat_both(q, k, v, ks, vs, pos, layer, **kw):
    ref = np.asarray(jda.decode_attention_wide_cache(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(pos), layer, interpret=True, **kw))
    out = to_np(tda.decode_attention_wide_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ks),
        torch.from_numpy(vs), torch.from_numpy(pos), layer, **kw))
    return out, ref


@pytest.mark.parametrize("window,block_l", [(None, 16), (32, None)])
def test_flat_noop_matches_pallas(knob, window, block_l):
    """The flat plain version under noop against the Pallas kernel under
    noop (raw bytes for both halves, folds kept): same algorithm, f32 ulps;
    and noop changes the result, where "cur" equals the default."""
    q, k, v, ks, vs = _flat_inputs()
    win = window or k.shape[2]
    pos = np.array([5, -1, win - 1, win // 2], np.int32)
    kw = dict(window=window, block_l=block_l)
    knob("noop")
    out, ref = _flat_both(q, k, v, ks, vs, pos, 1, **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)
    knob("cur")
    cur, cur_ref = _flat_both(q, k, v, ks, vs, pos, 1, **kw)
    np.testing.assert_allclose(cur, cur_ref, rtol=1e-5, atol=2e-6)
    knob(None)
    default, _ = _flat_both(q, k, v, ks, vs, pos, 1, **kw)
    np.testing.assert_array_equal(cur, default)
    assert np.abs(out - cur).max() > 1e-3 * np.abs(cur).max()


@pytest.mark.parametrize("ps,window", [(16, None), (32, 64)])
def test_paged_noop_matches_pallas(knob, ps, window):
    """The paged plain version under noop against the paged Pallas kernel
    under noop, int4 pages."""
    rng = np.random.default_rng(ps)
    s, h, hkv, n_layers, table_pages = 4, 4, 2, 2, 4
    hp, w = 8, hkv * 128     # pad8(Hkv)
    n_pages = s * table_pages + 3
    q = (rng.normal(size=(s, h, 128)) / np.sqrt(128)).astype(np.float32)
    k, v = (rng.integers(0, 256, size=(n_layers, n_pages, ps, w // 2)).astype(np.uint8)
            for _ in range(2))
    ks, vs = ((rng.uniform(0.5, 1.5, size=(n_layers, n_pages, hp, ps)) * 0.01)
              .astype(np.float32) for _ in range(2))
    table = (1 + rng.permutation(n_pages - 1)[:s * table_pages]).reshape(
        s, table_pages).astype(np.int32)
    win = window or table_pages * ps
    pos = np.array([ps - 1, -1, ps, win - 1], np.int32)

    def both():
        ref = np.asarray(jda.decode_attention_wide_paged(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(table), jnp.asarray(pos), 1, window=window, interpret=True))
        out = to_np(tda.decode_attention_wide_paged(
            *(torch.from_numpy(a) for a in (q, k, v, ks, vs, table, pos)), 1, window=window))
        return out, ref

    knob("noop")
    out, ref = both()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
    assert np.all(out[1] == 0.0)
    knob(None)
    cur, cur_ref = both()
    np.testing.assert_allclose(cur, cur_ref, rtol=1e-5, atol=2e-6)
    assert np.abs(out - cur).max() > 1e-3 * np.abs(cur).max()


@pytest.mark.parametrize("rep,cands,block_l", [(1, 3, 32), (2, 2, 128)])
def test_multi_noop_matches_pallas(knob, rep, cands, block_l):
    """The multi-candidate plain version under noop against the Pallas
    multi kernel under noop, packed int4, active slots."""
    rng = np.random.default_rng(rep * 10 + cands)
    s, hkv, l, n_layers = 3, 2, 128, 2
    h, w = hkv * rep, hkv * 128
    q = (rng.normal(size=(s, cands, h, 128)) / np.sqrt(128)).astype(np.float32)
    k, v = (rng.integers(0, 256, size=(n_layers, s, l, w // 2)).astype(np.uint8)
            for _ in range(2))
    ks, vs = ((rng.uniform(0.5, 1.5, size=(s, hkv, l)) * 0.01).astype(np.float32)
              for _ in range(2))
    pos = np.array([5, -1, l - cands], np.int32)

    def both():
        ref = np.asarray(jda.decode_attention_wide_cache_multi(
            *(jnp.asarray(a) for a in (q, k, v, ks, vs, pos)), 1, block_l=block_l,
            interpret=True))
        out = to_np(tda.decode_attention_wide_cache_multi(
            *(torch.from_numpy(a) for a in (q, k, v, ks, vs, pos)), 1, block_l=block_l))
        return out, ref

    knob("noop")
    out, ref = both()
    np.testing.assert_allclose(out[[0, 2]], ref[[0, 2]], rtol=1e-5, atol=2e-6)
    assert np.all(out[1, 0] == 0.0)
    knob(None)
    cur, cur_ref = both()
    np.testing.assert_allclose(cur[[0, 2]], cur_ref[[0, 2]], rtol=1e-5, atol=2e-6)
    assert np.abs(out - cur).max() > 1e-3 * np.abs(cur).max()


@pytest.mark.parametrize("mode,kind", [(None, 1), ("cur", 1), ("noop", 4), ("NOOP", 1)])
def test_knob_selects_the_kernel_instance(monkeypatch, mode, kind):
    """On the card the knob picks the packed-int4 instances' launch code:
    4 (the NOOP instances) for "noop" exactly, as the JAX package compares
    it; 1 otherwise. The flat, paged and multi entries all pass it."""
    calls = _fake_lib(monkeypatch, 0)
    if mode is None:
        monkeypatch.delenv("TPUSERVE_INT4_UNPACK", raising=False)
    else:
        monkeypatch.setenv("TPUSERVE_INT4_UNPACK", mode)
    q, k, v, ks, vs = _flat_inputs()
    fq = torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(q))
    tk, tv, tks, tvs = (torch.from_numpy(a) for a in (k, v, ks, vs))
    pos = torch.zeros(4, dtype=torch.int32)
    tda.decode_attention_wide_cache(fq, tk, tv, tks, tvs, pos, 0, block_l=16)
    fq4 = torch.Tensor._make_subclass(_FakeCuda, torch.from_numpy(q[:, None].copy()))
    tda.decode_attention_wide_cache_multi(fq4, tk, tv, tks, tvs, pos, 0, block_l=16)
    pool = tk.reshape(2, 4 * 4, 16, 128)
    spool = torch.ones((2, 16, 8, 16))
    tda.decode_attention_wide_paged(fq, pool, pool, spool, spool,
                                    torch.arange(16, dtype=torch.int32).view(4, 4), pos, 0)
    # the kind argument of the Hopper core's C function, which all three take
    assert [(name, args[24]) for name, args in calls] == [
        ("tpuserve_decode_attention_core", kind)] * 3
