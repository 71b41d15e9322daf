"""The decode-attention diagnostic ladder of tpuserve_torch on the CPU: the
probes' plain versions (ops.attention_probes) against numpy definitions of
the same functions, and the sweep (tpuserve_torch.scripts.sweep_attention)
run end to end at a tiny size on the kernels' plain versions."""

import ml_dtypes
import numpy as np
import pytest
import torch

from tpuserve_torch.ops import attention_probes as probes
from tpuserve_torch.scripts import sweep_attention as sweep


def _cache(s=3, l=64, n_kv=2, seed=0):
    rng = np.random.default_rng(seed)
    k, v = (rng.integers(-128, 128, size=(s, l, n_kv, 128)).astype(np.int8) for _ in range(2))
    return k, v


@pytest.mark.parametrize("three_d", [None, False, True])
def test_colsum_probes_plain(three_d):
    """dma_bound and dma_wide (2-D, 3-D) on CPU tensors: int32 column sums
    of every 128-byte row segment of K and V, exactly."""
    k, v = _cache()
    want = (k.reshape(-1, 128).astype(np.int64).sum(0)
            + v.reshape(-1, 128).astype(np.int64).sum(0))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    before = (probes.dma_bound_launches, probes.dma_wide_launches)
    out = probes.dma_bound(tk, tv) if three_d is None else probes.dma_wide(tk, tv, three_d)
    assert out.dtype == torch.int32 and out.shape == (128,)
    np.testing.assert_array_equal(out.numpy(), want)
    assert (probes.dma_bound_launches, probes.dma_wide_launches) == before


def test_dot_only_plain():
    """dot_only on CPU tensors against its numpy definition: qi =
    clip(round(q * 64), +-127); out[s, m] = sum over all L*Hkv rows r of
    bf16(1e-6 * (qi[s, m] . k[s, r])) * v[s, r], f32 sums (the two differ
    only in the order of f32 sums: 1e-5 of the range)."""
    k, v = _cache()
    rng = np.random.default_rng(1)
    q = (rng.normal(size=(3, 4, 128)) / np.sqrt(128)).astype(np.float32)
    qi = np.clip(np.round(q * 64), -127, 127).astype(np.int8)
    tqi = probes.probe_q(torch.from_numpy(q))
    np.testing.assert_array_equal(tqi.numpy(), qi)
    kf, vf = k.reshape(3, -1, 128), v.reshape(3, -1, 128)
    d = np.einsum("smd,srd->smr", qi.astype(np.int64), kf.astype(np.int64))
    p = (d.astype(np.float32) * np.float32(1e-6)).astype(ml_dtypes.bfloat16).astype(np.float64)
    want = np.einsum("smr,srd->smd", p, vf.astype(np.float64))
    out = probes.dot_only(tqi, torch.from_numpy(k), torch.from_numpy(v)).numpy()
    assert out.dtype == np.float32 and out.shape == want.shape
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


def test_dot_only_plan_fills_the_card():
    """dot_only's blocks: two an SM in one wave of an H100's 132 SMs. At
    the sweep's shape (S=64, M=32, L*Hkv=8192) a slot's 128 tiles go to
    four blocks of 32 (256 blocks); a small call cuts a slot finer, never
    below one tile a block; M > 32 counts its query groups."""
    assert probes.dot_only_tiles_per_block(64, 32, 8192, 132) == 32
    assert probes.dot_only_tiles_per_block(64, 128, 8192, 132) == 128
    assert probes.dot_only_tiles_per_block(4, 64, 256, 132) == 1
    assert probes.dot_only_tiles_per_block(2, 8, 128, 132) == 1
    for s, m, rows in ((64, 32, 8192), (3, 4, 128), (4, 64, 8192), (1, 128, 64)):
        tpb = probes.dot_only_tiles_per_block(s, m, rows, 132)
        blocks = -(-rows // 64 // tpb) * s * -(-m // 32)
        assert 1 <= tpb <= rows // 64 and (blocks <= 264 or tpb == rows // 64)


class _FakeCuda(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_dot_only_cuda_tensors_reach_the_kernel(monkeypatch):
    """A CUDA tensor reaches the tensor-core dot_only entry once with S, M,
    the rows of a slot and the plan's tiles a block; the plain version never
    runs; a row count that is not a multiple of 64 is refused."""
    from tpuserve_torch import kernels

    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: 132)
    monkeypatch.setattr(kernels, "check", lambda code, what: None)
    monkeypatch.setattr(probes, "dot_only_plain", lambda *a: (_ for _ in ()).throw(
        AssertionError("plain version taken for a CUDA tensor")))
    fc = lambda t: torch.Tensor._make_subclass(_FakeCuda, t)
    k, v = (fc(torch.from_numpy(a)) for a in _cache(s=3, l=64, n_kv=2))
    qi = fc(torch.zeros((3, 40, 128), dtype=torch.int8))
    before = probes.dot_only_launches
    out = probes.dot_only(qi, k, v)
    assert out.shape == (3, 40, 128) and out.dtype == torch.float32
    (name, args), = calls
    assert name == "tpuserve_probe_dot_only"
    assert args[:4] == (qi.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert args[4:8] == (3, 40, 128, probes.dot_only_tiles_per_block(3, 40, 128, 132))
    assert probes.dot_only_launches == before + 1
    k2, v2 = (fc(torch.zeros((2, 32, 1, 128), dtype=torch.int8)) for _ in range(2))
    with pytest.raises(ValueError, match="multiple of 64"):
        probes.dot_only(fc(torch.zeros((2, 4, 128), dtype=torch.int8)), k2, v2)


def test_probes_refuse_bad_inputs():
    k, v = _cache()
    with pytest.raises(ValueError, match="int8"):
        probes.dma_bound(torch.from_numpy(k).float(), torch.from_numpy(v).float())
    with pytest.raises(ValueError, match="qi must be"):
        probes.dot_only(torch.zeros((3, 4, 64), dtype=torch.int8), torch.from_numpy(k),
                        torch.from_numpy(v))


def test_sweep_runs_every_variant_on_the_cpu(monkeypatch, capsys):
    """`python -m tpuserve_torch.scripts.sweep_attention --device cpu` at a
    tiny size: a header and one timed line for every variant, none failed."""
    for key, val in dict(S="2", L="64", HKV="2", REP="2", ITERS="1").items():
        monkeypatch.setenv(f"TPUSERVE_SWEEP_{key}", val)
    monkeypatch.setenv("TPUSERVE_SWEEP", ",".join(sweep.VARIANTS))
    records = sweep.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# S=2 L=64 Hkv=2 rep=2") and lines[1].startswith("# device cpu")
    assert len(lines) == 2 + len(sweep.VARIANTS)
    assert [r["variant"] for r in records] == list(sweep.VARIANTS)
    for line, rec in zip(lines[2:], records):
        assert "FAILED" not in line and " us/it " in line and line.endswith("GB/s")
        assert rec["us"] > 0 and rec["gb_s"] > 0


def test_sweep_attention_variants_agree():
    """The sweep's attention variants compute one attention over one cache:
    every grouped split gives the same values (g_kv changes no value), and
    the flat kernel (P requantized to int8) and the einsum path (bf16 dots)
    agree with them to 2e-2 of the range."""
    dims = dict(S=2, L=64, HKV=4, REP=2, ITERS=1)
    inputs = sweep.setup(dims, torch.device("cpu"))
    outs = {name: sweep._variant(name, dims, *inputs)().reshape(2, -1)
            for name in ("g1s", "g16s", "g32s_bl64", "g8s", "wide", "wide_bl128", "xla")}
    ref = outs["g1s"]
    scale = ref.abs().max().item()
    for name in ("g16s", "g8s"):
        assert (outs[name] - ref).abs().max().item() <= 1e-6 * scale, name
    for name in ("g32s_bl64", "wide", "wide_bl128", "xla"):
        assert (outs[name] - ref).abs().max().item() <= 2e-2 * scale, name


def test_sweep_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        sweep.main(["--device", "cuda"])
