"""The HBM bandwidth probes of tpuserve_torch on the CPU: diag_copy's plain
version (ops.attention_probes; scripts/diag_bw.py::copy_kernel in its
modes pcopy, pcopy4d and pdyn) against numpy definitions of the column
sums each form reads, its refusals, and the script
(tpuserve_torch.scripts.diag_bw) run end to end at a tiny size.

copy_kernel is a closure inside the JAX script's main(), so it cannot be
imported; numpy stands in for it, as tests/test_torch_sweep.py does for
the sweep's probes."""

import numpy as np
import pytest
import torch

from tpuserve_torch import kernels
from tpuserve_torch.ops import attention_probes as probes
from tpuserve_torch.scripts import diag_bw


def _cache(s, l, n_kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-127, 127, size=(s, l, n_kv, hd)).astype(np.int8)
                 for _ in range(2))


def _want(k, v, block_l, positions=None):
    """Column sums of every row segment read: all of k and v, or for pdyn
    each slot's blocks up to max(position, 0) // block_l."""
    s, l, _, hd = k.shape
    if positions is None:
        keep = np.ones((s, l), bool)
    else:
        live = np.maximum(positions, 0) // block_l
        keep = (np.arange(l) // block_l)[None, :] <= live[:, None]
    return sum(np.where(keep[:, :, None, None], t, 0).astype(np.int64).reshape(-1, hd).sum(0)
               for t in (k, v))


@pytest.mark.parametrize("mode", probes.COPY_MODES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("g", [1, 2])
def test_diag_copy_plain(mode, hd, g):
    """Each form's int32 column sums [hd], exactly; pdyn over mixed
    positions (-1 and 0 read block 0, a block edge, the last row)."""
    k, v = _cache(4, 32, 4, hd, seed=hd + g)
    pos = np.array([-1, 0, 8, 31], np.int32) if mode == "pdyn" else None
    before = probes.diag_copy_launches
    out = probes.diag_copy(torch.from_numpy(k), torch.from_numpy(v), mode, 8, g,
                           None if pos is None else torch.from_numpy(pos))
    assert out.dtype == torch.int32 and out.shape == (hd,)
    np.testing.assert_array_equal(out.numpy(), _want(k, v, 8, pos))
    assert probes.diag_copy_launches == before


def test_pdyn_reads_less_than_pcopy():
    k, v = _cache(3, 64, 2, 32)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    pos = torch.tensor([-1, 20, 63], dtype=torch.int32)
    dyn = probes.diag_copy(tk, tv, "pdyn", 16, positions=pos)
    assert not torch.equal(dyn, probes.diag_copy(tk, tv, "pcopy", 16))
    full = torch.full((3,), 63, dtype=torch.int32)
    assert torch.equal(probes.diag_copy(tk, tv, "pdyn", 16, positions=full),
                       probes.diag_copy(tk, tv, "pcopy", 16))


@pytest.mark.parametrize("hd", [0, 8, 24, 272])
def test_diag_copy_refuses_a_bad_hd(hd):
    """hd must be a multiple of 16 up to 256 (16 is the smallest taken)."""
    k = torch.zeros((2, 16, 2, hd), dtype=torch.int8)
    with pytest.raises(ValueError, match="hd="):
        probes.diag_copy(k, k, "pcopy", 8)
    with pytest.raises(ValueError, match="hd="):
        probes.diag_copy_plain(k, k, "pcopy4d", 8)


def test_diag_copy_refuses_bad_inputs():
    k = torch.zeros((2, 16, 4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="block_l"):
        probes.diag_copy(k, k, "pcopy", 5)
    with pytest.raises(ValueError, match="g=3"):
        probes.diag_copy(k, k, "pcopy4d", 8, g=3)
    with pytest.raises(ValueError, match="positions"):
        probes.diag_copy(k, k, "pdyn", 8)
    with pytest.raises(ValueError, match="int8"):
        probes.diag_copy(k.float(), k.float(), "pcopy", 8)
    with pytest.raises(ValueError, match="unknown mode"):
        probes.diag_copy(k, k, "pcopy5d", 8)
    assert probes.diag_copy(k[..., :16], k, "pcopy", 8).shape == (16,)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("rc", [0, 700])
def test_diag_copy_cuda_tensors_launch_the_kernel_or_raise(monkeypatch, rc):
    """A CUDA tensor goes to the strided kernel with each form's geometry,
    or raises; the plain version never runs."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or rc

    monkeypatch.setattr(kernels, "lib", lambda: FakeLib())
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "check", lambda code, what: (
        None if code == 0 else (_ for _ in ()).throw(RuntimeError(f"{what}: {code}"))))

    def plain_must_not_run(*a, **kw):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(probes, "diag_copy_plain", plain_must_not_run)
    s, l, n_kv, hd, bl, g = 2, 32, 4, 64, 8, 2
    k = torch.Tensor._make_subclass(_FakeCuda, torch.zeros((s, l, n_kv, hd), dtype=torch.int8))
    pos = torch.Tensor._make_subclass(_FakeCuda, torch.tensor([3, 31], dtype=torch.int32))
    row = n_kv * hd
    before = probes.diag_copy_launches
    want = {  # slot, group, block and row strides; rows, run, hd, live_div; grid
        "pcopy": (l * row, 0, bl * row, row, bl, row, hd, bl, l // bl, 1, s),
        "pcopy4d": (l * row, g * hd, bl * row, row, bl, g * hd, hd, bl, l // bl, n_kv // g, s),
        "pdyn": (l * row, 0, bl * row, row, bl, row, hd, bl, l // bl, 1, s),
    }
    for mode in probes.COPY_MODES:
        call = lambda: probes.diag_copy(k, k, mode, bl, g, pos if mode == "pdyn" else None)
        if rc == 0:
            call()
        else:
            with pytest.raises(RuntimeError):
                call()
        name, args = calls[-1]
        assert name == "tpuserve_probe_colsum_strided"
        assert args[4:15] == want[mode], mode
        assert (args[3] != 0) == (mode == "pdyn")
        assert probes.diag_copy_grid(k.shape, mode, bl, g) == want[mode][8:]
    assert probes.diag_copy_launches == before + (3 if rc == 0 else 0)


def test_diag_bw_runs_every_mode_on_the_cpu(capsys):
    """`diag_bw --device cpu` at a tiny size: the header, one line per mode
    with the kernel's grid, none failed."""
    records = diag_bw.main(["--device", "cpu", "--s", "2", "--l", "32", "--n-kv", "4",
                            "--hd", "64", "--g", "2", "--block-l", "16", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# arrays 2x0 MB; S=2 L=32 Hkv=4 hd=64 g=2 block_l=16")
    assert [r["mode"] for r in records] == list(diag_bw.MODES)
    for line, rec in zip(lines[1:], records):
        assert line.startswith(rec["mode"]) and " us/iter " in line and "FAILED" not in line
        assert rec["us"] > 0 and rec["gb_s"] > 0
    assert lines[2].endswith("grid 2x1x2 = 4 blocks") and lines[3].endswith("grid 2x2x2 = 8 blocks")


def test_diag_bw_fails_on_a_failing_mode(capsys):
    with pytest.raises(SystemExit) as e:
        diag_bw.main(["--device", "cpu", "--s", "2", "--l", "32", "--n-kv", "4", "--hd", "24",
                      "--mode", "xsum,pcopy", "--block-l", "16", "--iters", "1"])
    assert e.value.code == 1
    assert "pcopy      FAILED: ValueError: diag_copy: hd=24" in capsys.readouterr().out


def test_diag_bw_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        diag_bw.main(["--device", "cuda"])
