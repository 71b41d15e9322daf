"""The Hopper quant-matmul's host side on the CPU, and the ported sweep.

The kernels (csrc/quant_matmul.cu: bf16 activations, f32 ones as three
bf16 pieces, and W4A8 on int8 wgmma) run only on the card, where
tests/test_torch_cuda.py holds them against quant_matmul_plain. Here: the
launch plan their wrapper picks (batch tile, warpgroups, K split) reads
the weights once for any batch up to 256 (f32 x: 128) and covers K
exactly; block_k sets the split as in the JAX package's quant_matmul; the
stages of K for every group size, odd and masked ones included; the group
sizes each route takes (every group, on the Hopper kernels); x laid out
for the masked steps; a CUDA tensor reaches one C entry once per call
(launches and routes counted, failures raised, nothing else launched); and
tpuserve_torch.scripts.qmatmul_sweep run end to end at a tiny size with
--device cpu (the port of scripts/qmatmul_sweep.py)."""

import numpy as np
import pytest
import torch

from tpuserve_torch import kernels
from tpuserve_torch.ops import quant_matmul as tqm
from tpuserve_torch.quant.core import quantize, quantize_activation
from tpuserve_torch.scripts import qmatmul_sweep

SMS = 132


@pytest.mark.parametrize("b", [1, 8, 37, 64, 72, 130, 256, 300])
@pytest.mark.parametrize("k,n", [(4096, 12288), (4096, 4096), (11008, 4096), (512, 208)])
def test_plan_reads_the_weights_once_up_to_256_rows(b, k, n):
    bt, nwg_n, nwg_b, sps, splits = tqm.hopper_plan(b, k, n, 4, SMS)
    assert bt in tqm._BATCH_TILES and nwg_n * nwg_b <= 2
    rows = bt * nwg_b                         # batch rows one block covers
    passes = -(-b // rows)                    # blocks along grid.z
    assert passes == (1 if b <= 256 else -(-b // 256))
    assert rows >= min(b, 256) and (b <= 128) == (nwg_b == 1)
    total = -(-k // 128)                      # int4 stages of 128 values of K
    assert splits == -(-total // sps) and (splits - 1) * sps < total <= splits * sps


@pytest.mark.parametrize("block_k,bits,sps", [(128, 4, 1), (256, 4, 2), (512, 4, 4),
                                              (1024, 4, 8), (64, 8, 1), (512, 8, 8),
                                              (8192, 4, 32)])
def test_block_k_sets_the_split(block_k, bits, sps):
    _, _, _, got, splits = tqm.hopper_plan(64, 4096, 4096, bits, SMS, block_k=block_k)
    total = 4096 // (128 if bits == 4 else 64)
    assert got == sps and splits == -(-total // sps)


@pytest.mark.parametrize("block_k,bits", [(64, 4), (100, 4), (96, 8), (0, 4)])
def test_block_k_off_the_stage_is_refused(block_k, bits):
    with pytest.raises(ValueError, match="block_k"):
        tqm.hopper_plan(64, 4096, 4096, bits, SMS, block_k=block_k)


@pytest.mark.parametrize("bits,gs,ok", [
    (4, 16, True), (4, 32, True), (4, 64, True), (4, 128, True), (4, 256, True), (4, 4096, True),
    (4, 48, True), (4, 96, True), (4, 8, True), (8, 16, True), (8, 64, True),
    (8, 128, True), (8, 96, True), (4, 80, True), (4, 112, True), (4, 688, True),
    (8, 48, True), (8, 80, True), (4, 40, True), (8, 24, True), (8, 8, True),
    (4, 2, True), (4, 10, True), (4, 344, True), (8, 1, True), (8, 3, True),
    (4, 7, False), (4, 0, False), (8, 0, False), (4, -2, False)])
def test_group_sizes_the_kernel_takes(bits, gs, ok):
    """Every positive group, int4 even ones (the groups of no multiple of
    16 values in masked k16 steps); nothing else."""
    assert tqm.hopper_group_ok(bits, gs) == ok


@pytest.mark.parametrize("gs,a8,masked", [
    (16, False, False), (48, False, False), (128, False, False), (4096, False, False),
    (2, False, True), (8, False, True), (40, False, True), (344, False, True), (1, False, True),
    (32, True, False), (96, True, False), (128, True, False), (16, True, True),
    (48, True, True), (12, True, True), (136, True, True), (344, True, True)])
def test_masked_groups(gs, a8, masked):
    """A k-step (16 values, 32 for W4A8) crosses a group's end exactly
    where the group is no multiple of it."""
    assert tqm.masked_group(gs, a8) == masked


@pytest.mark.parametrize("bits,gs,k", [
    (4, 128, 4096), (4, 16, 512), (4, 32, 480), (4, 64, 4096), (4, 256, 4096), (4, 4096, 4096),
    (4, 48, 4032), (4, 80, 480), (4, 96, 4032), (4, 112, 448), (4, 144, 576), (4, 688, 11008),
    (8, 128, 4096), (8, 16, 512), (8, 48, 480), (8, 96, 4032), (8, 80, 480), (8, 11008, 11008)])
def test_stages_cover_k_in_whole_groups_or_pieces(bits, gs, k):
    """A stage holds whole groups in at most 64 weight rows, or one piece of
    at most 64 rows of a group; the stages cover every weight row once. The
    groups a 64-row stage tiles keep the stages they had (K / 128 int4,
    K / 64 int8)."""
    gr, spg, total = tqm.stage_plan(bits, k, gs)
    rpg = gs // 2 if bits == 4 else gs
    groups = k // gs
    assert gr == 1 or spg == 1
    if spg == 1:
        assert gr * rpg <= 64 < (gr + 1) * rpg and total == -(-groups // gr)
    else:
        assert (spg - 1) * 64 < rpg <= spg * 64 and total == groups * spg
        pieces = [min(64, rpg - p * 64) for p in range(spg)]
        assert sum(pieces) == rpg and all(r % 8 == 0 for r in pieces)
    assert tqm.odd_group(bits, gs) == (64 % rpg != 0 and rpg % 64 != 0)
    if not tqm.odd_group(bits, gs):
        assert total == -(-k // (128 if bits == 4 else 64))


@pytest.mark.parametrize("gs,route", [(32, "wgmma"), (64, "wgmma"), (96, "wgmma"),
                                      (128, "wgmma"), (160, "wgmma"), (4096, "wgmma"),
                                      (16, "wgmma"), (48, "wgmma"), (40, "wgmma"),
                                      (8, "wgmma"), (2, "wgmma"), (12, "wgmma"), (20, "wgmma"),
                                      (136, "wgmma"), (144, "wgmma"), (344, "wgmma")])
def test_w4a8_route(gs, route):
    """W4A8 takes int8 wgmma for every even group: k32 steps where every
    group ends on one, masked k32 steps for the others."""
    assert tqm.w4a8_route(gs) == route


@pytest.mark.parametrize("gs", [0, 7, 21, -2])
def test_w4a8_route_refuses_what_no_kernel_takes(gs):
    with pytest.raises(ValueError, match="W4A8 group size"):
        tqm.w4a8_route(gs)


@pytest.mark.parametrize("b", [1, 16, 64, 72, 128, 130, 256, 300])
@pytest.mark.parametrize("gs,k", [(32, 4096), (64, 4096), (96, 4032), (128, 4096),
                                  (128, 11008), (4096, 4096), (11008, 11008), (160, 4000)])
def test_w4a8_plan(b, gs, k):
    """The W4A8 launch: an int8 wgmma batch tile (no n72), every stage a
    whole number of k32 steps, and a split that ends where a group does."""
    n = 4096
    bt, nwg_n, nwg_b, sps, splits = tqm.hopper_plan(b, k, n, 4, SMS, gs=gs, a8=True)
    assert bt in tqm._A8_TILES and bt * nwg_b >= min(b, 256)
    gr, spg, total = tqm.stage_plan(4, k, gs)
    stage_values = [2 * min(64, gs // 2 - p * 64) for p in range(spg)] if spg > 1 \
        else [gr * gs]
    assert all(v % 32 == 0 for v in stage_values)
    assert sps % spg == 0 and splits == -(-total // sps)


@pytest.mark.parametrize("bits,gs,k", [
    (4, 2, 64), (4, 10, 250), (4, 12, 240), (4, 20, 480), (4, 40, 480), (4, 136, 272),
    (4, 138, 276), (4, 344, 11008), (8, 1, 70), (8, 3, 249), (8, 24, 480), (8, 40, 480),
    (8, 72, 216)])
def test_stages_of_masked_groups(bits, gs, k):
    """Groups of no multiple of 16 values take the same stages: whole groups
    in at most 64 weight rows (and at most 128 values of x, the two boxes a
    stage holds), or pieces of at most 64 rows of one group, whatever the
    row count of the last piece; the stages cover every weight row once."""
    gr, spg, total = tqm.stage_plan(bits, k, gs)
    rpg = gs // 2 if bits == 4 else gs
    groups = k // gs
    assert tqm.masked_group(gs) and (gr == 1 or spg == 1)
    if spg == 1:
        assert gr * rpg <= 64 < (gr + 1) * rpg and total == -(-groups // gr)
        assert gr * gs <= (128 if bits == 4 else 64)
    else:
        pieces = [min(64, rpg - p * 64) for p in range(spg)]
        assert sum(pieces) == rpg and min(pieces) > 0 and total == groups * spg


@pytest.mark.parametrize("b", [1, 64, 72, 256, 300])
@pytest.mark.parametrize("gs,k", [(2, 64), (12, 240), (20, 4000), (48, 4032), (136, 4080),
                                  (144, 4032), (344, 11008), (10, 250)])
def test_w4a8_plan_of_masked_groups(b, gs, k):
    """W4A8 in groups of no multiple of 32: the int8 batch tiles, and a
    split that ends where a group does (pieces of a group in one split), so
    that each group's int32 sum is whole before its scale."""
    bt, nwg_n, nwg_b, sps, splits = tqm.hopper_plan(b, k, 4096, 4, SMS, gs=gs, a8=True)
    assert bt in tqm._A8_TILES and bt * nwg_b >= min(b, 256)
    gr, spg, total = tqm.stage_plan(4, k, gs)
    assert sps % spg == 0 and splits == -(-total // sps)
    assert (splits - 1) * sps < total <= splits * sps


@pytest.mark.parametrize("bits,gs,k", [
    (4, 2, 64), (4, 10, 250), (4, 12, 240), (4, 40, 4000), (4, 136, 272), (4, 138, 276),
    (4, 344, 11008), (8, 1, 70), (8, 3, 249), (8, 40, 4000), (8, 72, 216)])
def test_stage_x_index_gives_each_stage_its_values(bits, gs, k):
    """The masked steps' x layout: every K value once; each stage's 128
    positions (int8 weights: 64) hold the values its weight rows multiply,
    in the kernel's order (whole groups in order; a piece's low-nibble
    values from 0 and its high ones from 64), zeros elsewhere; so every box
    of 64 starts on a 16-byte boundary of x's row."""
    idx = tqm.stage_x_index(bits, k, gs)
    gr, spg, total = tqm.stage_plan(bits, k, gs)
    w = 128 if bits == 4 else 64
    assert tuple(idx.shape) == (total * w,)
    live = idx[idx < k]
    assert torch.equal(live.sort().values, torch.arange(k))
    rpg = gs // 2 if bits == 4 else gs
    for t, stage in enumerate(idx.reshape(total, w).tolist()):
        grp = t * gr if spg == 1 else t // spg
        r0 = grp * rpg + (0 if spg == 1 else (t % spg) * 64)
        for pos, kk in enumerate(stage):
            if kk == k:
                continue
            g, r = divmod(kk, gs)
            row = g * rpg + (r % rpg if bits == 4 else r)
            assert r0 <= row < r0 + 64                       # a row the stage holds
            if spg == 1:
                assert kk == grp * gs + pos                  # the stage's values in order
            else:
                assert pos % 64 == row - r0 and (pos >= 64) == (bits == 4 and r >= rpg)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to reach the
    wrapper's kernel branch on a machine without a card."""

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    def __init__(self, rc=0):
        self.rc, self.calls, self.ok = rc, [], set()

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0 if name in self.ok else self.rc
        return fn


def _fake(monkeypatch, rc):
    fake = _FakeLib(rc)
    monkeypatch.setattr(kernels, "lib", lambda: fake)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "sm_count", lambda device: SMS)
    monkeypatch.setattr(kernels, "check", lambda code, what: (
        None if code == 0 else (_ for _ in ()).throw(RuntimeError(f"{what}: {code}"))))

    def plain_must_not_run(*a, **k):
        raise AssertionError("plain version ran for a CUDA tensor")

    monkeypatch.setattr(tqm, "quant_matmul_plain", plain_must_not_run)
    return fake


def _inputs(bits, gs, k, n, b):
    rng = np.random.default_rng(bits + gs + b)
    qt = quantize(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.05),
                  bits=bits, group_size=gs)
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(torch.bfloat16)
    return torch.Tensor._make_subclass(_FakeCuda, x), qt


@pytest.mark.parametrize("b,block_k", [(64, None), (72, None), (300, None), (64, 256)])
def test_bf16_calls_the_hopper_entry_once(monkeypatch, b, block_k):
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(4, 128, 4096, 4096, b)
    before = tqm.launches
    out = tqm.quant_matmul(x, qt, block_k=block_k)
    assert tqm.launches == before + 1 and tuple(out.shape) == (b, 4096)
    assert [name for name, _ in fake.calls] == ["tpuserve_quant_matmul_bf16"]
    args = fake.calls[0][1]
    b_, k_, n_, gs, bits, bt, nwg_n, nwg_b, sps, splits = args[6:16]
    assert (b_, k_, n_, gs, bits) == (b, 4096, 4096, 128, 4)
    assert (bt, nwg_n, nwg_b, sps, splits) == tqm.hopper_plan(b, 4096, 4096, 4, SMS, block_k)
    assert (args[4] != 0) == (splits > 1) and (args[5] != 0) == (splits > 1)


def test_bf16_kernel_failure_raises(monkeypatch):
    _fake(monkeypatch, 700)
    x, qt = _inputs(4, 128, 512, 256, 8)
    before = tqm.launches
    with pytest.raises(RuntimeError, match="quant_matmul"):
        tqm.quant_matmul(x, qt)
    assert tqm.launches == before


def test_bf16_group_the_kernel_cannot_tile_is_refused(monkeypatch):
    """A group of no multiple of 16 values (40) goes to the Hopper entry in
    masked k16 steps, with the plan of its stages, counted as a group-route
    launch; no other entry is called."""
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(4, 40, 480, 64, 4)
    before, routed, staged = tqm.launches, tqm.group_route_launches, tqm.stage_launches
    out = tqm.quant_matmul(x, qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_stage_x", "tpuserve_quant_matmul_bf16"]
    s_args, args = fake.calls[0][1], fake.calls[1][1]
    index = tqm.stage_index(4, 480, 40, "cpu")
    assert s_args[1] == index.data_ptr() and s_args[3:6] == (4, 480, index.numel())
    assert args[0] == s_args[2]                # x in the masked steps' layout
    assert args[6:11] == (4, 480, 64, 40, 4)   # b, k, n, gs, bits
    assert args[11:16] == tqm.hopper_plan(4, 480, 64, 4, SMS, gs=40)
    assert tqm.launches == before + 1 and tqm.group_route_launches == routed + 1
    assert tqm.stage_launches == staged + 1
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (4, 64)


# every group the JAX package's quantize makes of K = 4096 (even, dividing
# K; per-channel is one group of K) has a route for bf16 activations: the
# wgmma kernel
@pytest.mark.parametrize("gs", [16, 32, 48, 64, 96, 128, 256, 0])
@pytest.mark.parametrize("bits", [4, 8])
def test_every_quantized_group_has_a_bf16_route(bits, gs):
    k = 4096
    g = gs or k
    route = tqm.bf16_route(bits, g)
    assert tqm.hopper_group_ok(bits, g) and route == "wgmma"


# the same for every even divisor of the 7B contraction widths and of the
# odd-group check's K = 4032: wgmma for all, masked k16 steps exactly where
# the group is no multiple of 16
@pytest.mark.parametrize("k", [4096, 4032, 11008])
@pytest.mark.parametrize("bits", [4, 8])
def test_every_even_divisor_has_its_bf16_route(bits, k):
    for g in (g for g in range(2, k + 1, 2) if k % g == 0):
        assert tqm.bf16_route(bits, g) == "wgmma", g
        assert tqm.masked_group(g) == (g % 16 != 0), g


# int8 weights: every divisor, odd ones included (quantize makes any group)
@pytest.mark.parametrize("k", [4032, 4000, 249])
def test_every_int8_divisor_has_its_bf16_route(k):
    for g in (g for g in range(1, k + 1) if k % g == 0):
        assert tqm.bf16_route(8, g) == "wgmma", g


@pytest.mark.parametrize("bits,gs", [(4, 7), (4, 0), (3, 64)])
def test_bf16_route_refuses_what_no_kernel_takes(bits, gs):
    with pytest.raises(ValueError, match="no kernel"):
        tqm.bf16_route(bits, gs)


@pytest.mark.parametrize("bits,gs", [(4, 40), (8, 40), (8, 24)])
def test_bf16_group_route_launches_once(monkeypatch, bits, gs):
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(bits, gs, 480, 128, 72)
    routed, odd = tqm.group_route_launches, tqm.odd_group_launches
    tqm.quant_matmul(x, qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_stage_x", "tpuserve_quant_matmul_bf16"]
    assert fake.calls[1][1][9:11] == (gs, bits)
    assert tqm.group_route_launches == routed + 1 and tqm.odd_group_launches == odd


@pytest.mark.parametrize("bits,gs,k", [(4, 48, 480), (4, 96, 480), (4, 80, 480), (4, 112, 448),
                                       (8, 96, 480), (8, 48, 480), (4, 688, 11008)])
@pytest.mark.parametrize("b", [4, 72])
def test_odd_groups_take_the_hopper_entry(monkeypatch, bits, gs, k, b):
    """bf16 x in groups the 64-row stage cannot tile: the Hopper entry once,
    with the plan for the group's stages, counted as an odd-group launch;
    the group route's counter does not move."""
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(bits, gs, k, 128, b)
    before, routed, odd = tqm.launches, tqm.group_route_launches, tqm.odd_group_launches
    out = tqm.quant_matmul(x, qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_quant_matmul_bf16"]
    args = fake.calls[0][1]
    assert args[6:11] == (b, k, 128, gs, bits)
    assert args[11:16] == tqm.hopper_plan(b, k, 128, bits, SMS, gs=gs)
    assert tqm.launches == before + 1 and tqm.odd_group_launches == odd + 1
    assert tqm.group_route_launches == routed
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, 128)


@pytest.mark.parametrize("gs,k", [(128, 4096), (32, 480), (96, 480), (4096, 4096)])
@pytest.mark.parametrize("b", [1, 64, 72, 300])
def test_w4a8_calls_the_int8_hopper_entry_once(monkeypatch, gs, k, b):
    """W4A8 in groups of a multiple of 32: the int8 Hopper entry once, on
    the W4A8 plan, counted in w4a8_launches; f32 out before the row scale,
    then the activation's dtype."""
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(4, gs, k, 256, b)
    qt.act_bits = 8
    before, a8, routed = tqm.launches, tqm.w4a8_launches, tqm.w4a8_route_launches
    quantized = tqm.quantize_launches
    out = tqm.quant_matmul(x, qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_quantize_rows",
                                                "tpuserve_quant_matmul_a8"]
    q_args, args = fake.calls[0][1], fake.calls[1][1]
    assert q_args[3:6] == (b, k, 1)                      # bf16 x, one block a row
    assert args[0] == q_args[1] and args[3] == q_args[2]  # its codes and row scales
    assert args[7:12] == (b, k, 256, gs, 1)              # bf16 out, the row scale in
    assert args[12:17] == tqm.hopper_plan(b, k, 256, 4, SMS, gs=gs, a8=True)
    assert (args[5] != 0) == (args[16] > 1) and (args[6] != 0) == (args[16] > 1)
    assert tqm.launches == before + 1 and tqm.w4a8_launches == a8 + 1
    assert tqm.w4a8_route_launches == routed and tqm.quantize_launches == quantized + 1
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, 256)


@pytest.mark.parametrize("gs", [48, 16])
def test_w4a8_other_groups_keep_the_cuda_core_entry(monkeypatch, gs):
    """W4A8 in groups of no multiple of 32 values: the row quantization,
    then the int8 Hopper entry once on the W4A8 plan, counted in
    w4a8_route_launches (the masked k32 steps)."""
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(4, gs, 480, 64, 8)
    qt.act_bits = 8
    before, a8, routed = tqm.launches, tqm.w4a8_launches, tqm.w4a8_route_launches
    tqm.quant_matmul(x, qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_quantize_rows",
                                                "tpuserve_quant_matmul_a8"]
    index = tqm.stage_index(4, 480, gs, "cpu")
    assert fake.calls[0][1][6:8] == (index.data_ptr(), index.numel())   # codes laid out
    assert fake.calls[1][1][7:12] == (8, 480, 64, gs, 1)    # b, k, n, gs, bf16 out
    assert fake.calls[1][1][12:17] == tqm.hopper_plan(8, 480, 64, 4, SMS, gs=gs, a8=True)
    assert tqm.launches == before + 1 and tqm.w4a8_route_launches == routed + 1
    assert tqm.w4a8_launches == a8


@pytest.mark.parametrize("gs,k", [(12, 480), (20, 480), (136, 272), (144, 288), (10, 250)])
@pytest.mark.parametrize("b", [1, 64, 300])
def test_w4a8_groups_the_card_refused_reach_the_int8_entry(monkeypatch, gs, k, b):
    """The even W4A8 groups no kernel took (12, 20, 136, 144, ...): the row
    quantization once, writing its codes in the masked steps' layout
    (stage_index), then the int8 Hopper entry once on those codes and row
    scales, counted in w4a8_route_launches and quantize_launches."""
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(4, gs, k, 64, b)
    qt.act_bits = 8
    before, a8, routed = tqm.launches, tqm.w4a8_launches, tqm.w4a8_route_launches
    quantized = tqm.quantize_launches
    out = tqm.quant_matmul(x, qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_quantize_rows",
                                                "tpuserve_quant_matmul_a8"]
    q_args, args = fake.calls[0][1], fake.calls[1][1]
    index = tqm.stage_index(4, k, gs, "cpu")
    assert q_args[3:8] == (b, k, 1, index.data_ptr(), index.numel())
    assert args[0] == q_args[1] and args[3] == q_args[2]   # its codes and row scales
    assert args[7:12] == (b, k, 64, gs, 1)
    assert args[12:17] == tqm.hopper_plan(b, k, 64, 4, SMS, gs=gs, a8=True)
    assert tqm.launches == before + 1 and tqm.w4a8_route_launches == routed + 1
    assert tqm.w4a8_launches == a8 and tqm.quantize_launches == quantized + 1
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (b, 64)


@pytest.mark.parametrize("gs,act_bits", [(96, 0), (128, 8), (96, 8), (40, 0), (48, 8),
                                         (12, 8)])
def test_new_hopper_paths_raise_on_failure(monkeypatch, gs, act_bits):
    """A build or launch error on the odd-group, the W4A8 or either masked
    path raises; no other kernel is tried and nothing is counted."""
    fake = _fake(monkeypatch, 700)
    # the row quantization and the layout launch; the matmul fails
    fake.ok = {"tpuserve_quantize_rows", "tpuserve_stage_x"}
    x, qt = _inputs(4, gs, 512 if 512 % gs == 0 else 480, 64, 8)
    qt.act_bits = act_bits
    counts = (tqm.launches, tqm.odd_group_launches, tqm.w4a8_launches,
              tqm.group_route_launches, tqm.w4a8_route_launches)
    with pytest.raises(RuntimeError, match="quant_matmul"):
        tqm.quant_matmul(x, qt)
    assert [n for n, _ in fake.calls if n not in fake.ok] == [
        "tpuserve_quant_matmul_a8" if act_bits else "tpuserve_quant_matmul_bf16"]
    assert counts == (tqm.launches, tqm.odd_group_launches, tqm.w4a8_launches,
                      tqm.group_route_launches, tqm.w4a8_route_launches)


@pytest.mark.parametrize("gs", [128, 96, 40])
@pytest.mark.parametrize("failing", ["tpuserve_split_x", "tpuserve_quant_matmul_bf16"])
def test_f32_route_raises_on_failure(monkeypatch, gs, failing):
    """A failing split or matmul launch on the f32 route raises; nothing
    after it is launched, nothing falls back and nothing is counted."""
    fake = _fake(monkeypatch, 700)
    fake.ok = {"tpuserve_split_x", "tpuserve_quant_matmul_bf16"} - {failing}
    x, qt = _inputs(4, gs, 480 if gs != 128 else 512, 64, 8)
    names = ("launches", "f32_launches", "split_launches")
    counts = [getattr(tqm, c) for c in names]
    with pytest.raises(RuntimeError, match="split_x" if failing.endswith("x") else "quant_matmul"):
        tqm.quant_matmul(x.float(), qt)
    assert [n for n, _ in fake.calls][-1] == failing
    assert [getattr(tqm, c) for c in names] == [
        counts[0], counts[1], counts[2] + (failing != "tpuserve_split_x")]


# f32 x on the Hopper kernel as three bf16 pieces: g128, per channel, odd
# groups (stages cut along them) and masked ones (x laid out a stage at a time)
_F32_GROUPS = [(4, 128, 512), (8, 128, 512), (4, 0, 512), (4, 48, 480), (4, 96, 480),
               (8, 96, 480), (4, 40, 480), (4, 12, 480), (8, 24, 480)]


@pytest.mark.parametrize("bits,gs,k", _F32_GROUPS)
@pytest.mark.parametrize("b", [1, 64, 256])
def test_f32_reaches_the_hopper_entry_once(monkeypatch, bits, gs, k, b):
    """f32 x: the split kernel once (x in order, or for a masked group in
    the masked steps' layout, stage_index), then the bf16 Hopper entry once
    on its three pieces, with the f32 plan and pieces 3, into an f32 out;
    counted in f32_launches and split_launches, never on a bf16 route."""
    fake = _fake(monkeypatch, 0)
    x, qt = _inputs(bits, gs, k, 64, b)
    g = gs or k
    names = ("launches", "f32_launches", "split_launches", "group_route_launches",
             "odd_group_launches", "stage_launches")
    counts = [getattr(tqm, c) for c in names]
    out = tqm.quant_matmul(x.float(), qt)
    assert [name for name, _ in fake.calls] == ["tpuserve_split_x", "tpuserve_quant_matmul_bf16"]
    s_args, args = fake.calls[0][1], fake.calls[1][1]
    index = tqm.stage_index(bits, k, g, "cpu") if tqm.masked_group(g) else None
    assert s_args[1] == (0 if index is None else index.data_ptr())
    assert s_args[3:6] == (b, k, k if index is None else index.numel())
    assert args[0] == s_args[2]                  # the pieces
    assert args[6:11] == (b, k, 64, g, bits)
    assert args[11:16] == tqm.hopper_plan(b, k, 64, bits, SMS, gs=g, pieces=3)
    assert args[16] == tqm.PIECES == 3
    assert [getattr(tqm, c) for c in names] == [counts[0] + 1, counts[1] + 1, counts[2] + 1,
                                                counts[3], counts[4], counts[5]]
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, 64)


@pytest.mark.parametrize("bits,gs,k", _F32_GROUPS + [(4, 2, 64), (8, 1, 70), (4, 4096, 4096)])
@pytest.mark.parametrize("b", [1, 37, 64, 72, 128, 129, 256, 300])
def test_f32_plan_fits_two_stages(bits, gs, k, b):
    """The f32 plan: at most 128 batch rows a block (three pieces' x boxes a
    stage), the ring at least two stages deep at every group, the rows
    covered, K split as for bf16 x."""
    g = gs or k
    bt, nwg_n, nwg_b, sps, splits = tqm.hopper_plan(b, k, 4096, bits, SMS, gs=g, pieces=3)
    assert nwg_b == 1 and nwg_n == 2 and bt in tqm._BATCH_TILES and bt <= 128
    assert bt >= min(b, 64)                      # 64 rows a block fit every group
    assert bt >= min(b, 128) or tqm.ring_stages(bits, k, g, 128, nwg_n, 3) < 2
    assert tqm.ring_stages(bits, k, g, bt, nwg_n, 3) >= 2
    total = tqm.stage_plan(bits, k, g)[2]
    assert splits == -(-total // sps) and (splits - 1) * sps < total <= splits * sps


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_quantize_rows_reaches_its_kernel(monkeypatch, dtype):
    """quantize_rows: a CUDA tensor reaches the row kernel once (bf16 as
    itself, other dtypes as f32), counted; a CPU tensor takes
    quantize_activation, the plain version, unchanged."""
    fake = _fake(monkeypatch, 0)
    x = torch.randn(6, 96).to(dtype)
    q, sx = tqm.quantize_rows(x)
    ref_q, ref_s = quantize_activation(x)
    assert torch.equal(q, ref_q) and torch.equal(sx, ref_s) and not fake.calls
    before = tqm.quantize_launches
    q, sx = tqm.quantize_rows(torch.Tensor._make_subclass(_FakeCuda, x))
    assert [name for name, _ in fake.calls] == ["tpuserve_quantize_rows"]
    assert fake.calls[0][1][3:8] == (6, 96, int(dtype == torch.bfloat16), 0, 96)  # K in order
    assert q.dtype == torch.int8 and tuple(sx.shape) == (6, 1)
    assert tqm.quantize_launches == before + 1


@pytest.mark.parametrize("bits,gs,k", [(4, 40, 480), (4, 136, 272), (8, 3, 249)])
def test_stage_x_lays_x_out_for_the_masked_steps(monkeypatch, bits, gs, k):
    """stage_x: a CPU tensor takes the plain gather (x[:, index], zeros
    where index == K); a CUDA tensor reaches its kernel once with the index
    and its length, counted. quantize_rows with the same index gives the
    plain codes laid out alike, and its kernel gets the index."""
    rng = np.random.default_rng(gs)
    x = torch.from_numpy(rng.normal(size=(3, k)).astype(np.float32)).to(torch.bfloat16)
    index = tqm.stage_index(bits, k, gs, "cpu")
    ref = torch.cat([x, torch.zeros(3, 1, dtype=x.dtype)], 1)[:, index.long()]
    assert torch.equal(tqm.stage_x(x, index), ref)
    q, sx = tqm.quantize_rows(x, index)
    ref_q, ref_s = quantize_activation(x)
    assert torch.equal(sx, ref_s)
    zeros = torch.zeros(3, 1, dtype=torch.int8)
    assert torch.equal(q, torch.cat([ref_q, zeros], 1)[:, index.long()])
    fake = _fake(monkeypatch, 0)
    staged, quantized = tqm.stage_launches, tqm.quantize_launches
    xc = torch.Tensor._make_subclass(_FakeCuda, x)
    out = tqm.stage_x(xc, index)
    tqm.quantize_rows(xc, index)
    assert [name for name, _ in fake.calls] == ["tpuserve_stage_x", "tpuserve_quantize_rows"]
    assert fake.calls[0][1][1] == index.data_ptr() and fake.calls[0][1][3:6] == (3, k, len(index))
    assert fake.calls[1][1][3:8] == (3, k, 1, index.data_ptr(), len(index))
    assert tuple(out.shape) == (3, len(index)) and out.dtype == torch.bfloat16
    assert (tqm.stage_launches, tqm.quantize_launches) == (staged + 1, quantized + 1)


def test_sweep_runs_every_mode_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(qmatmul_sweep, "dims", lambda: dict(K=256, N=256))
    for name, val in (("TPUSERVE_QMM_B", "4"), ("TPUSERVE_QMM_DEPTH", "2"),
                      ("TPUSERVE_QMM_ROUNDS", "2")):
        monkeypatch.setenv(name, val)
    records = qmatmul_sweep.main(["--device", "cpu"])
    names = ["int4/auto", "int4/bk256", "int4/bk512", "int4/bk1024", "int8/auto",
             "int8/bk512", "int4/xla"]
    assert [r["mode"] for r in records] == names
    assert all("failed" not in r and r["us"] > 0 for r in records)
    out = capsys.readouterr().out
    assert "# b=4 256x256 gs=128 depth=2" in out and "host clock" in out
    assert all(f"{n:14s}" in out for n in names)


def test_sweep_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        qmatmul_sweep.main(["--device", "cuda"])


def test_ab_runs_turns_a_b_b_a(monkeypatch, tmp_path, capsys):
    """The parent-vs-change scripts (ab_quant_matmul and ab_attention)
    run their turns A, B, B, A, print each case's mean ratio and a case
    only one checkout has, and keep every turn."""
    import json

    from tpuserve_torch.scripts import ab_attention, ab_quant_matmul

    seen = []

    def fake_turn(tree, code):
        seen.append(tree)
        rows = {"per decode step (B=64)": 2.0 if tree == "change" else 4.0}
        if tree == "change":
            rows["per verify step (B=72)"] = 2.1
        return rows

    monkeypatch.setattr(ab_attention, "turn", fake_turn)
    monkeypatch.chdir(tmp_path)
    ab_quant_matmul.main(["parent", "change"])
    assert seen == ["parent", "change", "change", "parent"]
    out = capsys.readouterr().out
    assert "per decode step (B=64): A 4.0000 / 4.0000 ms, B 2.0000 / 2.0000 ms, B/A 0.500" in out
    assert "per verify step (B=72): only in B: 2.1000 / 2.1000 ms" in out
    rec = json.loads((tmp_path / "chiprun_out" / "ab_quant_matmul.json").read_text())
    assert rec["order"] == ["a", "b", "b", "a"] and len(rec["turns"]) == 4


@pytest.mark.parametrize("name", ["base", "tma_only", "no_wgmma", "no_convert", "no_lds",
                                  "no_epilogue", "a8_tma_only", "a8_no_wgmma", "a8_no_convert",
                                  "a8_no_ldmatrix", "a8_no_flush", "mk_no_build",
                                  "mk_no_fast", "mk_no_wgmma", "mk_no_flush"])
def test_ablations_still_match_the_kernel_source(name):
    """Each cut of scripts/qmm_ablate.py applies to csrc/quant_matmul.cu as
    it is (the script runs only on the card; this keeps it in step)."""
    from tpuserve_torch.scripts import qmm_ablate

    src = qmm_ablate.patched(name)
    assert ("qmm_wgmma_kernel" in src) and (name == "base") == (src == (
        kernels.CSRC / "quant_matmul.cu").read_text())
