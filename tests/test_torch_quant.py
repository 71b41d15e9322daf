"""tpuserve_torch.quant.core and the KV packing against the JAX package.

Byte formats must be identical (weights and caches cross between the two
packages unchanged), quantizer codes and scales must agree, and every
qmatmul mode must give the JAX package's output up to f32 summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.quant import core as tcore
from torch_parity import jax_qt_to_torch, to_np


def test_pack_int4_bytes_identical():
    rng = np.random.default_rng(0)
    codes = rng.integers(-8, 8, size=(512, 96)).astype(np.int8)
    for gs in (128, 32, 512):
        ref = np.asarray(jcore.pack_int4(jnp.asarray(codes), gs))
        out = tcore.pack_int4(torch.from_numpy(codes), gs).numpy()
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, ref)
        back = tcore.unpack_int4(torch.from_numpy(ref.copy()), gs if gs < 512 else 0).numpy()
        np.testing.assert_array_equal(back, codes)


def test_pack_kv_codes_bytes_identical():
    rng = np.random.default_rng(1)
    codes = rng.integers(-8, 8, size=(3, 5, 512)).astype(np.int8)
    ref = np.asarray(jllama.pack_kv_codes(jnp.asarray(codes), 1))
    out = tllama.pack_kv_codes(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(out, ref)
    back = tllama.unpack_kv_codes(torch.from_numpy(ref.copy())).numpy()
    np.testing.assert_array_equal(back, np.asarray(jllama.unpack_kv_codes(jnp.asarray(ref), 1)))
    np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("bits,gs", [(4, 128), (4, 0), (8, 128), (8, 0)])
def test_quantize_codes_and_scales_match(bits, gs):
    """Same codes and scales. The int4 clip search picks, per (group,
    column), the clip ratio with the least squared error; a float sum taken
    in another order could flip a near-tie. Over these 4 x 2048 columns
    (and the engine tests' weights) no flip occurs: the assertion is exact."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(512, 2048)).astype(np.float32) * 0.02
    ref = jcore.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    out = tcore.quantize(torch.from_numpy(w), bits=bits, group_size=gs)
    assert (out.bits, out.group_size, tuple(out.orig_shape)) == \
        (ref.bits, ref.group_size, tuple(ref.orig_shape))
    np.testing.assert_array_equal(out.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(out.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(
        tcore.dequantize(out).numpy(), np.asarray(jcore.dequantize(ref)))


def test_activation_quantizers_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 256)).astype(np.float32) * 3
    jq, js = jcore.quantize_activation(jnp.asarray(x))
    tq, ts = tcore.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # e4m3 rounding: both round to nearest even within range
    ref = np.asarray(jcore.fp8_round(jnp.asarray(x)).astype(jnp.float32))
    np.testing.assert_array_equal(to_np(tcore.fp8_round(torch.from_numpy(x))), ref)


QMATMUL_MODES = [
    # (bits, group_size, act_bits, act_fp8)
    (4, 128, 0, False),
    (8, 128, 0, False),
    (8, 0, 0, False),
    (8, 0, 8, False),    # W8A8 (plain in both packages)
    (4, 128, 8, False),  # W4A8 (fused kernel / its reference)
    (4, 128, 0, True),   # fp8-rounded activations into the int4 kernel
]


@pytest.mark.parametrize("bits,gs,act_bits,act_fp8", QMATMUL_MODES)
def test_qmatmul_modes_match_jax(bits, gs, act_bits, act_fp8):
    """Each qmatmul mode against the JAX package's qmatmul on the CPU: its
    XLA path for f32 activations, and its fused kernel (interpret mode) for
    the bf16 activations that fp8 rounding makes, since the XLA path would
    round the dequantized weight to bf16 first. W4A8 is also held against
    the JAX W4A8 reference."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(256, 192)).astype(np.float32) * 0.05
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    qt = jcore.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    qt = dataclasses.replace(qt, act_bits=act_bits, act_fp8=act_fp8)
    ref = np.asarray(jcore.qmatmul(jnp.asarray(x), qt, use_pallas=act_fp8 or None)
                     .astype(jnp.float32))
    tq = jax_qt_to_torch(qt)
    out = to_np(tcore.qmatmul(torch.from_numpy(x), tq))
    assert out.shape == ref.shape == (2, 3, 192)
    if act_fp8:
        # both round an f32 sum of the same exact products to bf16: the
        # sums differ in order only, so at most one bf16 ulp apart
        np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-3)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if bits == 4 and act_bits == 8:
        ref8 = np.asarray(jcore._w4a8_matmul_ref(jnp.asarray(x), qt))
        out8 = to_np(tcore._w4a8_matmul_ref(torch.from_numpy(x), tq))
        np.testing.assert_allclose(out8, ref8, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits,gs", [(4, 48), (4, 96), (8, 96)])
def test_quant_matmul_groups_off_the_stage_match_jax_kernel(bits, gs):
    """Groups the Hopper kernel's stages cannot tile (served on the card in
    stages cut along the groups): the port's plain version on
    bf16 x against the JAX package's fused kernel in interpret mode. Both
    sum the same exact products in f32 and round to bf16: at most one bf16
    ulp apart."""
    from tpuserve.ops.quant_matmul import quant_matmul as jqmm
    from tpuserve_torch.ops.quant_matmul import quant_matmul_plain

    rng = np.random.default_rng(6 + gs)
    w = rng.normal(size=(480, 128)).astype(np.float32) * 0.05
    x = rng.normal(size=(5, 480)).astype(np.float32)
    qt = jcore.quantize(jnp.asarray(w), bits=bits, group_size=gs)
    assert qt.group_size == gs
    ref = np.asarray(jqmm(jnp.asarray(x, jnp.bfloat16), qt, interpret=True)
                     .astype(jnp.float32))
    out = quant_matmul_plain(torch.from_numpy(x).to(torch.bfloat16), jax_qt_to_torch(qt))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), ref, rtol=2 ** -7, atol=1e-3)


def test_quantize_param_tree_selection():
    rng = np.random.default_rng(5)
    params = {
        "embed/weight": rng.normal(size=(64, 256)).astype(np.float32),
        "layers.0/wqkv/kernel": rng.normal(size=(256, 512)).astype(np.float32),
        "layers.0/attn_norm/scale": np.ones((256,), np.float32),
    }
    jp = jcore.quantize_param_tree({k: jnp.asarray(v) for k, v in params.items()}, bits=4)
    tp = tcore.quantize_param_tree({k: torch.from_numpy(v) for k, v in params.items()}, bits=4)
    for name in params:
        assert isinstance(tp[name], tcore.QTensor) == isinstance(jp[name], jcore.QTensor), name
    np.testing.assert_array_equal(tp["layers.0/wqkv/kernel"].q.numpy(),
                                  np.asarray(jp["layers.0/wqkv/kernel"].q))


@pytest.mark.parametrize("b", [1, 16, 17, 64])
def test_w8a8_int_mm_rows_equal_the_float64_contraction(b):
    """W8A8's card path (torch._int_mm on the int8 codes, rows padded to 17
    where B <= 16) gives the float64 contraction's sums exactly, so
    _w8a8_matmul's bits: the int32 sums, then the same f32 scaling."""
    rng = np.random.default_rng(b)
    k, n = 256, 96
    x = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32) * 3)
    qt = tcore.quantize(torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32) * 0.05),
                        bits=8, group_size=0)
    qt.act_bits = 8
    xq, sx = tcore.quantize_activation(x)
    acc = tcore.int_mm_rows(xq, qt.q)
    ref = torch.matmul(xq.to(torch.float64), qt.q.to(torch.float64))
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (b, n)
    assert torch.equal(acc.to(torch.float64), ref)
    scale = qt.scale[0][None, :].to(torch.float32)
    calls = (tcore.w8a8_int_mm_calls, tcore.w8a8_float64_calls)
    out = tcore._w8a8_matmul(x, qt)                      # the CPU takes float64
    assert torch.equal(out, acc.to(torch.float32) * sx * scale)
    assert (tcore.w8a8_int_mm_calls, tcore.w8a8_float64_calls) == (calls[0], calls[1] + 1)


def test_w8a8_codes_are_stored_k_major():
    """quantize_param_tree keeps W8A8 codes in K-major strides (torch._int_mm's
    fast layout on the card): the same shape and values as quantize's, and
    qmatmul gives the same bits as on row-major codes."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(256, 96)).astype(np.float32) * 0.05)
    tree = tcore.quantize_param_tree({"w_o": w}, bits=8, act_bits=8)
    qt = tree["w_o"]
    ref = tcore.quantize(w, bits=8, group_size=0)
    assert qt.q.stride() == (1, 256) and tuple(qt.q.shape) == (256, 96)
    assert torch.equal(qt.q, ref.q) and torch.equal(qt.scale, ref.scale)
    x = torch.from_numpy(rng.normal(size=(5, 256)).astype(np.float32))
    row = dataclasses.replace(qt, q=qt.q.contiguous())
    assert torch.equal(tcore.qmatmul(x, qt), tcore.qmatmul(x, row))
