"""The slice as a whole: tpuserve_torch.models.llama against
tpuserve.models.llama with the JAX package's kernels forced on.

On the CPU the JAX package sends decode attention and qmatmul to XLA
einsums (a different algorithm: bf16 dots, no q or P requant). So the JAX
side here runs its Pallas kernels in interpret mode (as
tests/test_decode_attention.py does), the port runs its kernels' plain
versions, and both get the same int4 weights, carried across by
tpuserve_torch.interop. prefill, prefill_chunk and several decode_steps
must give close logits and identical greedy tokens, for int8 and int4 KV
caches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve_torch import interop
from tpuserve_torch.models import llama as tllama
from torch_parity import SMALL, jax_to_torch_params, numpy_weights, to_np

P_J = jllama.LlamaParams(**SMALL)
P_T = tllama.LlamaParams(**SMALL)
SLOTS, MAX_LEN, CHUNK = 4, 64, 16


@pytest.fixture()
def jax_kernels(monkeypatch):
    """Force the JAX package onto its kernels (interpret mode on the CPU)."""
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


@pytest.fixture(scope="module")
def weights():
    """int4 g128 weights quantized by the JAX package; the port gets the
    same bytes through interop."""
    raw = jllama.fuse_params({k: jnp.asarray(v) for k, v in numpy_weights().items()}, P_J)
    jp = jcore.quantize_param_tree(
        raw, bits=4, group_size=128,
        predicate=lambda name, a: a.ndim == 2 and name.endswith("kernel"))
    return jp, jax_to_torch_params(jp)


def _caches(kv_bits):
    jc = jllama.KVCache.create(P_J, SLOTS, MAX_LEN, quantized=True, flat=True,
                               kv_bits=kv_bits)
    tc = tllama.KVCache.create(P_T, SLOTS, MAX_LEN, quantized=True, kv_bits=kv_bits,
                               device="cpu")
    return jc, tc


def _close(out, ref, what):
    # f32 model, same algorithms: the two differ by f32 summation order
    # (~1e-6 relative), and at ~1 in 10^3 K/V elements that difference tips
    # a value across a rounding boundary of the KV quantizer, so the code
    # moves by one scale step. Measured here: up to 2.2e-3 of the logit
    # range with int8 KV, 2.4e-4 with int4 KV; the bound leaves 4x
    tol = 1e-2 * float(np.abs(ref).max())
    err = float(np.abs(out - ref).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_prefill_chunk_decode_match_jax(weights, jax_kernels, kv_bits):
    jp, tp = weights
    jc, tc = _caches(kv_bits)
    rng = np.random.default_rng(7)
    short = rng.integers(0, SMALL["vocab_size"], 5)
    long = rng.integers(0, SMALL["vocab_size"], 40)

    # whole-prompt prefill into slot 0 (bucket 16)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :5] = short
    jl, jc = jllama.prefill(jp, P_J, jnp.asarray(toks), jc, jnp.int32(0), jnp.int32(5))
    tl, tc = tllama.prefill(tp, P_T, torch.from_numpy(toks).long(), tc, 0, 5)
    _close(to_np(tl), np.asarray(jl), "prefill")
    first = [int(np.argmax(np.asarray(jl)[0])), 0, 0, -1]
    assert int(torch.argmax(tl[0])) == first[0]

    # chunked prefill of the long prompt into slot 2 (windows as the engine)
    for c0 in range(0, len(long), CHUNK):
        n = min(CHUNK, len(long) - c0)
        window = 16
        while window < min(c0 + CHUNK, MAX_LEN):
            window *= 2
        ct = np.zeros((1, CHUNK), np.int32)
        ct[0, :n] = long[c0:c0 + n]
        jl, jc = jllama.prefill_chunk(jp, P_J, jnp.asarray(ct), jc, jnp.int32(2),
                                      jnp.int32(c0), jnp.int32(n), window=window)
        tl, tc = tllama.prefill_chunk(tp, P_T, torch.from_numpy(ct).long(), tc, 2, c0, n,
                                      window=window)
        _close(to_np(tl), np.asarray(jl), f"prefill_chunk {c0}")
    first[2] = int(np.argmax(np.asarray(jl)[0]))
    assert int(torch.argmax(tl[0])) == first[2]

    # the caches hold the same codes (a code may differ by one where the
    # f32 K/V values sit on a rounding boundary)
    for name in ("k", "v"):
        a = np.asarray(jllama.unpack_kv_codes(getattr(jc, name)) if kv_bits == 4
                       else getattr(jc, name)).astype(np.int32)
        b = to_np(tllama.unpack_kv_codes(getattr(tc, name)) if kv_bits == 4
                  else getattr(tc, name)).astype(np.int32)
        assert np.abs(a - b).max() <= 1
        assert (a != b).mean() < 1e-3
    # the JAX cache state carried across byte for byte
    carried = interop.kv_cache_from_numpy(*(np.asarray(t) for t in
                                            (jc.k, jc.v, jc.k_scale, jc.v_scale)),
                                          device="cpu")
    assert carried.k.dtype == tc.k.dtype and carried.k_scale.dtype == tc.k_scale.dtype
    np.testing.assert_array_equal(to_np(carried.k), np.asarray(jc.k))

    # 8 greedy decode steps; slots 1 and 3 stay inactive
    pos = np.array([5, -1, len(long), -1], np.int32)
    jt = np.array([first[0], 0, first[2], 0], np.int32)
    tt = jt.copy()
    j_seq, t_seq = [], []
    for step in range(8):
        jl, jc = jllama.decode_step(jp, P_J, jnp.asarray(jt), jc, jnp.asarray(pos))
        tl, tc = tllama.decode_step(tp, P_T, torch.from_numpy(tt).long(), tc,
                                    torch.from_numpy(pos))
        jl, tl = np.asarray(jl), to_np(tl)
        _close(tl, jl, f"decode step {step}")
        assert np.all(tl[[1, 3]] == 0.0)
        jt = np.argmax(jl, axis=-1).astype(np.int32)
        tt = np.argmax(tl, axis=-1).astype(np.int32)
        j_seq.append(jt[[0, 2]])
        t_seq.append(tt[[0, 2]])
        pos = np.where(pos >= 0, pos + 1, pos)
    np.testing.assert_array_equal(np.stack(t_seq), np.stack(j_seq))


def test_decode_never_writes_inactive_slots():
    """The port writes the cache in place and skips slots with position -1."""
    p = P_T
    params = tllama.fuse_params(tllama.init_params(p, dtype=torch.float32, device="cpu",
                                                   seed=1), p)
    cache = tllama.KVCache.create(p, 3, 32, quantized=True, kv_bits=4, device="cpu")
    cache.k.fill_(0x5A)
    cache.k_scale.fill_(7.0)
    pos = torch.tensor([3, -1, 0], dtype=torch.int32)
    tllama.decode_step(params, p, torch.tensor([1, 2, 3]), cache, pos)
    assert torch.all(cache.k[:, 1] == 0x5A) and torch.all(cache.k_scale[:, 1] == 7.0)
    assert not torch.all(cache.k[:, 0, 3] == 0x5A) and not torch.all(cache.k[:, 2, 0] == 0x5A)
    assert torch.all(cache.k_scale[:, 0, :, 3] != 7.0)
