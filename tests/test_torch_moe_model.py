"""The tiny Mixtral-style model's prefill, chunked prefill and decode steps in
tpuserve_torch against the JAX package's, int8 and packed int4 KV (split
from tests/test_torch_moe.py, whose helpers and fixtures it takes; the
tolerances are that file's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import (P_J, P_T, _knobs, _quantized, _same_routes,  # noqa: F401
                            jax_kernels, routes)
from tpuserve.models import llama as jllama
from tpuserve_torch.models import llama as tllama
from torch_parity import to_np


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
