"""Speculative decoding in tpuserve_torch's engine against the JAX
package's (split from tests/test_torch_spec.py, which holds the kernel,
drafting, acceptance and verify_step parity): greedy speculative tokens
equal the port's plain tokens and the JAX engine's speculative tokens in
fused, single-round and paged modes; sampled slots; the fused rounds at the
sequence's capacity; verify widths the kernel refuses; a verify that raises.
The penalty, n-gram gate, break-even guard, capacity and EOS cases are in
tests/test_torch_spec_limits.py.
"""

import numpy as np
import pytest

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.serving.engine import GenerationEngine as JEngine
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, write_model


# ------------------------------------------------------------ (f) engine
def _config(name, **gen):
    generation = dict(max_seq_len=128, max_slots=3, eos_token_id=-1, max_new_tokens=24,
                      prefill_chunk=32, decode_horizon=4)
    generation.update(gen)
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int8"},
            "generation": generation}


def _serve(engine, prompts, n=24, **kw):
    reqs = [engine.submit(p, max_new_tokens=n, **kw) for p in prompts]
    for r in reqs:
        assert r.done.wait(timeout=300), "request did not finish"
        assert r.error is None, r.error
    return [list(r.output_ids) for r in reqs], [r.finish_reason for r in reqs]


def _port(tmp_path, name, prompts, n=24, kw=None, **gen):
    cfg = _config(name, **gen)
    vdir = write_model(str(tmp_path), name, cfg)
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        out, reasons = _serve(eng, prompts, n, **(kw or {}))
        stats = _settled(eng)
        # a verify that raised would pass unseen: plain decode gives the
        # same greedy tokens
        assert not eng._spec_disabled
    finally:
        eng.stop()
    return out, reasons, stats


def _settled(eng, timeout=30.0):
    """Serving stats once a paged engine's pages are all back (a slot's pages
    go back on the scheduler's thread just after its request completes)."""
    import time

    t_end = time.monotonic() + timeout
    while True:
        st = eng.serving_stats()
        if not st["paged"] or time.monotonic() > t_end or \
                st["kv_free_pages"] + st.get("prefix_cached_blocks", 0) == eng.cache.n_pages - 1:
            return st
        time.sleep(0.01)


# The head of write_model's weights is the embedding under a permutation,
# so greedy decoding walks a fixed chain of tokens with wide margins. A
# prompt holding that chain after its own tail (P + chain + P) makes the
# lookup draft the chain, and greedy acceptance take it.
STEM = [5, 17, 100, 42, 7]


@pytest.fixture(scope="module")
def spec_prompts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain")
    (chain,), _, _ = _port(tmp, "chain", [STEM])
    return [STEM + chain + STEM, [3, 1, 4, 1, 5, 9, 2, 6], [9, 9, 8, 8, 7, 7] * 3]


@pytest.fixture(scope="module")
def plain_tokens(tmp_path_factory, spec_prompts):
    out, _, stats = _port(tmp_path_factory.mktemp("plain"), "plain", spec_prompts)
    assert "spec_drafted" not in stats
    return out


SPEC_MODES = {
    "fused": dict(speculation_tokens=4, speculation_rounds=4, speculation_min_gain=0),
    "single": dict(speculation_tokens=4, speculation_rounds=1),
    "paged": dict(speculation_tokens=4, paged=True, page_size=16, prefix_sharing=True),
}


@pytest.mark.parametrize("mode", list(SPEC_MODES))
def test_spec_engine_greedy_matches_plain_and_jax(tmp_path, monkeypatch, spec_prompts,
                                                  plain_tokens, mode):
    """Greedy speculative tokens equal the port's plain tokens and the JAX
    engine's speculative tokens (its kernels forced on, interpret mode);
    drafts were accepted, and in paged mode every page came back."""
    out, _, stats = _port(tmp_path, mode, spec_prompts, **SPEC_MODES[mode])
    assert out == plain_tokens
    assert stats["spec_drafted"] > 0 and stats["spec_accepted"] > 0
    if mode == "paged":   # every page back: 3 slots x 8 pages, page 0 reserved
        assert stats["kv_free_pages"] + stats["prefix_cached_blocks"] == 3 * 8
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
    cfg = _config(f"j{mode}", **SPEC_MODES[mode])
    jeng = JEngine(write_model(str(tmp_path), f"j{mode}", cfg), JModelConfig.from_dict(cfg))
    jeng.start()
    try:
        ref, _ = _serve(jeng, spec_prompts)
        jstats = jeng.serving_stats()
    finally:
        jeng.stop()
    assert out == ref
    assert jstats["spec_drafted"] > 0


def test_sampled_slots_speculate(tmp_path, spec_prompts, plain_tokens):
    """temperature > 0 speculates through rejection sampling: top_k = 1 is a
    point mass, so its tokens are the greedy ones and drafts are accepted;
    free sampling completes its budget."""
    out, _, stats = _port(tmp_path, "topk1", spec_prompts, kw=dict(temperature=0.9, top_k=1),
                          **SPEC_MODES["fused"])
    assert out == plain_tokens and stats["spec_accepted"] > 0
    out, reasons, _ = _port(tmp_path, "free", spec_prompts, n=12, kw=dict(temperature=0.8),
                            **SPEC_MODES["fused"])
    assert [len(o) for o in out] == [12] * 3 and set(reasons) == {"max_new_tokens"}


def test_fused_rounds_run_past_capacity(tmp_path):
    """A slot that enters the fused rounds within rounds - 1 positions of
    max_seq_len (its k_cap is 0) still moves one position a round, past
    max_seq_len, while another slot drafts: its history appends clamp to
    the buffer's last column instead of indexing past it."""
    cfg = _config("edge", max_seq_len=64, **SPEC_MODES["fused"])
    eng = GenerationEngine(write_model(str(tmp_path), "edge", cfg), ModelConfig.from_dict(cfg),
                           device="cpu")
    eng.start()
    try:
        # period-8 histories: slot 1's trailing 3-gram recurs 4+ tokens back
        eng._hist_np = np.tile(np.arange(1, 9, dtype=np.int64), (3, 8))
        g, _, _, keff = eng._dev_spec_rounds(np.array([1, 1, 0]), np.array([63, 16, -1], np.int32),
                                             np.array([0, 4, 0]), window=64, rounds=4)
    finally:
        eng.stop()
    assert g.shape == (4, 3, 5)
    assert (keff[:, 0] == 0).all() and keff[0, 1] == 4


@pytest.mark.parametrize("spec_k,n_heads,kv", [(16, 4, "int8"), (15, 8, "int4")])
def test_verify_width_the_kernel_refuses_fails_at_load(tmp_path, monkeypatch, spec_k, n_heads,
                                                       kv):
    """More than 16 candidates, or 16 candidates of 8 query heads per block
    (GQA rep 4, int4 KV) over 2048-row blocks (TPUSERVE_ATTN_BLOCK_L: past
    the H100's 227 KiB of shared memory; the Hopper core serves them at
    the default 128), fail at start rather than at the first verify; paged
    mode, whose verify runs no kernel, takes them."""
    cfg = _config("wide", speculation_tokens=spec_k)
    cfg["model_params"]["n_heads"] = n_heads
    cfg["quantization"]["kv_cache"] = kv
    if n_heads == 8:
        GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")._check_supported()
        monkeypatch.setenv("TPUSERVE_ATTN_BLOCK_L", "2048")
    with pytest.raises(BackendError, match="speculation_tokens"):
        GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu").start()
    cfg["generation"].update(paged=True, page_size=16)
    GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")._check_supported()


def test_failed_verify_disables_speculation(tmp_path, spec_prompts, plain_tokens, monkeypatch):
    """A verify that raises turns speculation off for the engine's lifetime,
    logs an error, and plain decoding serves the requests to the end."""
    def boom(*a, **kw):
        raise RuntimeError("verify failed")

    monkeypatch.setattr(tllama, "verify_step", boom)
    cfg = _config("boom", **SPEC_MODES["fused"])
    eng = GenerationEngine(write_model(str(tmp_path), "boom", cfg), ModelConfig.from_dict(cfg),
                           device="cpu")
    eng.start()
    try:
        out, _ = _serve(eng, spec_prompts)
        assert eng._spec_disabled
    finally:
        eng.stop()
    assert out == plain_tokens
