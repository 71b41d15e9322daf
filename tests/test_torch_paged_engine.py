"""The paged engine of tpuserve_torch against the JAX package's (split from
tests/test_torch_paged.py, which holds the allocator, the paged kernel's
plain version and the paged model functions):

- (e) the paged engine (chunked prefill, prefix sharing) against the JAX
  paged engine: identical greedy tokens;
- (f) page exhaustion fails a request with kv_pages_exhausted, no hang;
- (g) prefill_chunk not a multiple of page_size is refused.
"""

import threading
import time

import pytest

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.serving.engine import GenerationEngine as JEngine
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, write_model


# ------------------------------------------------------------ (e)-(g) engine
def _paged_config(name, kv_cache="int8", **gen):
    generation = dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=8,
                      prefill_chunk=32, decode_horizon=2, paged=True, page_size=16,
                      prefix_sharing=True)
    generation.update(gen)
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": kv_cache},
            "generation": generation}


STEM = list(range(200, 220))
SHARED = [STEM + [7, 8, 9], STEM + [1, 2, 3, 4]]   # one full 16-token page in common
OTHERS = [list(range(30, 70)),                       # 40 tokens: chunks of 32 + 8
          [5, 17, 100, 42, 7],
          [511, 0, 256]]


def _settled_stats(engine, free_or_cached, timeout=30.0):
    """Serving stats once `free_or_cached` pages are free or cached: a
    retiring slot's pages go back on the scheduler's thread just after its
    request completes."""
    t_end = time.monotonic() + timeout
    while True:
        st = engine.serving_stats()
        if (st["kv_free_pages"] + st.get("prefix_cached_blocks", 0) == free_or_cached
                or time.monotonic() > t_end):
            return st
        time.sleep(0.01)


def _serve(engine, max_new=8):
    """The first shared prompt alone (it registers the prefix page), then
    the rest together."""
    out = []
    for batch in ([SHARED[0]], SHARED[1:] + OTHERS):
        reqs = [engine.submit(p, max_new_tokens=max_new) for p in batch]
        for r in reqs:
            assert r.done.wait(timeout=300), "request did not finish"
            assert r.error is None, r.error
            out.append(list(r.output_ids))
    return out


@pytest.mark.parametrize("kv_cache", ["int8", "int4"])
def test_paged_engine_greedy_tokens_match_jax(tmp_path, monkeypatch, kv_cache):
    cfg = _paged_config("paged", kv_cache)
    vdir = write_model(str(tmp_path), "paged", cfg)
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
    jeng = JEngine(vdir, JModelConfig.from_dict(cfg))
    jeng.start()
    try:
        ref = _serve(jeng)
    finally:
        jeng.stop()
    teng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    teng.start()
    try:
        out = _serve(teng)
        n_pages = teng.cache.n_pages
        stats = _settled_stats(teng, n_pages - 1)
    finally:
        teng.stop()
    assert out == ref and all(len(o) == 8 for o in out)
    assert stats["paged"] and stats["kv_page_size"] == 16
    assert stats["prefix_hit_tokens"] >= 16 and stats["prefix_hits"] >= 1
    # every page came back, except those of the cached prefix blocks
    assert stats["kv_free_pages"] + stats["prefix_cached_blocks"] == n_pages - 1


def test_page_exhaustion_fails_the_request(tmp_path):
    """Two slots growing past a 3-page pool: one request fails with
    kv_pages_exhausted, its pages go back, the other finishes."""
    cfg = _paged_config("tight", num_pages=4, max_slots=2, prefix_sharing=False,
                        max_new_tokens=40)
    vdir = write_model(str(tmp_path), "tight", cfg)
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=40) for p in ([5, 6, 7], [9, 8, 7, 6])]
        for r in reqs:
            assert r.done.wait(timeout=300), "request hung"
        failed = [r for r in reqs if r.error]
        done = [r for r in reqs if not r.error]
        assert len(failed) == 1 and len(done) == 1
        assert failed[0].finish_reason == "kv_pages_exhausted"
        assert "exhausted" in failed[0].error
        assert len(done[0].output_ids) == 40
        with pytest.raises(BackendError):
            eng.generate([1] * 50, max_new_tokens=20)   # 4 pages of 3
        assert _settled_stats(eng, 3)["kv_free_pages"] == 3
    finally:
        eng.stop()


def test_chunk_not_a_page_multiple_is_refused(tmp_path):
    cfg = _paged_config("badchunk", prefill_chunk=8)
    cfg["model_params"]["init"] = "random"   # the check follows weight loading
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match="multiple of page_size"):
        eng.start()


def test_paged_engine_concurrent_sampled(tmp_path):
    """Sampled and greedy requests together on the paged engine, one admitted
    in chunks: each finishes with its budget and the pool is whole after."""
    cfg = _paged_config("mixed", prefix_sharing=False)
    vdir = write_model(str(tmp_path), "mixed", cfg, seed=3)
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    results = {}
    try:
        def run(i, prompt, kw):
            results[i] = eng.generate(prompt, **kw)

        jobs = [(list(range(1, 41)), dict(max_new_tokens=6, temperature=0.8, top_p=0.9)),
                ([3, 1, 4], dict(max_new_tokens=7)),
                ([4, 4, 4], dict(max_new_tokens=5, temperature=0.5, top_k=5,
                                 repetition_penalty=1.3))]
        threads = [threading.Thread(target=run, args=(i, *job)) for i, job in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert [results[i]["num_generated"] for i in range(3)] == [6, 7, 5]
        n_free = eng.cache.n_pages - 1
        assert _settled_stats(eng, n_free)["kv_free_pages"] == n_free
    finally:
        eng.stop()
