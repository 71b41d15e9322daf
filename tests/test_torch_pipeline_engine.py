"""The engine under pipeline_parallel and with paged KV under a tp/dp mesh,
its ranks spawned gloo processes on the CPU (the engine starts its own
follower ranks, as the JAX package's single-host mesh), against the
one-rank engine on the same checkpoint.

- pp 2 (int8 KV on the 5D stage caches), pp 2 x tp 2, dp 2 x pp 2, pp 2 x
  sp 2, pp 2 on the 5D paged pool and pp 2 x MoE: greedy tokens equal to
  the one-rank engine's, and each rank's stage-block checksum equal to the
  cut of the one-rank engine's weights;
- paged KV under tensor_parallel 2 and data_parallel 2 with prefix
  sharing: the controller's page tables reach the follower ranks on the
  bus, a prompt admitted on one dp group reads the prefix pages another
  group's prefill wrote, and the tokens equal the one-rank engine's;
- every JAX engine refusal of a pipeline composition raises its message
  before any rank starts.

Every spawned rank runs under a timeout (TPUSERVE_DIST_TIMEOUT 60 s).
"""

import pytest
import torch

from tpuserve_torch.parallel.mesh import Mesh
from tpuserve_torch.parallel.pipeline import place_pipeline_params, stack_layer_params
from tpuserve_torch.parallel.sharding import block_fingerprint
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving import engine as engine_mod
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, write_model

DEADLINE = 120
PREFIX = list(range(40, 60))   # more than one 16-token page
PROMPTS = [[5, 17, 100, 42, 7], list(range(30, 70)), [3, 1, 4, 1, 5, 9, 2, 6],
           PREFIX + [1, 2]]
SHARED = [PREFIX + [3], [9, 8, 7, 6], PREFIX + [4, 5, 6], [11, 12]]

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ranks_env(monkeypatch):
    monkeypatch.setenv("TPUSERVE_DIST_TIMEOUT", "60")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for key in ("TPUSERVE_COORDINATOR", "TPUSERVE_NUM_PROCESSES", "TPUSERVE_PROCESS_ID",
                "TPUSERVE_ENGINE_RANK"):
        monkeypatch.delenv(key, raising=False)
    yield
    assert engine_mod._MH_LIVE_ENGINE is None


def _config(name, sharding, kv="int8", **gen):
    """SMALL with 4 kv heads and 4 layers; no prefill chunks (the pipeline
    composes with none, as in the JAX engine)."""
    generation = dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=6,
                      prefill_chunk=0)
    generation.update(gen)
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL, n_kv_heads=4, n_layers=4),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": kv},
            "generation": generation, "sharding": sharding}


def _generate(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
    out = []
    for r in reqs:
        assert r.done.wait(timeout=DEADLINE), "a request did not finish"
        assert r.error is None, r.error
        out.append(list(r.output_ids))
    return out


def _serve(vdir, cfg, prompts):
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        tokens = _generate(eng, prompts)
        return tokens, eng.rank_stats(), eng.serving_stats(), \
            (eng.params if eng.mesh is None else None)
    finally:
        eng.stop()


PIPELINES = {
    "pp2": ({"pipeline_parallel": 2}, {}),
    "pp2tp2": ({"pipeline_parallel": 2, "tensor_parallel": 2}, {}),
    "dp2pp2": ({"pipeline_parallel": 2, "data_parallel": 2}, {}),
    "pp2sp2": ({"pipeline_parallel": 2, "sequence_parallel": 2}, {}),
    "pp2paged": ({"pipeline_parallel": 2}, {"paged": True, "page_size": 16}),
    "pp2moe": ({"pipeline_parallel": 2}, {}),
}


@pytest.mark.parametrize("case", list(PIPELINES))
def test_pipeline_engine_matches_one_rank(tmp_path, case):
    """The engine at each pipeline layout serves the one-rank engine's
    greedy tokens; every rank's stage block is the cut of the one-rank
    engine's weights (block checksums), and it holds n_layers/pp layers."""
    sharding, gen = PIPELINES[case]
    cfg = _config(case, sharding, **gen)
    if case == "pp2moe":   # a seeded MoE model (4 experts, top-2): no checkpoint
        cfg["model_params"].update(n_experts=4, init="random_quantized", seed=0)
    vdir = write_model(str(tmp_path), case, cfg)
    ref, _, _, weights = _serve(vdir, dict(cfg, sharding={}), PROMPTS)
    got, ranks, stats, _ = _serve(vdir, cfg, PROMPTS)
    assert got == ref
    pp = sharding["pipeline_parallel"]
    tp, dp, sp = (sharding.get(k, 1) for k in ("tensor_parallel", "data_parallel",
                                                "sequence_parallel"))
    assert stats["mesh"]["pp"] == pp and stats["mesh"]["world"] == pp * tp * dp * sp
    from tpuserve_torch.models.llama import LlamaParams

    p = LlamaParams.from_dict(cfg["model_params"])
    stacked = stack_layer_params(weights, p, tp=tp)
    for r, st in enumerate(ranks):
        blk = place_pipeline_params(stacked, Mesh(tp, dp, sp, r, pp=pp))
        assert st["param_fingerprint"] == block_fingerprint(blk), r
        assert blk["stacked_layers/wqkv/kernel"].q.shape[0] == p.n_layers // pp


@pytest.mark.parametrize("sharding", [{"tensor_parallel": 2}, {"data_parallel": 2}],
                         ids=["tp2", "dp2"])
def test_paged_mesh_engine_prefix_sharing(tmp_path, sharding):
    """Paged KV (int8 pool of 16-token pages, prefix sharing) under a mesh:
    two prompts share a 20-token prefix and land in slots 0 and 2 (dp 2:
    different dp groups), the second reusing the first one's prefix page;
    tokens equal the one-rank engine's and the prefix hit is counted."""
    cfg = _config("paged", sharding, paged=True, page_size=16, prefix_sharing=True)
    vdir = write_model(str(tmp_path), "paged", cfg)
    ref, _, _, _ = _serve(vdir, dict(cfg, sharding={}), SHARED)
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        got = _generate(eng, SHARED)
        stats = eng.serving_stats()
        assert eng.ptm is not None and len(eng._followers) == 1
    finally:
        eng.stop()
    assert got == ref
    assert stats["prefix_hits"] >= 1 and stats["prefix_hit_tokens"] >= 16


REFUSALS = {
    "pp_sp_tp": ({"pipeline_parallel": 2, "sequence_parallel": 2, "tensor_parallel": 2}, {},
                 "int8", "pipeline_parallel x sequence_parallel does not compose with "
                 "tensor_parallel"),
    "pp_paged_tp": ({"pipeline_parallel": 2, "tensor_parallel": 2}, {"paged": True},
                    "int8", "pipeline_parallel x paged KV requires tensor_parallel = "
                    "data_parallel = 1"),
    "pp_paged_dp": ({"pipeline_parallel": 2, "data_parallel": 2}, {"paged": True},
                    "int8", "pipeline_parallel x paged KV requires"),
    "pp_paged_prefix": ({"pipeline_parallel": 2}, {"paged": True, "prefix_sharing": True},
                        "int8", "does not compose with prefix_sharing"),
    "pp_chunk": ({"pipeline_parallel": 2}, {"prefill_chunk": 16}, "int8",
                 "pipeline_parallel does not compose with prefill_chunk"),
    "pp_layers": ({"pipeline_parallel": 3}, {}, "int8",
                  "n_layers 4 must divide by pipeline_parallel 3"),
    "pp_slots": ({"pipeline_parallel": 2, "data_parallel": 4}, {}, "int8",
                 "max_slots 4 must divide by pipeline_parallel\\*data_parallel 8"),
    "pp_tp_heads": ({"pipeline_parallel": 2, "tensor_parallel": 8}, {}, "int8",
                    "n_heads/n_kv_heads/ffn_dim must divide by tensor_parallel 8 under "
                    "pipeline_parallel"),
    "pp_tp_moe": ({"pipeline_parallel": 2, "tensor_parallel": 2}, {}, "int8",
                  "pipeline_parallel x tensor_parallel does not compose with MoE"),
    "pp_int4_kv": ({"pipeline_parallel": 2}, {}, "int4",
                   "kv_cache int4 does not compose with pipeline_parallel"),
    "paged_int4_dp": ({"data_parallel": 2}, {"paged": True}, "int4",
                      "paged kv_cache int4 is single-chip"),
    "paged_sp": ({"sequence_parallel": 2}, {"paged": True}, "int8",
                 "sequence_parallel does not compose with paged KV"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_jax_refusals_before_ranks(tmp_path, case):
    """Each composition the JAX engine refuses raises its message before
    any rank is started."""
    sharding, gen, kv, msg = REFUSALS[case]
    cfg = _config(case, sharding, kv=kv, page_size=16, **gen)
    if case == "pp_tp_moe":
        cfg["model_params"]["n_experts"] = 4
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match=msg):
        eng.start()
    assert eng._followers == [] and not torch.distributed.is_initialized()
