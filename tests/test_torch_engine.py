"""The serving stack of tpuserve_torch: its GenerationEngine against the JAX
package's on one checkpoint, the InferenceManager -> LLMBackend entry
points, the device guard, and the no-JAX import boundary.
"""

import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.serving.engine import GenerationEngine as JEngine
from tpuserve_torch.engine.manager import InferenceManager
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name, **gen):
    generation = dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=8,
                      prefill_chunk=16, decode_horizon=2)
    generation.update(gen)
    return {
        "name": name, "platform": "llm", "architecture": "llama",
        "model_params": dict(SMALL),
        "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int4"},
        "generation": generation,
    }


PROMPTS = [
    [5, 17, 100, 42, 7],
    list(range(30, 70)),          # 40 tokens: chunked prefill (chunk 16)
    [3, 1, 4, 1, 5, 9, 2, 6],
    [511, 0, 256],
]


def _run(engine, prompts, max_new=8):
    results = [None] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    for i, r in enumerate(reqs):
        r.done.wait(timeout=300)
        assert r.error is None, r.error
        results[i] = list(r.output_ids)
    return results


def test_engine_greedy_tokens_match_jax(tmp_path, monkeypatch):
    """Both engines serve one checkpoint (int4 g128 weights, packed int4 KV):
    token-identical greedy outputs for concurrent requests, one of them
    admitted in chunks. The JAX engine runs its Pallas kernels in interpret
    mode, with decode_horizon 2 to keep its compile time down."""
    cfg = _config("parity")
    vdir = write_model(str(tmp_path), "parity", cfg)
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
    jeng = JEngine(vdir, JModelConfig.from_dict(cfg))
    jeng.start()
    try:
        ref = _run(jeng, PROMPTS)
    finally:
        jeng.stop()
    teng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    teng.start()
    try:
        out = _run(teng, PROMPTS)
        assert teng.serving_stats()["decode_horizon_last"] >= 1
    finally:
        teng.stop()
    assert all(len(o) == 8 for o in out)
    assert out == ref


def test_manager_backend_generate(tmp_path):
    """The entry point a REST handler calls: manager.get_model(..).backend
    .generate(..) — concurrent greedy and sampled requests, stop ids,
    logprobs, a chunked prompt, and a repeated greedy prompt."""
    cfg = _config("demo", decode_horizon=4, max_new_tokens=6)
    write_model(str(tmp_path), "demo", cfg, seed=1)
    mgr = InferenceManager(str(tmp_path), num_workers=1, device="cpu")
    try:
        mgr.load_model("demo")
        backend = mgr.get_model("demo").backend
        greedy = backend.generate([9, 8, 7], max_new_tokens=6)
        stop_tok = greedy["generated_ids"][2]
        jobs = {
            "greedy": dict(prompt_ids=[9, 8, 7], max_new_tokens=6),
            "sampled": dict(prompt_ids=list(range(1, 41)), max_new_tokens=5,
                            temperature=0.8, top_p=0.9),
            "stop": dict(prompt_ids=[9, 8, 7], max_new_tokens=6,
                         stop_token_ids=[stop_tok], logprobs=True),
            "penalty": dict(prompt_ids=[4, 4, 4], max_new_tokens=4, repetition_penalty=1.3,
                            top_k=5, temperature=0.5),
        }
        results = {}

        def run(name, kw):
            kw = dict(kw)
            results[name] = backend.generate(kw.pop("prompt_ids"), **kw)

        threads = [threading.Thread(target=run, args=item) for item in jobs.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert results["greedy"]["generated_ids"] == greedy["generated_ids"]
        assert results["sampled"]["num_generated"] == 5
        assert results["penalty"]["num_generated"] == 4
        stop = results["stop"]
        assert stop["finish_reason"] == "stop" and stop["generated_ids"][-1] == stop_tok
        n_stop = greedy["generated_ids"].index(stop_tok) + 1
        assert stop["num_generated"] == n_stop and len(stop["logprobs"]) == n_stop
        assert all(lp <= 0.0 for lp in stop["logprobs"])
        status = mgr.get_model_status("demo")
        assert status["state"] == "LOADED" and status["stats"]["memory_usage_bytes"] > 0
    finally:
        mgr.shutdown()


def test_entry_points_refuse_to_fall_back_to_cpu(tmp_path, monkeypatch):
    """Without a card, asking for "cuda" (the default) raises; nothing runs
    on the CPU unless the caller passes device="cpu". The manager touches no
    device until a model loads (a front lists the repository without a
    card): its load raises the engine's error and leaves the model in
    ERROR, never loaded on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config("guard")
    vdir = write_model(str(tmp_path), "guard", cfg)
    mgr = InferenceManager(str(tmp_path), num_workers=1)
    try:
        assert mgr.device == torch.device("cuda")
        with pytest.raises(BackendError, match="device='cpu'"):
            mgr.load_model("guard")
        assert mgr.get_model_state("guard").value == "ERROR"
        assert not mgr.is_model_loaded("guard") and mgr.loaded_models() == []
    finally:
        mgr.shutdown()
    with pytest.raises(BackendError, match="device='cpu'"):
        GenerationEngine(vdir, ModelConfig.from_dict(cfg))


@pytest.mark.parametrize("overrides,ported", [
    ({"generation.paged": True, "generation.speculation_tokens": 4}, True),
    ({"generation.speculation_tokens": 4}, True),
    ({"sharding.tensor_parallel": 2}, True),
    ({"quantization.method": "gptq"}, True),
    ({"quantization.method": "gptq", "quantization.lowrank_correction": 16}, True),
    ({"model_params.n_experts": 4}, True),
    ({"sharding.pipeline_parallel": 2, "generation.prefill_chunk": 0,
      "quantization.kv_cache": "int8"}, True),
    ({"sharding.tensor_parallel": 2, "model_params.n_kv_heads": 1,
      "quantization.kv_cache": "int8"}, True),
], ids=["generation.paged-True", "generation.speculation_tokens-4",
        "sharding.tensor_parallel-2", "quantization.method-gptq",
        "quantization.lowrank_correction-16", "model_params.n_experts-4",
        "sharding.pipeline_parallel-2", "kv_heads-1-over-tensor_parallel-2"])
def test_unported_configurations_raise(tmp_path, overrides, ported):
    """Unported parts raise instead of running something else. Speculative
    decoding, paged or contiguous, MoE, GPTQ, LoRC, tensor parallelism and
    pipeline_parallel (the engine's own follower rank, which fails alike;
    the pipeline with what the JAX engine composes it with: no
    prefill_chunk, int8 KV) and a tp that does not divide n_kv_heads (int8
    KV: every kv head on every rank) are ported: their configurations pass
    the check and go on to load the model (which fails here: the directory
    holds no checkpoint)."""
    cfg = _config("unported")
    for field, value in overrides.items():
        section, key = field.split(".")
        cfg.setdefault(section, {})[key] = value
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match="no checkpoint" if ported else "not ported"):
        eng.start()


def test_import_leaves_jax_out():
    """`import tpuserve_torch`, its serving stack, its quantizers (GPTQ), its
    front (REST, gRPC, the CLI, the soak script), its accuracy script, the
    model zoo (the registry with its builtins), the four backends, the ONNX
    importer, the fixtures, the batcher, sharded serving (parallel/, the
    follower), the checkpoint and speculation scripts (convert_hf_llama,
    eval_real_ppl, spec_bench, spec_trace, verify_profile) and the kernel
    grid (kernel_smoke) import neither JAX nor any module of the JAX
    package."""
    code = (
        "import sys\n"
        "import tpuserve_torch, tpuserve_torch.interop, tpuserve_torch.kernels\n"
        "from tpuserve_torch.engine.manager import InferenceManager\n"
        "from tpuserve_torch.engine import backend, llm_backend\n"
        "from tpuserve_torch.serving import engine, paged_kv, sampling\n"
        "from tpuserve_torch.models import llama, llama_bench, synthetic\n"
        "from tpuserve_torch.quant import gptq\n"
        "import tpuserve_torch.scripts.eval_accuracy\n"
        "from tpuserve_torch.ops import decode_attention, quant_matmul\n"
        "from tpuserve_torch.device import info, smoke\n"
        "import tpuserve_torch.server, tpuserve_torch.server.http, tpuserve_torch.server.grpc\n"
        "import tpuserve_torch.server.__main__, tpuserve_torch.server.tpuserve_pb2\n"
        "import tpuserve_torch.scripts.soak\n"
        "from tpuserve_torch.models import registry, layers, mlp, bert, densenet, resnet\n"
        "from tpuserve_torch.engine import jax_backend, onnx_backend, torch_backend, batcher\n"
        "import tpuserve_torch.onnx, tpuserve_torch.onnx.proto, tpuserve_torch.onnx.importer\n"
        "import tpuserve_torch.fixtures, tpuserve_torch.utils.checkpoint\n"
        "from tpuserve_torch.parallel import mesh, sharding, distributed, dispatcher, pipeline\n"
        "import tpuserve_torch.server.follower\n"
        "from tpuserve_torch.scripts import convert_hf_llama, eval_real_ppl, spec_bench\n"
        "from tpuserve_torch.scripts import spec_trace, verify_profile, kernel_smoke\n"
        "registry._ensure_builtins()\n"
        "assert {'mlp', 'bert', 'densenet121', 'resnet50', 'llama'} <= "
        "set(registry.known_architectures())\n"
        "backend._ensure_builtins()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'tpuserve' or m.startswith('tpuserve.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
