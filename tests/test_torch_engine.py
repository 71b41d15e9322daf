"""The serving stack of tpuserve_torch: its GenerationEngine against the JAX
package's on one checkpoint, the InferenceManager -> LLMBackend entry
points, the device guard, and the no-JAX import boundary.
"""

import json
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
from torch_parity import SMALL

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


def _write_model(root, name, cfg, seed=0):
    """One version dir holding config.json and a model.safetensors written
    from a numpy seed. The spread of the weights makes greedy margins far
    larger than the two packages' rounding differences."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d, f, v = SMALL["dim"], SMALL["ffn_dim"], SMALL["vocab_size"]
    qd = SMALL["n_heads"] * SMALL["head_dim"]
    kvd = SMALL["n_kv_heads"] * SMALL["head_dim"]

    def n(*shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    # A bf16 model hands out bf16 logits, and with a Gaussian head the top
    # two of a step fall within one bf16 step of each other at ~1 step in
    # 10, where the packages' rounding differences decide the argmax. So
    # the head is the embedding under a permutation: the residual stream
    # carries the fed token e_t, whose logit for token perm^-1(t) is ~16
    # while the rest are ~N(0, 1) plus what the layers add. Greedy decoding
    # walks a token chain with margins of many bf16 steps.
    emb = n(v, d, std=1.0)
    perm = rng.permutation(v)
    w = {"embed/weight": emb, "final_norm/scale": np.ones((d,), np.float32),
         "lm_head/kernel": np.ascontiguousarray(emb[perm].T / np.sqrt(d))}
    for l in range(SMALL["n_layers"]):
        pre = f"layers.{l}"
        w[f"{pre}/attn_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/mlp_norm/scale"] = np.ones((d,), np.float32)
        for nm, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                          ("w_gate", (d, f)), ("w_up", (d, f))):
            w[f"{pre}/{nm}/kernel"] = n(*shape, std=1.0 / np.sqrt(d))
        w[f"{pre}/wo/kernel"] = n(qd, d, std=1.0 / np.sqrt(qd))
        w[f"{pre}/w_down/kernel"] = n(f, d, std=1.0 / np.sqrt(f))
    vdir = os.path.join(root, name, "1")
    os.makedirs(vdir)
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    save_file(w, os.path.join(vdir, "model.safetensors"))
    return vdir


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
    vdir = _write_model(str(tmp_path), "parity", cfg)
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
    _write_model(str(tmp_path), "demo", cfg, seed=1)
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
    on the CPU unless the caller passes device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config("guard")
    vdir = _write_model(str(tmp_path), "guard", cfg)
    with pytest.raises(BackendError, match="device='cpu'"):
        InferenceManager(str(tmp_path), num_workers=1)
    with pytest.raises(BackendError, match="device='cpu'"):
        GenerationEngine(vdir, ModelConfig.from_dict(cfg))


@pytest.mark.parametrize("field,value", [
    ("generation.paged", True),
    ("generation.speculation_tokens", 4),
    ("sharding.tensor_parallel", 2),
    ("quantization.method", "gptq"),
    ("model_params.n_experts", 4),
])
def test_unported_configurations_raise(tmp_path, field, value):
    cfg = _config("unported")
    section, key = field.split(".")
    cfg.setdefault(section, {})[key] = value
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match="not ported"):
        eng.start()


def test_import_leaves_jax_out():
    """`import tpuserve_torch` and its serving stack import neither JAX nor
    any module of the JAX package."""
    code = (
        "import sys\n"
        "import tpuserve_torch, tpuserve_torch.interop, tpuserve_torch.kernels\n"
        "from tpuserve_torch.engine.manager import InferenceManager\n"
        "from tpuserve_torch.engine import backend, llm_backend\n"
        "from tpuserve_torch.serving import engine, sampling\n"
        "from tpuserve_torch.models import llama, llama_bench\n"
        "from tpuserve_torch.device import info, smoke\n"
        "backend._ensure_builtins()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'tpuserve' or m.startswith('tpuserve.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
