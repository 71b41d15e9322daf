#!/usr/bin/env python3
"""7B-scale speculation benchmark on the card (the port of
scripts/spec_bench.py).

Runs the GenerationEngine at Llama-2-7B INT4 + INT8 KV (random int4
weights drawn on the device, `init: random_quantized`) with a REPETITIVE
workload (prompt-lookup speculation's favorable case: random-init models
echo n-gram structure enough for prompt-lookup drafts to land), a random
one and an adversarial one (random prompts at temperature 1.0), and
measures delivered tokens/s with speculation ON vs OFF plus the acceptance
rate, in ONE process back to back on one engine (speculation toggled by
the engine's `_spec_disabled` latch). Prints the JAX script's lines and
result keys; exits 1 when no draft fired on the repetitive workload.

Usage: python -m tpuserve_torch.scripts.spec_bench [--device cpu]

Env: TPUSERVE_SPEC_BENCH_{SLOTS,NEW,K,ROUNDS,HORIZON} (defaults 8, 192, 8,
4, 4); TPUSERVE_SPEC_BENCH_MODEL=small for a 2-layer model of 2048 tokens.
"""

import argparse
import concurrent.futures as cf
import json
import os
import sys
import tempfile
import time

import numpy as np

from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving.engine import GenerationEngine


def build(root: str, name: str, spec_k: int, rounds: int = 4,
          device: str = "cuda") -> GenerationEngine:
    vdir = os.path.join(root, name, "1")
    os.makedirs(vdir, exist_ok=True)
    slots = int(os.environ.get("TPUSERVE_SPEC_BENCH_SLOTS", "8"))
    cfg = {
        "name": name, "platform": "llm", "architecture": "llama",
        "inputs": [{"name": "input_ids", "shape": [1, -1], "data_type": "INT32"}],
        "outputs": [{"name": "output_ids", "shape": [1, -1], "data_type": "INT32"}],
        "model_params": (
            {"vocab_size": 2048, "dim": 256, "n_layers": 2, "n_heads": 4,
             "n_kv_heads": 4, "head_dim": 64, "ffn_dim": 512,
             "init": "random_quantized"}
            if os.environ.get("TPUSERVE_SPEC_BENCH_MODEL") == "small" else
            {"vocab_size": 32000, "dim": 4096, "n_layers": 32,
             "n_heads": 32, "n_kv_heads": 32, "head_dim": 128,
             "ffn_dim": 11008, "init": "random_quantized"}),
        "generation": {"max_seq_len": 512, "max_slots": slots,
                       "eos_token_id": -1, "max_new_tokens": 256,
                       "speculation_tokens": spec_k,
                       "speculation_rounds": rounds,
                       "decode_horizon": int(os.environ.get(
                           "TPUSERVE_SPEC_BENCH_HORIZON", "4"))},
        "quantization": {"weights": "int4", "group_size": 128,
                         "kv_cache": "int8"},
    }
    with open(os.path.join(vdir, "config.json"), "w") as f:
        json.dump(cfg, f)
    mc = ModelConfig.from_file(os.path.join(vdir, "config.json"))
    eng = GenerationEngine(vdir, mc, device=device)
    t0 = time.time()
    eng.start()
    print(f"# engine(spec_k={spec_k}) up in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)
    return eng


def _prompts(kind: str, slots: int, vocab: int):
    rng = np.random.default_rng(0)
    hi = vocab - 1
    if kind == "repetitive":
        period = rng.integers(100, hi, 12).tolist()
        return [(period * 10)[:96]] * slots  # periodic -> prompt-lookup hits
    # random: i.i.d. tokens, distinct per slot — no n-gram recurrences
    return [rng.integers(100, hi, 96).tolist() for _ in range(slots)]


def drive(eng: GenerationEngine, tag: str, kind: str,
          temperature: float = 0.0, warm: bool = True) -> dict:
    """Submit one prompt per slot and total the delivered tokens/s of the
    second of two waves (the first warms the caches and allocators; with
    `warm` False, of one wave: the port compiles nothing at first use).

    kinds: "repetitive" (periodic prompts — prompt-lookup's favorable
    case), "random" (i.i.d. prompts, greedy) and "adversarial" (random
    prompts at temperature 1.0: sampled tokens build no recurring n-grams,
    so the match gate and break-even guard must hold the engine at plain
    decode throughput)."""
    prompts = _prompts("random" if kind == "adversarial" else kind,
                       eng.n_slots, eng.p.vocab_size)
    new_tokens = int(os.environ.get("TPUSERVE_SPEC_BENCH_NEW", "192"))
    slots = eng.n_slots

    def wave():
        t0 = time.time()
        with cf.ThreadPoolExecutor(max_workers=slots) as ex:
            futs = [ex.submit(eng.generate, pr, max_new_tokens=new_tokens,
                              temperature=temperature, seed=1234)
                    for pr in prompts]
            outs = [f.result() for f in futs]
        dt = time.time() - t0
        produced = sum(o["num_generated"] for o in outs)
        return produced / dt, outs

    d0 = eng.spec_drafted   # drafts of both waves, as the JAX script counts them
    a0 = eng.spec_accepted
    if warm:
        wave()
    tps, _ = wave()
    drafted = eng.spec_drafted - d0
    accepted = eng.spec_accepted - a0
    acc = accepted / drafted if drafted else None
    print(f"# {tag}/{kind}: {tps:.0f} tok/s delivered"
          + (f", acceptance {acc:.2f} ({accepted}/{drafted})" if acc is not None else ""),
          file=sys.stderr, flush=True)
    return {"tokens_per_s": round(tps, 1), "spec_drafted": int(drafted),
            "spec_accepted": int(accepted),
            "acceptance": round(acc, 4) if acc is not None else None}


def run(device: str = "cuda", warm: bool = True) -> dict:
    """Speculation on and off over the three workloads on one engine; the
    JAX script's result dict (`warm`: see drive)."""
    k = int(os.environ.get("TPUSERVE_SPEC_BENCH_K", "8"))
    rounds = int(os.environ.get("TPUSERVE_SPEC_BENCH_ROUNDS", "4"))
    result = {"metric": "speculation_7b_int4", "spec_k": k,
              "spec_rounds": rounds}
    with tempfile.TemporaryDirectory() as root:
        eng = build(root, "spec7b", k, rounds=rounds, device=device)
        try:
            for key, kind, temp in [("repetitive", "repetitive", 0.0),
                                    ("random", "random", 0.0),
                                    ("adversarial_t1", "adversarial", 1.0)]:
                eng._spec_disabled = False
                on = drive(eng, f"spec ON k={k} R={rounds}", kind,
                           temperature=temp, warm=warm)
                eng._spec_disabled = True
                off = drive(eng, "spec OFF", kind, temperature=temp, warm=warm)
                eng._spec_disabled = False
                result[key] = {"spec_off": off, "spec_on": on,
                               "speedup": round(on["tokens_per_s"]
                                                / off["tokens_per_s"], 3)}
        finally:
            eng.stop()
    return result


def report(result: dict) -> dict:
    """The JAX script's lines for a result of run(); exits 1 when no draft
    fired on the repetitive workload."""
    on_rep = result["repetitive"]["spec_on"]
    print(json.dumps(result), flush=True)
    if on_rep["spec_drafted"] == 0:
        print("SPEC_BENCH FAILED: no drafts fired on the repetitive "
              "workload", file=sys.stderr)
        sys.exit(1)
    # the JAX script's targets: >=1.8x on a favorable (high-acceptance)
    # workload, no regression (>=0.97x) when drafts cannot land
    fav = max(result["repetitive"]["speedup"], result["random"]["speedup"])
    adv = result["adversarial_t1"]["speedup"]
    print(f"# targets: favorable {fav:.3f} (>=1.8 {'PASS' if fav >= 1.8 else 'MISS'})"
          f" | adversarial {adv:.3f} (>=0.97 {'PASS' if adv >= 0.97 else 'MISS'})",
          file=sys.stderr)
    print("SPEC_BENCH DONE", file=sys.stderr)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return report(run(ap.parse_args(argv).device))


if __name__ == "__main__":
    main()
