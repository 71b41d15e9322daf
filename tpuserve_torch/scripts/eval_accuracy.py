"""Quantization accuracy harness (port of scripts/eval_accuracy.py).

Each mode builds a Llama from a seed, quantizes it through the port's own
quantizers (round-to-nearest, GPTQ, LoRC, the KV cache's), runs both the
f32 model and the quantized one through the port's serving path, and
reports the next-token KL and perplexities against the JAX script's gates,
with its result keys (plus `device`) and its exit code (0 when the gate
passes, else 1):

- --synthetic SIZE (llama_1b|tiny): a random-init Llama, RTN or GPTQ
  (--quantizer); gate KL <= 0.02 nat.
- --outlier-eval SIZE: outlier-injected weights; int8, RTN, clip search,
  GPTQ int4 and GPTQ int8.
- --anisotropic-eval SIZE (llama_1b|llama_400m|tiny): the int4 headline
  gate on the anisotropic synthetic (models/synthetic.py): int8, RTN, clip
  search, GPTQ and GPTQ+LoRC-32; GPTQ must pass 0.02 nat and RTN fail it.
- --kv-cache-eval SIZE (llama_200m|tiny): prefill + decode through the KV
  cache, f32 cache against int8 with f32 and bf16 scales and int4.
- --kv-long-eval SIZE: the same at --ctx tokens of context, int8 and int4,
  teacher-forced on the f32 cache's greedy path.
- --model NAME: a Llama model of --repository, loaded through the port's
  repository and engine loader (f32), quantized per its config by RTN as
  the JAX script does; gate |delta ppl| <= 0.1. Any other architecture
  (the zoo's classifiers: resnet*, densenet*, bert, mlp) loads through the
  zoo backend's checkpoint reader and is held f32 against its config's
  weight quantization on synthetic inputs of the declared shape: top-1
  agreement and logit correlation, gate top-1 >= 0.995.

The synthetic checkpoints come from torch generators, so their numbers are
not the JAX script's; the structure and the gates are. Every mode runs on
--device (default cuda); with no card it raises, it never falls back.

    python -m tpuserve_torch.scripts.eval_accuracy --anisotropic-eval llama_1b --samples 64
    python -m tpuserve_torch.scripts.eval_accuracy --synthetic tiny --quantizer gptq --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpuserve_torch.models import llama
from tpuserve_torch.models.llama import KVCache, Llama, LlamaParams
from tpuserve_torch.quant.core import quantize, quantize_param_tree
from tpuserve_torch.quant.gptq import collect_and_quantize_llama
from tpuserve_torch.utils.device import resolve_device

_LLAMA_1B = LlamaParams(vocab_size=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=16,
                        head_dim=128, ffn_dim=5504)
_LLAMA_200M = LlamaParams(vocab_size=8192, dim=768, n_layers=8, n_heads=12, n_kv_heads=12,
                          head_dim=64, ffn_dim=2048)
_LLAMA_400M = LlamaParams(vocab_size=32000, dim=1024, n_layers=8, n_heads=8, n_kv_heads=8,
                          head_dim=128, ffn_dim=2816)
_CFG_KEYS = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
             "ffn_dim", "rope_theta", "rms_eps", "tie_embeddings")


def _platform(dev: torch.device) -> str:
    return "gpu" if dev.type == "cuda" else "cpu"


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _arch(p: LlamaParams, dev: torch.device) -> Llama:
    return Llama({k: getattr(p, k) for k in _CFG_KEYS}, device=dev)


def _log_softmax(logits: np.ndarray) -> np.ndarray:
    m = logits.max(-1, keepdims=True)
    return logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))


def _logprobs(arch: Llama, params, tokens: np.ndarray) -> np.ndarray:
    out = arch.apply(params, {"input_ids": torch.from_numpy(tokens)})
    logits = out["logits"].to("cpu", torch.float64).numpy()[:, :-1, :]
    return _log_softmax(logits)


def _kl(a: np.ndarray, b: np.ndarray) -> float:
    return float((np.exp(a) * (a - b)).sum(-1).mean())


def _kernel_tree(params, bits: int, clip_search: bool):
    return {name: quantize(w, bits=bits, group_size=128, clip_search=clip_search)
            if w.ndim == 2 and name.endswith("kernel") else w
            for name, w in params.items()}


def _calib(p: LlamaParams, seed: int) -> np.ndarray:
    # a held-out draw from the evaluated token distribution, >= 2x the
    # largest contraction dim at llama_1b (ffn 5504)
    crng = np.random.default_rng(seed + 10_000)
    return crng.integers(0, p.vocab_size, (64, 256)).astype(np.int32)


def evaluate_synthetic(size: str, bits: int, group_size: int, act_bits: int,
                       samples: int, seed: int, quantizer: str = "rtn",
                       device="cuda") -> dict:
    """Quantization fidelity on a random-init Llama of a real size: relative
    perplexity delta, mean next-token KL(f32 || quant) (gated at 0.02 nat)
    and greedy agreement (reported only: random-init argmax margins are
    tiny)."""
    dev = resolve_device(device)
    p = {"llama_1b": _LLAMA_1B, "tiny": LlamaParams.tiny()}[size]
    params_fp = llama.init_params(p, dtype=torch.float32, device=dev, seed=seed)
    if quantizer == "gptq":
        if act_bits:
            raise SystemExit("gptq composes with bf16 activations only")
        params_q = collect_and_quantize_llama(
            params_fp, p, _calib(p, seed), bits=bits, group_size=group_size,
            progress=lambda n: print(f"# gptq {n}", file=sys.stderr, flush=True))
    else:
        params_q = quantize_param_tree(
            params_fp, bits=bits, group_size=group_size,
            predicate=lambda n, a: a.ndim == 2 and n.endswith("kernel"), act_bits=act_bits)

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, p.vocab_size, (max(1, samples // 16), 64)).astype(np.int32)
    arch = _arch(p, dev)
    lp_fp, lp_q = _logprobs(arch, params_fp, tokens), _logprobs(arch, params_q, tokens)
    targets = tokens[:, 1:]

    def ppl(lp):
        return float(np.exp(-np.take_along_axis(lp, targets[..., None], -1).mean()))

    base, quant = ppl(lp_fp), ppl(lp_q)
    kl = _kl(lp_fp, lp_q)
    top1 = float((lp_fp.argmax(-1) == lp_q.argmax(-1)).mean())
    return {
        "mode": "synthetic_random_init",
        "caveat": "no pretrained weights; absolute ppl ~ vocab_size, the gates "
                  "are the scale-free equivalents",
        "size": size,
        "quantization": {"weights": f"int{bits}", "group_size": group_size,
                         "activations": f"int{act_bits}" if act_bits else "none",
                         "quantizer": quantizer},
        "samples": samples,
        "ppl_fp32": round(base, 2),
        "ppl_quant": round(quant, 2),
        "ppl_rel_delta": round(quant / base - 1.0, 6),
        "kl_fp32_to_quant_nats": round(kl, 6),
        "greedy_top1_agreement": round(top1, 4),
        "top1_note": "reported only: random-init argmax margins ~1e-3, "
                     "flips are expected and uninformative here",
        "gate": "KL <= 0.02 nat",
        "gate_pass": bool(kl <= 0.02),
        "device": _device_name(dev),
    }


def _decode_logprobs(params, p, prompts: np.ndarray, dec: int, dev, quantized: bool,
                     scale_dtype=torch.float32, kv_bits: int = 8, teacher=None):
    """Prefill each prompt into a one-slot cache (f32 values), then `dec`
    decode steps; greedy on the step's own logits, or teacher-forced on
    `teacher` [n, dec]. Returns (log-probs [n, dec, V], path [n, dec])."""
    ctx = prompts.shape[1]
    lps, paths = [], []
    for b in range(prompts.shape[0]):
        cache = KVCache.create(p, 1, ctx + dec + 1, quantized=quantized, dtype=torch.float32,
                               scale_dtype=scale_dtype, kv_bits=kv_bits, device=dev)
        logits, cache = llama.prefill(params, p, torch.from_numpy(prompts[b:b + 1]).to(dev),
                                      cache, 0, ctx)
        tok = int(torch.argmax(logits[0])) if teacher is None else int(teacher[b, 0])
        row, path = [], []
        for t in range(dec):
            path.append(tok)
            lg, cache = llama.decode_step(params, p, torch.tensor([tok], device=dev), cache,
                                          torch.tensor([ctx + t], device=dev))
            lf = lg[0].to("cpu", torch.float64).numpy()
            row.append(_log_softmax(lf))
            if teacher is None:
                tok = int(lf.argmax())
            else:
                tok = int(teacher[b, t + 1]) if t + 1 < dec else 0
        lps.append(np.stack(row))
        paths.append(path)
    return np.stack(lps), np.asarray(paths)


def evaluate_kv_cache(size: str, scale_dtype: str, samples: int, seed: int,
                      device="cuda") -> dict:
    """The serving cache's fidelity: prefill + greedy decode through an f32
    cache against int8 KV with f32 or bf16 scales and packed int4 KV."""
    dev = resolve_device(device)
    p = {"llama_200m": _LLAMA_200M, "tiny": LlamaParams.tiny()}[size]
    params = llama.init_params(p, dtype=torch.float32, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    n_seq, ctx, dec = max(2, samples // 16), 48, 16
    prompts = rng.integers(0, p.vocab_size, (n_seq, ctx)).astype(np.int32)

    def run(quantized, sdt, kv_bits=8):
        return _decode_logprobs(params, p, prompts, dec, dev, quantized, sdt, kv_bits)[0]

    lp_fp = run(False, torch.float32)
    lp_f32 = run(True, torch.float32)
    lp_bf16 = run(True, torch.bfloat16)
    lp_i4 = run(True, torch.bfloat16, kv_bits=4)
    out = {
        "mode": "synthetic_random_init_kv_path",
        "size": size,
        "samples": n_seq * dec,
        "platform": _platform(dev),
        "kl_fp_cache_to_int8_f32_scales": round(_kl(lp_fp, lp_f32), 8),
        "kl_fp_cache_to_int8_bf16_scales": round(_kl(lp_fp, lp_bf16), 8),
        "kl_f32_scales_to_bf16_scales": round(_kl(lp_f32, lp_bf16), 8),
        "kl_fp_cache_to_int4": round(_kl(lp_fp, lp_i4), 8),
        "gate": "KL(fp||int8) <= 0.02 nat; bf16 scales add < 0.005 nat over f32; "
                "KL(fp||int4) <= 0.02 nat",
        "device": _device_name(dev),
    }
    out["gate_pass"] = bool(
        out["kl_fp_cache_to_int8_f32_scales"] <= 0.02
        and out["kl_fp_cache_to_int8_bf16_scales"] - out["kl_fp_cache_to_int8_f32_scales"] < 0.005
        and out["kl_fp_cache_to_int4"] <= 0.02)
    return out


def evaluate_outliers(size: str, samples: int, seed: int, device="cuda") -> dict:
    """int4 clip search and GPTQ on outlier-heavy weights: 1% of every
    projection's input rows scaled by lognormal(ln 8, 0.5) and 1% of the
    embedding channels by 10. Gates: GPTQ int8 KL <= 0.05 nat and GPTQ
    int4 / clip-search int4 KL < 0.97."""
    dev = resolve_device(device)
    p = {"llama_1b": _LLAMA_1B, "tiny": LlamaParams.tiny()}[size]
    params_fp = llama.init_params(p, dtype=torch.float32, device=dev, seed=seed)

    rng = np.random.default_rng(seed)
    chans = rng.choice(p.dim, max(1, p.dim // 100), replace=False)
    mult = np.ones((1, p.dim), np.float32)
    mult[0, chans] = 10.0
    params_fp["embed/weight"] = params_fp["embed/weight"] * torch.from_numpy(mult).to(dev)
    for name, w in list(params_fp.items()):
        if w.ndim == 2 and name.endswith("kernel"):
            k = w.shape[0]
            n_out = max(1, k // 100)
            rows = rng.choice(k, n_out, replace=False)
            factors = np.exp(rng.normal(np.log(8.0), 0.5, n_out)).astype(np.float32)
            m = np.ones((k, 1), np.float32)
            m[rows, 0] = factors
            params_fp[name] = w * torch.from_numpy(m).to(dev)

    tokens = rng.integers(0, p.vocab_size, (max(1, samples // 16), 64)).astype(np.int32)
    arch = _arch(p, dev)
    lp_fp = _logprobs(arch, params_fp, tokens)

    def kl_of(params):
        return _kl(lp_fp, _logprobs(arch, params, tokens))

    kl_int8 = kl_of(_kernel_tree(params_fp, 8, False))
    kl_rtn = kl_of(_kernel_tree(params_fp, 4, False))
    kl_clip = kl_of(_kernel_tree(params_fp, 4, True))
    calib = _calib(p, seed)
    kl_gptq = kl_of(collect_and_quantize_llama(params_fp, p, calib, bits=4, group_size=128))
    kl_int8_gptq = kl_of(collect_and_quantize_llama(params_fp, p, calib, bits=8,
                                                    group_size=128))
    ratio = kl_gptq / kl_clip if kl_clip > 0 else 1.0
    return {
        "mode": "synthetic_outlier_injected",
        "size": size,
        "outliers": "1% of input rows x lognormal(ln 8, 0.5) per projection "
                    "+ 1% of embed channels x10 (activation anisotropy)",
        "samples": samples,
        "kl_int8_g128": round(kl_int8, 6),
        "kl_int8_gptq": round(kl_int8_gptq, 6),
        "kl_int4_rtn": round(kl_rtn, 6),
        "kl_int4_clip_search": round(kl_clip, 6),
        "kl_int4_gptq": round(kl_gptq, 6),
        "gptq_vs_clip_ratio": round(ratio, 4),
        "gate": "calibrated (gptq) int8 KL <= 0.05 nat under outliers; "
                "int4 gptq/clip KL ratio < 0.97 (data-free int8 RTN "
                "reported ungated)",
        "gate_pass": bool(kl_int8_gptq <= 0.05 and ratio < 0.97),
        "device": _device_name(dev),
    }


def evaluate_anisotropic(size: str, samples: int, seed: int, device="cuda") -> dict:
    """The int4 headline gate on the anisotropic synthetic, where it can be
    passed and failed: GPTQ int4-g128 (or GPTQ+LoRC-32) KL <= 0.02 nat and
    RTN int4 KL > 0.02. write_scale is the JAX script's per-size anchor."""
    from tpuserve_torch.models.synthetic import init_params_anisotropic

    dev = resolve_device(device)
    p = {"llama_1b": _LLAMA_1B, "llama_400m": _LLAMA_400M, "tiny": LlamaParams.tiny()}[size]
    write_scale = {"llama_1b": 0.015, "llama_400m": 1.0}.get(size, 1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params_fp = init_params_anisotropic(gen, p, write_scale=write_scale)

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, p.vocab_size, (max(1, samples // 16), 64)).astype(np.int32)
    arch = _arch(p, dev)
    lp_fp = _logprobs(arch, params_fp, tokens)

    def kl_of(params):
        return _kl(lp_fp, _logprobs(arch, params, tokens))

    kl_int8 = kl_of(_kernel_tree(params_fp, 8, False))
    kl_rtn = kl_of(_kernel_tree(params_fp, 4, False))
    kl_clip = kl_of(_kernel_tree(params_fp, 4, True))
    calib = _calib(p, seed)
    kl_gptq = kl_of(collect_and_quantize_llama(params_fp, p, calib, bits=4, group_size=128))
    kl_lorc = kl_of(collect_and_quantize_llama(params_fp, p, calib, bits=4, group_size=128,
                                               lowrank_r=32))
    gate = 0.02
    return {
        "mode": "synthetic_anisotropic",
        "size": size,
        "structure": "low-rank residual subspace (rank dim/32, leak 0.08) + "
                     "1% massive embed channels x10 + 0.5% lognormal(ln 3, "
                     ".5) input-row weight tails + skip-dominated residual "
                     f"writes (write_scale {write_scale}) "
                     "(tpuserve_torch/models/synthetic.py)",
        "write_scale": write_scale,
        "difficulty_anchor": "write_scale is the JAX script's per-size anchor, set "
                             "there so that RTN int4-g128 lands at published RTN "
                             "damage (0.05-0.09 nat); this generator's draws differ",
        "samples": samples,
        "kl_int8_g128": round(kl_int8, 6),
        "kl_int4_rtn": round(kl_rtn, 6),
        "kl_int4_clip_search": round(kl_clip, 6),
        "kl_int4_gptq": round(kl_gptq, 6),
        "kl_int4_gptq_lorc32": round(kl_lorc, 6),
        "gptq_vs_rtn_ratio": round(kl_gptq / kl_rtn if kl_rtn > 0 else 1.0, 4),
        "gate": "gptq int4-g128 KL <= 0.02 nat AND rtn int4 KL > 0.02 "
                "(separation required; lorc row reported)",
        "gate_pass": bool(min(kl_gptq, kl_lorc) <= gate and kl_rtn > gate),
        "device": _device_name(dev),
    }


def evaluate_kv_long(size: str, ctx: int, samples: int, seed: int, device="cuda") -> dict:
    """Long-context KV drift: prefill `ctx` tokens, then 16 decode steps
    reading the whole quantized cache (int8 and packed int4), teacher-forced
    on the f32 cache's greedy path so that every step compares next-token
    distributions under the same context."""
    dev = resolve_device(device)
    p = {"llama_200m": _LLAMA_200M, "tiny": LlamaParams.tiny()}[size]
    params = llama.init_params(p, dtype=torch.float32, device=dev, seed=seed)
    rng = np.random.default_rng(seed)
    n_seq, dec = max(1, samples // 32), 16
    prompts = rng.integers(0, p.vocab_size, (n_seq, ctx)).astype(np.int32)

    lp_fp, fp_path = _decode_logprobs(params, p, prompts, dec, dev, False)
    lp_q, _ = _decode_logprobs(params, p, prompts, dec, dev, True, teacher=fp_path)
    lp_i4, _ = _decode_logprobs(params, p, prompts, dec, dev, True, kv_bits=4,
                                teacher=fp_path)
    kl_steps = (np.exp(lp_fp) * (lp_fp - lp_q)).sum(-1)  # [n_seq, dec]
    kl4_steps = (np.exp(lp_fp) * (lp_fp - lp_i4)).sum(-1)
    kl, kl4 = float(kl_steps.mean()), float(kl4_steps.mean())
    return {
        "mode": "synthetic_random_init_kv_long_context",
        "size": size,
        "context_len": ctx,
        "decode_steps": dec,
        "samples": n_seq * dec,
        "platform": _platform(dev),
        "kl_fp_cache_to_int8_nats": round(kl, 8),
        "kl_worst_step": round(float(kl_steps.max()), 8),
        "kl_fp_cache_to_int4_nats": round(kl4, 8),
        "kl_int4_worst_step": round(float(kl4_steps.max()), 8),
        "greedy_top1_agreement": round(float((lp_fp.argmax(-1) == lp_q.argmax(-1)).mean()), 4),
        "gate": "mean KL <= 0.02 nat at L~2048 (int8 AND int4); worst step <= 0.05",
        "gate_pass": bool(kl <= 0.02 and float(kl_steps.max()) <= 0.05
                          and kl4 <= 0.02 and float(kl4_steps.max()) <= 0.05),
        "device": _device_name(dev),
    }


def evaluate(repository: str, model: str, version: str, samples: int, seed: int,
             device="cuda") -> dict:
    """A repository model, f32 against its config's weight quantization
    (RTN, as the JAX script quantizes it): a Llama's perplexity, else the
    classifier branch (`evaluate_classifier`)."""
    from tpuserve_torch.repository import ModelRepository
    from tpuserve_torch.serving.engine import GenerationEngine

    dev = resolve_device(device)
    repo = ModelRepository(repository)
    cfg = repo.get_config(model, version or None)
    qcfg = cfg.quantization
    bits = {"int8": 8, "int4": 4}.get(qcfg.weights)
    if bits is None:
        raise SystemExit(f"model '{model}' has no weight quantization configured")
    model_dir = repo.get_model_path(model, version or None)
    if not (cfg.architecture or "").startswith("llama"):
        return evaluate_classifier(cfg, model_dir, bits, samples, seed, dev)
    engine = GenerationEngine(model_dir, cfg, device=dev)
    params_fp = engine.load_params(torch.float32)
    arch = Llama(cfg.model_params, device=dev)
    params_q = quantize_param_tree(params_fp, bits=bits, group_size=qcfg.group_size,
                                   predicate=arch.quant_predicate,
                                   act_bits=8 if qcfg.activations == "int8" else 0)

    rng = np.random.default_rng(seed)
    p = LlamaParams.from_dict(cfg.model_params)
    tokens = rng.integers(0, p.vocab_size, (max(1, samples // 16), 64)).astype(np.int32)
    targets = tokens[:, 1:]

    def ppl(params):
        lp = _logprobs(arch, params, tokens)
        return float(np.exp(-np.take_along_axis(lp, targets[..., None], axis=-1).mean()))

    base, quant = ppl(params_fp), ppl(params_q)
    return {"model": model, "quantization": qcfg.to_dict(), "samples": samples,
            "metric": "perplexity", "fp32": round(base, 4), "quantized": round(quant, 4),
            "delta": round(quant - base, 4), "gate": "<=0.1 ppl (BASELINE.md LLM gate)",
            "gate_pass": bool(abs(quant - base) <= 0.1), "device": _device_name(dev)}


def evaluate_classifier(cfg, model_dir: str, bits: int, samples: int, seed: int,
                        dev: torch.device) -> dict:
    """The classifier branch: the checkpoint in f32 and quantized per the
    config (the architecture's quant_predicate), both run on synthetic
    inputs of the declared shape (token ids below model_params.vocab_size
    for an integer input, N(0, 1) otherwise; a batch dim of -1 or 1 becomes
    `samples`): top-1 agreement and the logits' correlation."""
    from tpuserve_torch.engine.jax_backend import load_checkpoint
    from tpuserve_torch.models.registry import get_architecture

    arch = get_architecture(cfg, dev)
    params_fp = {k: v.to(device=dev, dtype=torch.float32)
                 for k, v in load_checkpoint(model_dir).items()}
    qcfg = cfg.quantization
    params_q = quantize_param_tree(params_fp, bits=bits, group_size=qcfg.group_size,
                                   predicate=arch.quant_predicate,
                                   act_bits=8 if qcfg.activations == "int8" else 0)

    rng = np.random.default_rng(seed)
    inp = cfg.inputs[0]
    shape = [samples if d == -1 else int(d) for d in inp.shape]
    if shape[0] == 1:
        shape[0] = samples
    np_dt = inp.data_type.np_dtype or np.float32
    if np.issubdtype(np_dt, np.integer):
        x = rng.integers(0, int(cfg.model_params.get("vocab_size", 100)), shape).astype(np_dt)
    else:
        x = rng.normal(size=shape).astype(np_dt)

    out_name = cfg.outputs[0].name if cfg.outputs else "logits"
    xt = torch.from_numpy(x).to(dev)
    with torch.inference_mode():
        ref = arch.apply(params_fp, {inp.name: xt})[out_name].float().cpu().numpy()
        got = arch.apply(params_q, {inp.name: xt})[out_name].float().cpu().numpy()
    ref2, got2 = ref.reshape(samples, -1), got.reshape(samples, -1)
    agree = float(np.mean(np.argmax(ref2, -1) == np.argmax(got2, -1)))
    corr = float(np.corrcoef(ref2.reshape(-1), got2.reshape(-1))[0, 1])
    return {"model": cfg.name, "quantization": qcfg.to_dict(), "samples": samples,
            "metric": "top1_agreement", "top1_agreement": round(agree, 4),
            "logit_correlation": round(corr, 6),
            "gate": ">=0.995 top-1 agreement (BASELINE.md <=0.5% CNN gate)",
            "gate_pass": bool(agree >= 0.995), "device": _device_name(dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repository", default="models")
    ap.add_argument("--model", default="")
    ap.add_argument("--version", default="")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="print one JSON line only")
    ap.add_argument("--kv-cache-eval", default="",
                    help="KV-cache-path fidelity: size name (llama_200m|tiny)")
    ap.add_argument("--synthetic", default="",
                    help="random-init llama size (llama_1b|tiny) instead of a "
                         "repository checkpoint")
    ap.add_argument("--outlier-eval", default="",
                    help="int4 clip-search stress on outlier-injected weights: "
                         "size name (llama_1b|tiny)")
    ap.add_argument("--anisotropic-eval", default="",
                    help="int4 headline gate on the anisotropic synthetic: size name "
                         "(llama_1b|llama_400m|tiny)")
    ap.add_argument("--kv-long-eval", default="",
                    help="long-context KV drift: size name (llama_200m|tiny); see --ctx")
    ap.add_argument("--ctx", type=int, default=2032,
                    help="prefill length for --kv-long-eval")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--platform", default="",
                    help="the JAX script's platform flag: cpu or gpu, as --device")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--act-bits", type=int, default=0)
    ap.add_argument("--quantizer", default="rtn", choices=("rtn", "gptq"),
                    help="weight quantizer for --synthetic")
    args = ap.parse_args(argv)
    device = {"cpu": "cpu", "gpu": "cuda"}.get(args.platform, args.device)

    if args.anisotropic_eval:
        result = evaluate_anisotropic(args.anisotropic_eval, args.samples, args.seed, device)
    elif args.outlier_eval:
        result = evaluate_outliers(args.outlier_eval, args.samples, args.seed, device)
    elif args.kv_long_eval:
        result = evaluate_kv_long(args.kv_long_eval, args.ctx, args.samples, args.seed, device)
    elif args.kv_cache_eval:
        result = evaluate_kv_cache(args.kv_cache_eval, "both", args.samples, args.seed, device)
    elif args.synthetic:
        result = evaluate_synthetic(args.synthetic, args.bits, args.group_size, args.act_bits,
                                    args.samples, args.seed, quantizer=args.quantizer,
                                    device=device)
    elif not args.model:
        ap.error("--model or --synthetic required")
    else:
        result = evaluate(args.repository, args.model, args.version, args.samples, args.seed,
                          device)
    if args.json:
        print(json.dumps(result), flush=True)
    else:
        for k, v in result.items():
            print(f"{k}: {v}", flush=True)
    return 0 if result.get("gate_pass") else 1


if __name__ == "__main__":
    sys.exit(main())
