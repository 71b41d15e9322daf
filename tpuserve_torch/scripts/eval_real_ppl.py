#!/usr/bin/env python3
"""Turnkey real-checkpoint perplexity gate (the port of
scripts/eval_real_ppl.py).

ONE command from (any local Llama checkpoint) + (any text file) to the
"<= 0.1 perplexity delta at INT4" gate row, with the JAX script's flags,
result keys and printed lines:

  # from a HuggingFace Llama dir (config.json + *.safetensors [+ tokenizer]):
  python -m tpuserve_torch.scripts.eval_real_ppl --hf-dir /ckpt/Llama-2-7b-hf \\
      --text /data/wikitext_val.txt --bits 4 --quantizer gptq --json

  # from an existing tpuserve repository entry:
  python -m tpuserve_torch.scripts.eval_real_ppl --repository models --model llama2_7b \\
      --text /data/wikitext_val.txt --json

  # tokenizer-less path: pre-tokenized ids, JSON or .npy
  python -m tpuserve_torch.scripts.eval_real_ppl --repository models --model aniso \\
      --token-ids ids.json --json --device cpu

Method: teacher-forced next-token NLL over non-overlapping --ctx windows,
in two passes on --device (default cuda): the fp leg with bf16 weights,
which are freed before the quantized leg's f32 weights are loaded and
quantized on the same device (RTN, or GPTQ through the port's
collect_and_quantize_llama) and freed in turn. GPTQ calibrates on the
FIRST --calib-windows windows of the same text, which are held out of the
eval unless --eval-all is set. `--platform cpu` (the JAX script's flag)
means `--device cpu`.

Tokenization: --text needs a tokenizer, taken from --hf-dir (transformers,
local files only) or --tokenizer-json (transformers' fast tokenizer), both
imported only then: without the transformers package the script exits and
names --token-ids, which skips tokenization.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _load_tokens(args) -> np.ndarray:
    if args.token_ids:
        if args.token_ids.endswith(".npy"):
            ids = np.load(args.token_ids)
        else:
            with open(args.token_ids) as f:
                ids = np.asarray(json.load(f))
        return ids.astype(np.int32).reshape(-1)
    if not args.text:
        raise SystemExit("provide --text (with a tokenizer) or --token-ids")
    if not (args.tokenizer_json or args.hf_dir):
        raise SystemExit("--text needs --tokenizer-json or --hf-dir")
    try:
        import transformers
    except ImportError:
        raise SystemExit("--text needs the transformers package for its tokenizer, which is "
                         "not installed: pass pre-tokenized ids with --token-ids") from None
    with open(args.text) as f:
        text = f.read()
    if args.tokenizer_json:
        tok = transformers.PreTrainedTokenizerFast(tokenizer_file=args.tokenizer_json)
    else:
        tok = transformers.AutoTokenizer.from_pretrained(args.hf_dir, local_files_only=True)
    return np.asarray(tok(text)["input_ids"], np.int32).reshape(-1)


def _model_entry(args, device):
    """Resolve (model_dir, ModelConfig): convert --hf-dir if given."""
    from tpuserve_torch.repository.config import ModelConfig

    if args.hf_dir:
        from tpuserve_torch.scripts.convert_hf_llama import convert

        name = args.model or "real_ppl_eval"
        convert(args.hf_dir, args.repository, name, "1",
                quant=f"int{args.bits}", kv_cache="int8",
                max_slots=4, max_seq_len=max(args.ctx, 2048), device=str(device))
        model_dir = os.path.join(args.repository, name, "1")
    else:
        if not args.model:
            raise SystemExit("provide --hf-dir or --repository/--model")
        from tpuserve_torch.repository import ModelRepository

        repo = ModelRepository(args.repository)
        model_dir = repo.get_model_path(args.model, args.version or None)
    cfg = ModelConfig.from_file(os.path.join(model_dir, "config.json"))
    return model_dir, cfg


def _nll(logits: np.ndarray, targets: np.ndarray) -> np.ndarray:
    lg = logits.astype(np.float64)
    m = lg.max(-1, keepdims=True)
    logp = lg - m - np.log(np.exp(lg - m).sum(-1, keepdims=True))
    return -np.take_along_axis(logp, targets[..., None], -1)[..., 0]


def _windows(ids: np.ndarray, ctx: int, max_windows: int, calib_windows: int,
             quantizer: str, eval_all: bool):
    """(all windows [n, ctx], calibration count, eval windows) as the JAX
    script cuts them."""
    n_win = min(max_windows, len(ids) // ctx)
    if n_win < 1:
        raise SystemExit(f"need >= {ctx} tokens, got {len(ids)}")
    windows = ids[: n_win * ctx].reshape(n_win, ctx)
    calib_n = min(calib_windows, n_win - 1) if quantizer == "gptq" else 0
    eval_lo = 0 if (eval_all or calib_n == 0) else calib_n
    return windows, calib_n, windows[eval_lo:]


def run(args) -> dict:
    """Both legs; returns the JAX script's result row."""
    from tpuserve_torch.engine.jax_backend import load_checkpoint
    from tpuserve_torch.models import llama
    from tpuserve_torch.models.llama import LlamaParams
    from tpuserve_torch.models.registry import get_architecture
    from tpuserve_torch.quant.core import quantize_param_tree
    from tpuserve_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.platform == "cpu" else args.device)
    model_dir, cfg = _model_entry(args, device)
    p = LlamaParams.from_dict(cfg.model_params)
    arch = get_architecture(cfg, device=device)
    ids = _load_tokens(args)

    ctx = min(args.ctx, int(cfg.generation.max_seq_len))
    windows, calib_n, eval_windows = _windows(ids, ctx, args.max_windows, args.calib_windows,
                                              args.quantizer, args.eval_all)
    raw = load_checkpoint(model_dir)

    def fused(dtype):
        return llama.fuse_params({k: v.to(device, dtype) if v.is_floating_point()
                                  else v.to(device) for k, v in raw.items()}, p)

    def run_ppl(params, tag):
        nll, cnt = 0.0, 0
        with torch.no_grad():
            for i, w in enumerate(eval_windows):
                lg = arch.apply(params, {"input_ids": torch.from_numpy(w[None, :])})["logits"]
                lg = lg[0].to("cpu", torch.float64).numpy()[:-1]
                nll += float(_nll(lg, w[1:]).sum())
                cnt += ctx - 1
                print(f"# {tag} window {i+1}/{len(eval_windows)} "
                      f"ppl-so-far {np.exp(nll/cnt):.4f}", file=sys.stderr, flush=True)
        return float(np.exp(nll / cnt))

    # pass 1: fp reference (bf16 weights)
    params_fp = fused(torch.bfloat16)
    ppl_fp = run_ppl(params_fp, "fp")
    del params_fp
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # pass 2: the f32 weights quantized, then only the quantized tree kept
    host_fp = fused(torch.float32)
    if args.quantizer == "gptq" and calib_n > 0:
        from tpuserve_torch.quant.gptq import collect_and_quantize_llama

        params_q = collect_and_quantize_llama(
            host_fp, p, torch.from_numpy(windows[:calib_n]),
            bits=args.bits, group_size=args.group_size)
    else:
        params_q = quantize_param_tree(host_fp, bits=args.bits, group_size=args.group_size,
                                       predicate=arch.quant_predicate)
    del host_fp
    ppl_q = run_ppl(params_q, f"int{args.bits}-{args.quantizer}")

    return {
        "metric": "real_ppl_delta",
        "model_dir": model_dir,
        "quantizer": args.quantizer,
        "bits": args.bits,
        "group_size": args.group_size,
        "ctx": ctx,
        "eval_windows": int(len(eval_windows)),
        "calib_windows": int(calib_n),
        "eval_tokens": int(len(eval_windows) * (ctx - 1)),
        "ppl_fp": round(ppl_fp, 4),
        "ppl_quant": round(ppl_q, 4),
        "delta": round(ppl_q - ppl_fp, 4),
        "gate": "<=0.1 ppl (BASELINE.md LLM gate)",
        "gate_pass": bool(ppl_q - ppl_fp <= 0.1),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hf-dir", default="")
    ap.add_argument("--repository", default="models")
    ap.add_argument("--model", default="")
    ap.add_argument("--version", default="")
    ap.add_argument("--text", default="")
    ap.add_argument("--tokenizer-json", default="")
    ap.add_argument("--token-ids", default="",
                    help="pre-tokenized ids (.json list or .npy) — skips "
                         "the tokenizer (smoke path)")
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--max-windows", type=int, default=16)
    ap.add_argument("--calib-windows", type=int, default=4,
                    help="leading windows used for GPTQ calibration")
    ap.add_argument("--eval-all", action="store_true",
                    help="also evaluate on the calibration windows")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--quantizer", default="gptq", choices=("rtn", "gptq"))
    ap.add_argument("--platform", default="",
                    help="the JAX script's platform flag: cpu means --device cpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    result = run(args)
    print(json.dumps(result), flush=True)
    if not args.json:
        print(f"ppl fp {result['ppl_fp']:.4f} -> int{args.bits} {result['ppl_quant']:.4f} "
              f"(delta {result['delta']:+.4f}) "
              f"{'PASS' if result['gate_pass'] else 'FAIL'}",
              file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
