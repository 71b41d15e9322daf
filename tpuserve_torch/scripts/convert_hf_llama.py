#!/usr/bin/env python3
"""Convert a HuggingFace Llama checkpoint to a tpuserve repository entry
(the port of scripts/convert_hf_llama.py).

Maps HF parameter names to the flat tpuserve_torch/models/llama.py naming
and writes `<repo>/<name>/<version>/{model.safetensors, config.json}` ready
for `POST /models/<name>/load` (quantization applied at load per the
generated config's `quantization` block). Mixtral's block-sparse MoE is
stacked as the JAX script stacks it (w1|w3 -> fused moe_gateup [E, D, 2F],
w2 -> moe_down [E, F, D], gate -> router [D, E]); a tied checkpoint gets
lm_head from the embedding; a list of eos ids keeps its first.

Usage:
  python -m tpuserve_torch.scripts.convert_hf_llama --hf-dir /path/to/Llama-2-7b-hf \\
      --output-dir models --name llama2_7b --quant int4 --kv-cache int8

Works from either a single model.safetensors or sharded
model-0000x-of-0000y.safetensors files; reads HF config.json for shapes.
Reads and writes with the port's own safetensors reader and writer
(tpuserve_torch/utils/checkpoint.py), so no `safetensors` package is
needed; tensors keep their dtype (f64 becomes f32). `--device` is where
the tensors are transposed and stacked (default cuda; cpu without a card).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil

import torch

from tpuserve_torch.utils.checkpoint import read_safetensors, write_safetensors


def _scalar_eos(eos) -> int:
    """Llama-3-family configs store eos_token_id as a list; the engine
    tracks a single id — take the first."""
    if isinstance(eos, (list, tuple)):
        eos = eos[0]
    return int(eos)


def hf_key_map(n_layers: int):
    m = {
        "model.embed_tokens.weight": "embed/weight",
        "model.norm.weight": "final_norm/scale",
        "lm_head.weight": "lm_head/kernel.T",  # HF stores [V, D]; ours is [D, V]
    }
    for i in range(n_layers):
        hf = f"model.layers.{i}"
        ours = f"layers.{i}"
        m[f"{hf}.input_layernorm.weight"] = f"{ours}/attn_norm/scale"
        m[f"{hf}.post_attention_layernorm.weight"] = f"{ours}/mlp_norm/scale"
        m[f"{hf}.self_attn.q_proj.weight"] = f"{ours}/wq/kernel.T"
        m[f"{hf}.self_attn.k_proj.weight"] = f"{ours}/wk/kernel.T"
        m[f"{hf}.self_attn.v_proj.weight"] = f"{ours}/wv/kernel.T"
        m[f"{hf}.self_attn.o_proj.weight"] = f"{ours}/wo/kernel.T"
        m[f"{hf}.mlp.gate_proj.weight"] = f"{ours}/w_gate/kernel.T"
        m[f"{hf}.mlp.up_proj.weight"] = f"{ours}/w_up/kernel.T"
        m[f"{hf}.mlp.down_proj.weight"] = f"{ours}/w_down/kernel.T"
    return m


def _moe_key(hf_name: str):
    """Parse Mixtral block-sparse-MoE names:
    model.layers.{l}.block_sparse_moe.gate.weight -> ("router", l)
    ...experts.{e}.w1|w2|w3.weight -> ("expert", l, e, "w1"|"w2"|"w3")."""
    parts = hf_name.split(".")
    if "block_sparse_moe" not in parts:
        return None
    layer = int(parts[2])
    if parts[4] == "gate":
        return ("router", layer)
    if parts[4] == "experts":
        return ("expert", layer, int(parts[5]), parts[6])
    return None


def convert(hf_dir: str, output_dir: str, name: str, version: str,
            quant: str, kv_cache: str, max_slots: int, max_seq_len: int,
            device: str = "cuda") -> str:
    with open(os.path.join(hf_dir, "config.json")) as f:
        hf_cfg = json.load(f)

    n_layers = int(hf_cfg["num_hidden_layers"])
    n_heads = int(hf_cfg["num_attention_heads"])
    n_kv_heads = int(hf_cfg.get("num_key_value_heads", n_heads))
    dim = int(hf_cfg["hidden_size"])
    head_dim = int(hf_cfg.get("head_dim", dim // n_heads))
    n_experts = int(hf_cfg.get("num_local_experts", 0))  # Mixtral-style MoE
    key_map = hf_key_map(n_layers)

    shards = sorted(glob.glob(os.path.join(hf_dir, "model*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards in {hf_dir}")

    dev = torch.device(device)
    out = {}
    moe_raw = {}
    tied = bool(hf_cfg.get("tie_word_embeddings", False))
    for shard in shards:
        weights = read_safetensors(shard)
        for hf_name, arr in weights.items():
            mk = _moe_key(hf_name) if n_experts else None
            if mk is not None:
                moe_raw[mk] = arr
                continue
            target = key_map.get(hf_name)
            if target is None:
                if "rotary_emb" in hf_name:
                    continue  # rotary tables are recomputed
                print(f"  skipping unmapped param {hf_name}")
                continue
            if target.endswith(".T"):
                target = target[:-2]
                arr = arr.to(dev).T.contiguous().cpu()
            out[target] = arr.to(torch.float32) if arr.dtype == torch.float64 else arr
        del weights

    if n_experts:
        # assemble stacked expert weights: w1 = gate [F, D], w3 = up [F, D],
        # w2 = down [D, F] (HF stores out-dim first) -> fused
        # moe_gateup [E, D, 2F] and moe_down [E, F, D]
        for layer in range(n_layers):
            out[f"layers.{layer}/router/kernel"] = \
                moe_raw[("router", layer)].to(dev).T.contiguous().cpu()  # [D, E]
            gus, dns = [], []
            for e in range(n_experts):
                w1 = moe_raw[("expert", layer, e, "w1")].to(dev).T  # [D, F] gate
                w3 = moe_raw[("expert", layer, e, "w3")].to(dev).T  # [D, F] up
                w2 = moe_raw[("expert", layer, e, "w2")].to(dev).T  # [F, D] down
                gus.append(torch.cat([w1, w3], dim=1))
                dns.append(w2)
            out[f"layers.{layer}/moe_gateup/kernel"] = torch.stack(gus).contiguous().cpu()
            out[f"layers.{layer}/moe_down/kernel"] = torch.stack(dns).contiguous().cpu()
        moe_raw.clear()

    if tied and "lm_head/kernel" not in out:
        out["lm_head/kernel"] = out["embed/weight"].to(dev).T.contiguous().cpu()

    vdir = os.path.join(output_dir, name, version)
    os.makedirs(vdir, exist_ok=True)
    write_safetensors(os.path.join(vdir, "model.safetensors"), out)

    tok_src = os.path.join(hf_dir, "tokenizer.json")
    if os.path.exists(tok_src):  # enables text-in/text-out on /generate
        shutil.copy(tok_src, os.path.join(vdir, "tokenizer.json"))

    cfg = {
        "name": name,
        "version": version,
        "platform": "llm",
        "architecture": "mixtral" if n_experts else "llama",
        "inputs": [{"name": "input_ids", "shape": [1, -1], "data_type": "INT32"}],
        "outputs": [{"name": "output_ids", "shape": [1, -1], "data_type": "INT32"}],
        "model_params": {
            "vocab_size": int(hf_cfg["vocab_size"]),
            "dim": dim,
            "n_layers": n_layers,
            "n_heads": n_heads,
            "n_kv_heads": n_kv_heads,
            "head_dim": head_dim,
            "ffn_dim": int(hf_cfg["intermediate_size"]),
            "rope_theta": float(hf_cfg.get("rope_theta", 10000.0)),
            "rms_eps": float(hf_cfg.get("rms_norm_eps", 1e-5)),
            **({"n_experts": n_experts,
                "n_experts_per_tok": int(hf_cfg.get("num_experts_per_tok", 2))}
               if n_experts else {}),
        },
        "generation": {
            "max_seq_len": max_seq_len,
            "max_slots": max_slots,
            "eos_token_id": _scalar_eos(hf_cfg.get("eos_token_id", 2)),
        },
        "quantization": {
            "weights": quant,
            "group_size": 128,
            "kv_cache": kv_cache,
        },
    }
    with open(os.path.join(vdir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    print(f"converted {len(out)} params -> {vdir}")
    return vdir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hf-dir", required=True)
    p.add_argument("--output-dir", default="models")
    p.add_argument("--name", default="llama")
    p.add_argument("--version", default="1")
    p.add_argument("--quant", default="int4", choices=["none", "int8", "int4"])
    p.add_argument("--kv-cache", default="int8", choices=["none", "int8"])
    p.add_argument("--max-slots", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    convert(a.hf_dir, a.output_dir, a.name, a.version, a.quant, a.kv_cache,
            a.max_slots, a.max_seq_len, device=a.device)


if __name__ == "__main__":
    main()
