#!/usr/bin/env python3
"""Decompose the 7B multi-candidate verify step's cost on the card (the
port of scripts/verify_profile.py).

The verify step (C = 9 candidates a slot) costs several decode steps while
the multi-candidate attention kernel alone is flat across C. So the cost
hides in what every variant keeps: the quantized matmul stack at B = S*C,
or the [S, C, H, hd] elementwise ops (RoPE, KV quantization). This harness
warms each dispatch once, then interleaves them (same weather):

  dec     decode_step S=8                      (baseline)
  blk8    matmul stack only, B=8  (identity attn, all layers + lm_head)
  blk72   matmul stack only, B=72
  ver     full verify_step S=8 C=9
  ver_nr  verify with llama.apply_rope patched to identity
  ver_nq  verify with llama._quantize_kv_cache patched to a cheap cast
  ver_nrq both patches

A patch is in place only while its variant runs (PyTorch runs eagerly, so
the JAX script's patch-while-tracing becomes patch-while-calling) and both
originals come back in a `finally`. Each dispatch is timed on the device's
clock by CUDA events around it (on the CPU by the host clock), ending in
the host copy of its first output as the JAX script's does.

Usage: python -m tpuserve_torch.scripts.verify_profile [--device cpu]

Env: TPUSERVE_VP_{SLOTS,C,SEQ,ROUNDS} (defaults 8, 9, 512, 6);
TPUSERVE_VP_MODEL=small for a 2-layer model of Llama-2-7B's heads.
"""

import argparse
import contextlib
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from tpuserve_torch.models import llama
from tpuserve_torch.models.llama import KVCache, LlamaParams
from tpuserve_torch.models.llama_bench import init_quantized_params
from tpuserve_torch.utils.device import resolve_device

S = int(os.environ.get("TPUSERVE_VP_SLOTS", "8"))
C = int(os.environ.get("TPUSERVE_VP_C", "9"))
L = int(os.environ.get("TPUSERVE_VP_SEQ", "512"))
ROUNDS = int(os.environ.get("TPUSERVE_VP_ROUNDS", "6"))


def _params() -> LlamaParams:
    p = LlamaParams.llama2_7b()
    if os.environ.get("TPUSERVE_VP_MODEL") == "small":
        p = LlamaParams(**dict(p.__dict__, vocab_size=512, dim=256, n_layers=2, n_heads=2,
                               n_kv_heads=2, ffn_dim=512))
    return p


def _id_rope(x, cos, sin):
    return x


def _cheap_q(cache, x):
    codes = torch.clamp(x.to(torch.float32), -127, 127).to(torch.int8)
    return codes, torch.ones(x.shape[:-1], dtype=torch.float32, device=x.device)


@contextlib.contextmanager
def patched(rope: bool, quant: bool):
    """llama.apply_rope and llama._quantize_kv_cache replaced while the
    block runs; both originals restored in a finally."""
    orig_rope, orig_q = llama.apply_rope, llama._quantize_kv_cache
    llama.apply_rope = _id_rope if rope else orig_rope
    llama._quantize_kv_cache = _cheap_q if quant else orig_q
    try:
        yield
    finally:
        llama.apply_rope = orig_rope
        llama._quantize_kv_cache = orig_q


def run(device: str = "cuda", rounds: Optional[int] = None) -> dict:
    """Every dispatch warmed, then `rounds` (TPUSERVE_VP_ROUNDS) interleaved
    rounds; returns each one's best ms."""
    rounds = ROUNDS if rounds is None else rounds
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    p = _params()
    params = init_quantized_params(p, bits=4, group_size=128, device=dev, seed=0)
    print("# weights up", file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    pos0 = torch.from_numpy(rng.integers(64, L - C - 2, S).astype(np.int32)).to(dev)
    lengths = torch.full((S,), C, dtype=torch.int32, device=dev)
    states = {}

    def timed(fn, args):
        """fn(*args) on the device's clock, ending in a host copy."""
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            out = fn(*args)
            out[0].cpu()
            t1.record()
            t1.synchronize()
            return out, t0.elapsed_time(t1) / 1e3
        t0 = time.perf_counter()
        out = fn(*args)
        out[0].cpu()
        return out, time.perf_counter() - t0

    def add(name, fn, *args):
        t0 = time.time()
        with torch.no_grad():
            timed(fn, args)
        print(f"# {name}: warm in {time.time()-t0:.0f}s", file=sys.stderr, flush=True)
        states[name] = [fn, list(args), []]

    # --- decode baseline
    cache_d = KVCache.create(p, S, L, quantized=True, device=dev)

    def dec(params, tokens, cache, positions):
        logits, cache = llama.decode_step(params, p, tokens, cache, positions)
        return torch.argmax(logits, dim=-1), cache

    add("dec", dec, params, torch.zeros((S,), dtype=torch.long, device=dev), cache_d, pos0)

    # --- matmul stack only (identity attention), B = S and B = S*C
    def blocks_only(params, x):
        for layer in range(p.n_layers):
            x = llama._forward_block(params, f"layers.{layer}", x, p, lambda q, k, v: q)
        logits = llama._logits(params, x, p)
        return (x + 1e-6 * logits[:, :p.dim].to(x.dtype),)

    add("blk8", blocks_only, params, torch.ones((S, p.dim), dtype=torch.bfloat16, device=dev))
    add("blk72", blocks_only, params,
        torch.ones((S * C, p.dim), dtype=torch.bfloat16, device=dev))

    # --- verify variants (each patch in place while its variant runs)
    def make_ver(tag, patch_rope, patch_q):
        def ver(params, tokens, cache, positions):
            with patched(patch_rope, patch_q):
                logits, cache = llama.verify_step(params, p, tokens, cache, positions, lengths)
            nxt = torch.argmax(logits[:, 0, :], dim=-1)
            return nxt[:, None].expand(S, C).contiguous(), cache

        cache_v = KVCache.create(p, S, L, quantized=True, device=dev)
        add(tag, ver, params, torch.zeros((S, C), dtype=torch.long, device=dev), cache_v, pos0)

    make_ver("ver", False, False)
    make_ver("ver_nr", True, False)
    make_ver("ver_nq", False, True)
    make_ver("ver_nrq", True, True)

    with torch.no_grad():
        for r in range(rounds):
            line = [f"round {r}:"]
            for name, st in states.items():
                fn, args, times = st
                out, dt = timed(fn, args)
                times.append(dt)
                if name == "dec" or name.startswith("ver"):
                    args[1], args[2] = out
                line.append(f"{name} {dt*1e3:6.1f}")
            print(" ".join(line), flush=True)

    print("\n# best ms per dispatch", flush=True)
    best = {}
    for name, st in states.items():
        best[name] = min(st[2]) * 1e3
        print(f"{name:8s} {best[name]:7.1f}", flush=True)
    return {"best_ms": best, "rounds": rounds, "S": S, "C": C, "L": L,
            "clock": "CUDA events" if cuda else "host"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
