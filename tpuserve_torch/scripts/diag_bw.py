"""HBM bandwidth diagnostics for the decode-attention access pattern, on the
card (port of scripts/diag_bw.py).

Modes (pick with --mode, comma-separated):
  xsum     torch.sum over the int8 K/V widened to int32 (the library's
           streaming rate; the TPU script's XLA jnp.sum)
  pcopy    column sums of every byte in CONTIGUOUS [1, block_l*Hkv, hd]
           blocks (ops.attention_probes.diag_copy)
  pcopy4d  the same in 4-D strided blocks (1, block_l, g, hd): runs of g*hd
           bytes at a stride of Hkv*hd, like the attention kernel's
           per-head-group slices
  pdyn     pcopy, each slot's blocks past its live one unread (the TPU's
           scalar-prefetch clamped index map; every slot is at L-1 here)

Each prints us/iter, effective GB/s of K and V, the TPU's grid (--block-l
keeps the TPU's meaning, so at the defaults pcopy has 64 blocks) and the
card's, which cuts each TPU block into CTAs of consecutive rows
(ops.attention_probes.diag_copy_plan: 1024 CTAs for the H100's 132 SMs
at the defaults). On the card a mode's
time is the best of 3 runs of ITERS calls in a row between CUDA events (the
TPU script: a scan of ITERS calls, best of 3). On the CPU the plain versions
run on the host clock: a check, not a device time. A mode that raises
prints FAILED and the script exits 1.

    python -m tpuserve_torch.scripts.diag_bw                    # the card
    python -m tpuserve_torch.scripts.diag_bw --mode pcopy4d --block-l 64
    python -m tpuserve_torch.scripts.diag_bw --device cpu --s 2 --l 32 --n-kv 4 --g 2 --block-l 16
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List

import torch

from tpuserve_torch.ops import attention_probes as probes
from tpuserve_torch.scripts.sweep_attention import time_per_call

MODES = ("xsum",) + probes.COPY_MODES


def setup(d: Dict[str, int], device, seed: int = 0):
    """k, v int8 [S, L, Hkv, hd] in [-127, 126] (the TPU script's range) and
    positions L-1, made on the device from a seed."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    shape = (d["S"], d["L"], d["N_KV"], d["HD"])
    k, v = (torch.randint(-127, 127, shape, generator=g, device=device, dtype=torch.int8)
            for _ in range(2))
    positions = torch.full((d["S"],), d["L"] - 1, dtype=torch.int32, device=device)
    return k, v, positions


def _call(mode: str, d, k, v, positions):
    if mode == "xsum":
        return lambda: k.sum(dtype=torch.int32) + v.sum(dtype=torch.int32)
    if mode in probes.COPY_MODES:
        return lambda: probes.diag_copy(k, v, mode, d["BLOCK_L"], d["G"],
                                        positions if mode == "pdyn" else None)
    raise ValueError(f"unknown diag_bw mode {mode!r}; known: {', '.join(MODES)}")


def run(modes: List[str], d: Dict[str, int], device) -> List[Dict]:
    """Run the modes in order, printing one line each; returns their
    records. A mode that raises prints FAILED and is recorded as such."""
    k, v, positions = setup(d, device)
    nbytes = k.numel() + v.numel()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    clock = "CUDA events" if device.type == "cuda" else "host clock, plain versions"
    print(f"# arrays 2x{k.numel() / 1e6:.0f} MB; S={d['S']} L={d['L']} Hkv={d['N_KV']} "
          f"hd={d['HD']} g={d['G']} block_l={d['BLOCK_L']}; device {name} ({clock})",
          flush=True)
    sms = 132 if device.type != "cuda" else torch.cuda.get_device_properties(
        device).multi_processor_count   # the plan's SMs (the H100's for the plain versions)
    records = []
    for mode in modes:
        try:
            fn = _call(mode, d, k, v, positions)
            t0 = time.perf_counter()
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            first_s = time.perf_counter() - t0
            per = time_per_call(fn, d["ITERS"], device)
        except Exception as e:  # reported and recorded; the caller decides
            print(f"{mode:10s} FAILED: {type(e).__name__}: {e}", flush=True)
            records.append(dict(mode=mode, failed=f"{type(e).__name__}: {e}"))
            continue
        grid = tpu_grid = None
        if mode in probes.COPY_MODES:
            tpu_grid = probes.diag_copy_tpu_grid(k.shape, mode, d["BLOCK_L"], d["G"])
            grid = probes.diag_copy_grid(k.shape, mode, d["BLOCK_L"], d["G"], sms)
        where = "" if grid is None else (
            f"  grid {tpu_grid[0]}x{tpu_grid[1]}x{tpu_grid[2]} = {math.prod(tpu_grid)} blocks, "
            f"on the card {grid[0]}x{grid[1]}x{grid[2]} = {math.prod(grid)} CTAs")
        print(f"{mode:10s} {per * 1e6:9.1f} us/iter  {nbytes / per / 1e9:7.1f} GB/s  "
              f"(compile {first_s:.1f}s){where}", flush=True)
        records.append(dict(mode=mode, block_l=d["BLOCK_L"], g=d["G"], us=per * 1e6,
                            gb_s=nbytes / per / 1e9, bytes=nbytes, grid=grid,
                            tpu_grid=tpu_grid))
    return records


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="xsum,pcopy,pcopy4d,pdyn")
    ap.add_argument("--s", type=int, default=64)
    ap.add_argument("--l", type=int, default=256)
    ap.add_argument("--n-kv", type=int, default=32)
    ap.add_argument("--hd", type=int, default=128)
    ap.add_argument("--g", type=int, default=16)
    ap.add_argument("--block-l", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu for the plain versions")
    d = dict(S=args.s, L=args.l, N_KV=args.n_kv, HD=args.hd, G=args.g, BLOCK_L=args.block_l,
             ITERS=args.iters)
    records = run([m for m in args.mode.split(",") if m], d, device)
    if any("failed" in r for r in records):
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
