"""The fused dequant+matmul's delivered rate the way decode runs it, on the
card (port of scripts/qmatmul_sweep.py): a CHAIN of matmuls feeding each
other (DEPTH iterations of x = qmm(x, W) on [B, 4096] x [4096, 4096], each
output normalised by its RMS so that bf16 does not overflow), like a layer
stack, so per-call overheads pipeline as in the decode step.

Modes: the kernel (ops.quant_matmul) on int4 and int8 g128 weights at the
wrapper's own split ("auto") and at block_k 256/512/1024 (the K range one
block walks), and "int4/xla": dequantize to bf16 then torch.matmul, inside
the chain as the TPU script's XLA control does.

On the card the chain is one CUDA graph (the TPU script's jitted scan),
replayed ROUNDS times between CUDA events, chained across replays; the
best replay over DEPTH gives a matmul's time. The weight is 8.4 MB (int4)
or 16.8 MB (int8), so it stays in the H100's 50 MB L2 across the chain:
these are L2-warm rates, not HBM ones (chip_smoke.py's per-step numbers
rotate copies past the L2). On the CPU the plain versions run eagerly on
the host clock: a check, not a device time. A mode that raises prints FAIL
and the script exits 1.

    python -m tpuserve_torch.scripts.qmatmul_sweep                  # the card
    TPUSERVE_QMM_B=72 python -m tpuserve_torch.scripts.qmatmul_sweep
    python -m tpuserve_torch.scripts.qmatmul_sweep --device cpu

Env: TPUSERVE_QMM_B (64), TPUSERVE_QMM_ROUNDS (5), TPUSERVE_QMM_DEPTH (32).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import torch

from tpuserve_torch.ops.quant_matmul import quant_matmul
from tpuserve_torch.quant.core import dequantize, quantize

GS = 128
K = N = 4096
L2_BYTES = 50 * 1024 * 1024   # the H100's L2


def dims() -> Dict[str, int]:
    return dict(K=K, N=N)


def _normalise(y: torch.Tensor) -> torch.Tensor:
    yf = y.float()
    return (yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-6)).to(torch.bfloat16)


def modes(qt4, qt8) -> Dict[str, tuple]:
    """name -> (one chain step x -> x, packed weight bytes)."""
    def kernel(qt, bk):
        return lambda x: _normalise(quant_matmul(x, qt, block_k=bk, out_dtype=torch.bfloat16))

    def xla(x):
        w = dequantize(qt4, torch.bfloat16)
        return _normalise(torch.matmul(x, w))

    b4, b8 = qt4.q.numel(), qt8.q.numel()
    return {
        "int4/auto": (kernel(qt4, None), b4),
        "int4/bk256": (kernel(qt4, 256), b4),
        "int4/bk512": (kernel(qt4, 512), b4),
        "int4/bk1024": (kernel(qt4, 1024), b4),
        "int8/auto": (kernel(qt8, None), b8),
        "int8/bk512": (kernel(qt8, 512), b8),
        "int4/xla": (xla, b4),
    }


def _chain(step, depth: int):
    def run(x):
        for _ in range(depth):
            x = step(x)
        return x
    return run


def run(device, b: int, rounds: int, depth: int) -> List[Dict]:
    """Every mode, one line each; returns their records (failed ones with
    a `failed` entry)."""
    d = dims()
    g = torch.Generator().manual_seed(0)
    w = torch.randn((d["K"], d["N"]), generator=g) * 0.02
    qt4 = quantize(w, bits=4, group_size=GS).to(device)
    qt8 = quantize(w, bits=8, group_size=GS).to(device)
    x0 = (torch.randn((b, d["K"]), generator=g) * 0.1).to(device, torch.bfloat16)
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    clock = "CUDA events over a CUDA graph of the chain" if cuda else \
        "host clock, plain versions"
    by4, by8 = qt4.q.numel(), qt8.q.numel()
    print(f"# b={b} {d['K']}x{d['N']} gs={GS} depth={depth}: int4 {by4 / 1e6:.1f} MB, "
          f"int8 {by8 / 1e6:.1f} MB per matmul; device {name} ({clock})", flush=True)
    if cuda:
        fits = [m for m, by in (("int4", by4), ("int8", by8)) if by < L2_BYTES]
        print(f"# {', '.join(fits) or 'neither'} weight(s) fit the 50 MB L2: "
              f"L2-warm rates, not HBM", flush=True)
    records = []
    states = {}
    for mname, (step, wb) in modes(qt4, qt8).items():
        try:
            chain = _chain(step, depth)
            t0 = time.perf_counter()
            y = chain(x0)               # warm-up (and the kernels' build)
            if cuda:
                torch.cuda.synchronize(device)
                graph = torch.cuda.CUDAGraph()
                xin = y.clone()
                with torch.cuda.graph(graph):
                    yout = chain(xin)
                graph.replay()
                torch.cuda.synchronize(device)
                fn = (graph, xin, yout)
            else:
                fn = chain
            print(f"# compiled {mname} in {time.perf_counter() - t0:.0f}s", flush=True)
        except Exception as e:  # reported and recorded; the caller decides
            print(f"{mname:14s} FAIL {type(e).__name__}: {str(e).splitlines()[0][:100]}",
                  flush=True)
            records.append(dict(mode=mname, failed=f"{type(e).__name__}: {e}"))
            continue
        states[mname] = [fn, wb, y, []]
    for _ in range(rounds):
        for mname, st in states.items():
            fn, wb, y, times = st
            if cuda:
                graph, xin, yout = fn
                xin.copy_(y)            # chain across replays too
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize(device)
                times.append(start.elapsed_time(end) / 1e3 / depth)
                st[2] = yout.clone()
            else:
                t0 = time.perf_counter()
                st[2] = fn(y)
                times.append((time.perf_counter() - t0) / depth)
    print(f"\n# per-matmul best of {rounds} (packed-W GB/s)", flush=True)
    for mname, (fn, wb, y, times) in states.items():
        best = min(times)
        ok = bool(torch.isfinite(y.float()).all())
        print(f"{mname:14s} {best * 1e6:8.1f} us  {wb / best / 1e9:6.1f} GB/s"
              + ("" if ok else "  NON-FINITE"), flush=True)
        rec = dict(mode=mname, us=best * 1e6, gb_s=wb / best / 1e9, bytes=wb)
        if not ok:
            rec["failed"] = "non-finite output"
        records.append(rec)
    return records


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu for the plain versions")
    b = int(os.environ.get("TPUSERVE_QMM_B", "64"))
    rounds = int(os.environ.get("TPUSERVE_QMM_ROUNDS", "5"))
    depth = int(os.environ.get("TPUSERVE_QMM_DEPTH", "32"))
    records = run(device, b, rounds, depth)
    if any("failed" in r for r in records):
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
