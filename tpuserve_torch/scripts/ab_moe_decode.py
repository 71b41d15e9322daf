"""MoE decode FFN: the dense all-experts loop against the static-capacity
top-k dispatch, on the card (port of scripts/ab_moe_decode.py).

The dense loop runs every expert over every token and combines through
the routing weights (zero for unrouted pairs); the dispatch gathers each
expert's routed tokens into `cap` rows, runs every expert over its own
rows and scatter-adds the outputs back (models/llama.py::_moe_dispatch).
Decode is weight-read bound, so both stream each expert's weights once; the
dispatch trades fewer rows a matmul for its gather and scatter. The engine
takes the dispatch for decode at T >= TPUSERVE_MOE_DECODE_DISPATCH_T
(default 64, as in the JAX package); this script measures the two at batch
sizes 8 and 64.

Shapes: Mixtral-8x7B's FFN (dim 4096, per-expert ffn 14336, E=8, top-2)
at int4 g128, one layer's FFN alone; the weights are random normals
quantized by quantize_experts (every expert's down projection the same
matrix, as in the JAX script), the router weights random logits, h random
normal in TPUSERVE_AB_MOE_DTYPE (float32, the JAX script's; bfloat16 is the
served activations'). Each mode runs as a chain h = fn(h) * 1e-3 + h at two
depths (TPUSERVE_AB_MOE_DEPTHS, 8 and 32); the per-FFN time is the slope
(t2 - t1) / (d2 - d1) of the best of the interleaved rounds, as the JAX
script takes it. On the card each chain is one CUDA graph (the JAX script's
jitted lax.scan; its capture also shows that neither mode waits on the
device), timed with CUDA events; on the CPU the plain versions run eagerly
on the host clock: a check, not a device time.

    python -m tpuserve_torch.scripts.ab_moe_decode                 # the card
    TPUSERVE_AB_MOE_DTYPE=bfloat16 python -m tpuserve_torch.scripts.ab_moe_decode
    python -m tpuserve_torch.scripts.ab_moe_decode --device cpu

Env: TPUSERVE_AB_MOE_{DIM (4096), FFN (14336), E (8), K (2), ROUNDS (6),
DEPTHS (8,32), DTYPE (float32)}.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import torch

from tpuserve_torch.models import llama
from tpuserve_torch.models.llama import LlamaParams, moe_combine_weights
from tpuserve_torch.quant.core import quantize_experts

BATCHES = (8, 64)


def settings() -> Dict:
    env = os.environ.get
    d1, d2 = (int(x) for x in env("TPUSERVE_AB_MOE_DEPTHS", "8,32").split(","))
    return dict(dim=int(env("TPUSERVE_AB_MOE_DIM", "4096")),
                ffn=int(env("TPUSERVE_AB_MOE_FFN", "14336")),
                e_n=int(env("TPUSERVE_AB_MOE_E", "8")), k=int(env("TPUSERVE_AB_MOE_K", "2")),
                rounds=int(env("TPUSERVE_AB_MOE_ROUNDS", "6")), depths=(d1, d2),
                dtype=getattr(torch, env("TPUSERVE_AB_MOE_DTYPE", "float32")))


def _weights(device, dim: int, ffn: int, e_n: int):
    """Stacked int4 g128 experts quantized from seeded random normals made
    on the device: gate|up [E, dim, 2 ffn], down one [ffn, dim] repeated."""
    g = torch.Generator(device=device).manual_seed(0)
    gu = quantize_experts(torch.randn((e_n, dim, 2 * ffn), generator=g, device=device) * 0.02,
                          bits=4, group_size=128)
    dn_one = torch.randn((ffn, dim), generator=g, device=device) * 0.02
    dn = quantize_experts(dn_one[None].expand(e_n, ffn, dim), bits=4, group_size=128)
    return gu, dn


def modes(gu, dn, p: LlamaParams) -> Dict[str, object]:
    """name -> fn(h [T, dim], w2 [T, E] combine weights) -> [T, dim]."""
    def dense(h, w2):
        out = torch.zeros_like(h)
        for e in range(p.n_experts):
            y = llama.expert_forward(h, gu.expert(e), dn.expert(e), p.ffn_dim)
            out = out + y * w2[:, e:e + 1].to(y.dtype)
        return out

    def dispatch(h, w2):
        cap = max(8, int(2.0 * h.shape[0] * p.n_experts_per_tok / p.n_experts))
        return llama._moe_dispatch(h, w2, gu, dn, p, cap)

    return {"dense": dense, "dispatch": dispatch}


def _chain(fn, w2, depth: int):
    def run(h):
        for _ in range(depth):
            h = fn(h, w2) * 1e-3 + h
        return h
    return run


def run(device, cfg: Dict) -> List[Dict]:
    """Both modes at each batch size, one line a batch size; returns their
    records (a failed one with a `failed` entry)."""
    cuda = device.type == "cuda"
    dim, ffn, e_n, k = cfg["dim"], cfg["ffn"], cfg["e_n"], cfg["k"]
    d1, d2 = cfg["depths"]
    p = LlamaParams(vocab_size=32000, dim=dim, n_layers=1, n_heads=32, n_kv_heads=32,
                    head_dim=max(1, dim // 32), ffn_dim=ffn, n_experts=e_n, n_experts_per_tok=k)
    t0 = time.perf_counter()
    gu, dn = _weights(device, dim, ffn, e_n)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    clock = "CUDA events over a CUDA graph of each chain" if cuda else \
        "host clock, plain versions"
    print(f"# expert weights up: {(gu.nbytes + dn.nbytes) / 1e9:.2f} GB "
          f"({time.perf_counter() - t0:.0f}s); dim {dim} ffn {ffn} E={e_n} k={k} "
          f"{str(cfg['dtype']).replace('torch.', '')} h; device {name} ({clock})", flush=True)
    g = torch.Generator(device=device).manual_seed(1)
    records = []
    for bs in BATCHES:
        h0 = torch.randn((bs, dim), generator=g, device=device).to(cfg["dtype"])
        w2 = moe_combine_weights(torch.randn((bs, e_n), generator=g, device=device), e_n, k)
        fns = modes(gu, dn, p)
        try:
            err = (fns["dense"](h0, w2).float() - fns["dispatch"](h0, w2).float()).abs()
            err = err.max().item()
            legs = {}
            for mname, fn in fns.items():
                for depth in (d1, d2):
                    chain = _chain(fn, w2, depth)
                    t1 = time.perf_counter()
                    y = chain(h0)                       # warm-up (and the kernels' build)
                    if cuda:
                        torch.cuda.synchronize(device)
                        graph = torch.cuda.CUDAGraph()
                        xin = y.clone()
                        with torch.cuda.graph(graph):
                            yout = chain(xin)
                        graph.replay()
                        torch.cuda.synchronize(device)
                        fn_run = (graph, xin, yout)
                    else:
                        fn_run = chain
                    print(f"# bs{bs} {mname}@d{depth} ready in {time.perf_counter() - t1:.0f}s",
                          flush=True)
                    legs[(mname, depth)] = [fn_run, y, []]
        except Exception as e:  # reported and recorded; the caller decides
            print(f"bs={bs} FAIL {type(e).__name__}: {str(e).splitlines()[0][:100]}", flush=True)
            records.append(dict(bs=bs, failed=f"{type(e).__name__}: {e}"))
            continue
        for _ in range(cfg["rounds"]):
            for st in legs.values():
                fn_run, y, times = st
                if cuda:
                    graph, xin, yout = fn_run
                    xin.copy_(y)                        # chain across replays too
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    graph.replay()
                    end.record()
                    torch.cuda.synchronize(device)
                    times.append(start.elapsed_time(end) / 1e3)
                    st[1] = yout.clone()
                else:
                    t1 = time.perf_counter()
                    st[1] = fn_run(y)
                    times.append(time.perf_counter() - t1)
        per = {m: (min(legs[(m, d2)][2]) - min(legs[(m, d1)][2])) / (d2 - d1) * 1e3
               for m in fns}
        finite = all(bool(torch.isfinite(st[1].float()).all()) for st in legs.values())
        ratio = per["dispatch"] / per["dense"]
        print(f"bs={bs}: dense {per['dense']:.3f} ms, dispatch {per['dispatch']:.3f} ms per FFN "
              f"(slope), dispatch/dense {ratio:.3f} (max abs diff {err:.2e})"
              + ("" if finite else "  NON-FINITE"), flush=True)
        rec = dict(bs=bs, dense_ms=per["dense"], dispatch_ms=per["dispatch"], ratio=ratio,
                   max_abs_diff=err)
        if not finite:
            rec["failed"] = "non-finite output"
        records.append(rec)
        del legs
    return records


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu for the plain versions")
    records = run(device, settings())
    if any("failed" in r for r in records):
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
