"""The decode-attention diagnostic ladder on the card (port of
scripts/sweep_attention.py, with scripts/bench_attention.py::xla_attention
as the `xla` variant).

Every variant reads the same int8 K/V cache [S, L, Hkv, 128] with f32
scales; each line gives its time per call and the rate at which it streams
the cache:

  dma         stream ceiling: blocks of 64 positions x all heads of
              [S, L*Hkv, 128], column sums of every byte (ops.attention_probes)
  dma_wide    the same bytes as rows of [S*L, Hkv*128], 2-D block order
  dma_wide3d  ... in (row block, slot) order
  dot32       the int8 score dot and the bf16 P@V of every query row with
              every cache row, no softmax
  g32s g32s_bl64 g32s_bl128 g16s g8s g16d g32d
              the grouped kernel (ops.decode_attention.decode_attention)
              with g_kv kv heads a block and block_l 256 (or _blN); the
              TPU's "d" variants turned on a dynamic DMA skip: the port's
              kernel always skips blocks past a slot's position, so d = s
  g1s         the grouped kernel at the port's default split (one kv head)
  wide wide_bl128
              decode_attention_wide (the flat kernel over the cache), block_l
              256 / 128
  xla         the decode step's einsum path (models.llama._attend_window)

    python -m tpuserve_torch.scripts.sweep_attention                # the card
    TPUSERVE_SWEEP=dma,g1s,wide python -m tpuserve_torch.scripts.sweep_attention
    python -m tpuserve_torch.scripts.sweep_attention --device cpu   # plain versions

Shapes: TPUSERVE_SWEEP_S, _L, _HKV, _REP, _ITERS (defaults: the Llama-2-7B
decode step, S=64, L=256, Hkv=32, rep 1, 30 iterations); every slot at
position L-1. On the card a variant's time is the best of 3 runs of ITERS
calls in a row on one stream, between CUDA events; K and V (2 x 64 MB at
the defaults) exceed the 50 MB L2, so each call reads them from device
memory. On the CPU the kernels' plain versions run on the host clock: a
check that every variant runs, not a device time.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, List

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM published memory rate
DEFAULT = "dma,dot32,g32s,g32s_bl64,xla,g16s"
VARIANTS = ("dma", "dma_wide", "dma_wide3d", "dot32", "g32s", "g32s_bl64", "g32s_bl128",
            "g16s", "g8s", "g16d", "g32d", "g1s", "wide", "wide_bl128", "xla")
_GROUPED = {"g32s": (32, 256), "g32s_bl64": (32, 64), "g32s_bl128": (32, 128),
            "g16s": (16, 256), "g8s": (8, 256), "g16d": (16, 256), "g32d": (32, 256),
            "g1s": (1, 256)}
_LABEL = {"dma": "dma_ceiling", "dma_wide": "dma_wide_2d", "dma_wide3d": "dma_wide_3d",
          "dot32": "dot_only_g32", "wide": "wide_v3", "wide_bl128": "wide_v3_bl128",
          "xla": "xla_einsum"}


def shapes() -> Dict[str, int]:
    env = os.environ.get
    return dict(S=int(env("TPUSERVE_SWEEP_S", "64")), L=int(env("TPUSERVE_SWEEP_L", "256")),
                HKV=int(env("TPUSERVE_SWEEP_HKV", "32")), REP=int(env("TPUSERVE_SWEEP_REP", "1")),
                ITERS=int(env("TPUSERVE_SWEEP_ITERS", "30")))


def setup(dims: Dict[str, int], device, seed: int = 0):
    """q [S, H, 128] bf16 scaled by 1/sqrt(128), k/v [S, L, Hkv, 128] int8,
    head-major scales [S, Hkv, L] f32, positions L-1, made on the device
    from a seed."""
    s, l, n_kv, hd = dims["S"], dims["L"], dims["HKV"], 128
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = (torch.randn((s, n_kv * dims["REP"], hd), generator=g, device=device)
         / math.sqrt(hd)).to(torch.bfloat16)
    k, v = (torch.randint(-127, 127, (s, l, n_kv, hd), generator=g, device=device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((s, n_kv, l), generator=g, device=device) * 0.019 + 0.001
              for _ in range(2))
    positions = torch.full((s,), l - 1, dtype=torch.int32, device=device)
    return q, k, v, ks, vs, positions


def _variant(name: str, dims, q, k, v, ks, vs, positions) -> Callable[[], torch.Tensor]:
    """The call one iteration of `name` makes."""
    from tpuserve_torch.models.llama import LlamaParams, _attend_window
    from tpuserve_torch.ops import attention_probes as probes
    from tpuserve_torch.ops.decode_attention import decode_attention, decode_attention_wide

    if name == "dma":
        return lambda: probes.dma_bound(k, v)
    if name in ("dma_wide", "dma_wide3d"):
        return lambda: probes.dma_wide(k, v, three_d=name == "dma_wide3d")
    if name == "dot32":
        qi = probes.probe_q(q)
        return lambda: probes.dot_only(qi, k, v)
    if name in _GROUPED:
        g_kv, block_l = _GROUPED[name]
        kst, vst = ks.transpose(1, 2), vs.transpose(1, 2)   # [S, L, Hkv] views
        return lambda: decode_attention(q, k, v, kst, vst, positions, block_l=block_l, g_kv=g_kv)
    if name in ("wide", "wide_bl128"):
        block_l = 128 if name == "wide_bl128" else 256
        return lambda: decode_attention_wide(q, k, v, ks, vs, positions, block_l=block_l)
    if name == "xla":
        s, l, n_kv, hd = k.shape
        p = LlamaParams(n_heads=q.shape[1], n_kv_heads=n_kv, head_dim=hd)
        # bench_attention.xla_attention takes q already scaled; the model's
        # einsum path scales it, so it gets q unscaled
        q4 = (q.to(torch.float32) * math.sqrt(hd)).to(q.dtype)[:, None]
        mask = (torch.arange(l, device=k.device)[None, :]
                <= positions.clamp_min(0)[:, None])[:, None]
        active = (positions >= 0)[:, None, None]
        return lambda: torch.where(active, _attend_window(
            q4, k.view(s, l, -1), v.view(s, l, -1), ks, vs, mask, p), 0.0)
    raise ValueError(f"unknown sweep variant {name!r}; known: {', '.join(VARIANTS)}")


def time_per_call(fn: Callable[[], torch.Tensor], iters: int, device, runs: int = 3) -> float:
    """Seconds per call: the best of `runs` runs of `iters` calls in a row,
    after one warm-up call. CUDA events on the card, the host clock on the
    CPU."""
    fn()
    best = float("inf")
    for _ in range(runs):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            best = min(best, (time.perf_counter() - t0) / iters)
    return best


def run(which: List[str], dims: Dict[str, int], device) -> List[Dict]:
    """Run the variants in order, printing one line each; returns their
    records. A variant that raises prints FAILED and is recorded as such."""
    q, k, v, ks, vs, positions = setup(dims, device)
    kv_bytes = k.numel() + v.numel()
    all_bytes = kv_bytes + 4 * (ks.numel() + vs.numel())
    clock = "CUDA events" if device.type == "cuda" else "host clock, plain versions"
    print(f"# S={dims['S']} L={dims['L']} Hkv={dims['HKV']} rep={dims['REP']} KV "
          f"{kv_bytes / 1e6:.0f} MB + scales {(all_bytes - kv_bytes) / 1e6:.0f} MB, "
          f"iters={dims['ITERS']}", flush=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# device {name} ({clock})", flush=True)
    records = []
    for var in which:
        label = _LABEL.get(var, var)
        nbytes = kv_bytes if var in ("dma", "dma_wide", "dma_wide3d", "dot32") else all_bytes
        try:
            per = time_per_call(_variant(var, dims, q, k, v, ks, vs, positions), dims["ITERS"],
                                device)
        except Exception as e:  # reported and recorded; the caller decides
            print(f"{label:16s} FAILED: {type(e).__name__}: {e}", flush=True)
            records.append(dict(variant=var, label=label, failed=f"{type(e).__name__}: {e}"))
            continue
        rate = nbytes / per
        share = (f" ({100 * rate / HBM_BYTES_PER_S:5.1f}% of 3.35 TB/s)"
                 if device.type == "cuda" else "")
        print(f"{label:16s} {per * 1e6:9.1f} us/it {rate / 1e9:7.1f} GB/s{share}", flush=True)
        records.append(dict(variant=var, label=label, us=per * 1e6, gb_s=rate / 1e9,
                            bytes=nbytes))
    return records


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu for the plain versions")
    which = [w for w in os.environ.get("TPUSERVE_SWEEP", DEFAULT).split(",") if w]
    records = run(which, shapes(), device)
    if any("failed" in r for r in records):
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
