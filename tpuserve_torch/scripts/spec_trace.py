#!/usr/bin/env python3
"""Per-dispatch trace of the 7B speculation engine run (the port of
scripts/spec_trace.py): where the speculative engine's time goes.

Builds the same engine as spec_bench.py (spec_k = TPUSERVE_SPEC_BENCH_K,
default 8), wraps the engine's device dispatches, the port's counterparts
of the JAX engine's jitted ones (`_dev_decode`: a decode horizon;
`_dev_verify`: one verify of host-drafted candidates; `_dev_spec_rounds`:
fused draft+verify rounds on the device), runs one warm wave and one
measured wave of the periodic prompt and prints a per-dispatch histogram:
kind(window, horizon) -> count, total ms, best ms (`h` is the decode
horizon, or the rounds of a fused speculation dispatch). Each dispatch is
timed on the device's clock by CUDA events recorded on the engine's
stream before and after it (every dispatch ends in its host copy); on the
CPU by the host clock.

Usage: python -m tpuserve_torch.scripts.spec_trace [--device cpu]

Env: as spec_bench.py (TPUSERVE_SPEC_BENCH_NEW new tokens a request).
"""

import argparse
import collections
import concurrent.futures as cf
import inspect
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from tpuserve_torch.scripts.spec_bench import build  # same 7B config

DISPATCHES = ("_dev_decode", "_dev_verify", "_dev_spec_rounds")


class Tracer:
    """Wraps an engine's dispatches; `events` holds (name, window, horizon,
    start, end) with CUDA events (or host seconds on the CPU)."""

    def __init__(self, eng):
        self.events = []
        self.cuda = eng.device.type == "cuda"
        for name in DISPATCHES:
            self._wrap(eng, name)

    def _wrap(self, eng, name):
        fn = getattr(eng, name)
        sig = inspect.signature(fn)

        def timed(*args, **kw):
            bound = sig.bind(*args, **kw).arguments
            horizon = bound.get("horizon", bound.get("rounds"))
            if self.cuda:
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                out = fn(*args, **kw)
                t1.record()
            else:
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                t1 = time.perf_counter()
            self.events.append((name, bound.get("window"), horizon, t0, t1))
            return out

        setattr(eng, name, timed)

    def seconds(self):
        """(name, window, horizon, seconds) of every dispatch traced."""
        if self.cuda:
            torch.cuda.synchronize()
            return [(n, w, h, t0.elapsed_time(t1) / 1e3) for n, w, h, t0, t1 in self.events]
        return [(n, w, h, t1 - t0) for n, w, h, t0, t1 in self.events]


def drive(eng, tracer, measure: bool):
    rng = np.random.default_rng(0)
    period = rng.integers(100, eng.p.vocab_size, 12).tolist()
    prompt = (period * 10)[:96]
    new_tokens = int(os.environ.get("TPUSERVE_SPEC_BENCH_NEW", "192"))
    slots = eng.n_slots
    if measure:
        tracer.events.clear()
    t0 = time.time()
    with cf.ThreadPoolExecutor(max_workers=slots) as ex:
        futs = [ex.submit(eng.generate, prompt, max_new_tokens=new_tokens)
                for _ in range(slots)]
        outs = [f.result() for f in futs]
    dt = time.time() - t0
    produced = sum(o["num_generated"] for o in outs)
    return produced / dt, dt, produced


def run(device: str = "cuda", warm: bool = True) -> dict:
    """The warm wave (unless `warm` is False: the port compiles nothing at
    first use) and the measured wave; prints the histogram and the JAX
    script's JSON line, and returns them."""
    with tempfile.TemporaryDirectory() as root:
        eng = build(root, "spec7b", int(os.environ.get("TPUSERVE_SPEC_BENCH_K", "8")),
                    device=device)
        try:
            tracer = Tracer(eng)
            if warm:
                tps_w, _, _ = drive(eng, tracer, measure=False)
                print(f"# warm wave: {tps_w:.0f} tok/s", file=sys.stderr, flush=True)
            tps, dt, produced = drive(eng, tracer, measure=True)
            stats = eng.serving_stats()
        finally:
            eng.stop()
    events = tracer.seconds()
    agg = collections.defaultdict(lambda: [0, 0.0, 1e9])
    for name, window, horizon, t in events:
        a = agg[f"{name}(w={window},h={horizon})"]
        a[0] += 1
        a[1] += t
        a[2] = min(a[2], t)
    total_traced = sum(t for *_, t in events)
    print(f"\n# measured wave: {tps:.0f} tok/s, {produced} tokens in {dt:.1f}s "
          f"(traced dispatch time {total_traced:.1f}s)", flush=True)
    print(f"# spec stats: drafted={stats.get('spec_drafted')} "
          f"accepted={stats.get('spec_accepted')}", flush=True)
    for k in sorted(agg, key=lambda k: -agg[k][1]):
        n, tot, best = agg[k]
        print(f"{k:42s} n={n:4d} total {tot*1e3:8.0f}ms  best {best*1e3:7.1f}ms",
              flush=True)
    result = {"metric": "spec_trace", "tokens_per_s": round(tps, 1),
              "traced_s": round(total_traced, 2), "wall_s": round(dt, 2)}
    print(json.dumps(result), flush=True)
    return dict(result, dispatches={k: {"n": v[0], "total_ms": v[1] * 1e3, "best_ms": v[2] * 1e3}
                                    for k, v in agg.items()},
                spec_drafted=stats.get("spec_drafted"), spec_accepted=stats.get("spec_accepted"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
