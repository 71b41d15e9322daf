"""The int4 nibble-unpack microbenchmark on the card (port of
scripts/unpack_microbench.py).

One int8 stream x [N_ROWS, W2] (537 MB at the defaults, past the 50 MB
L2, so every pass reads it from device memory) goes through kernels that
differ only in what they compute on each block of BLR rows
(ops.unpack_probes, one template in csrc/unpack_probes.cu):

  stream_raw   sum of every byte                   (the stream's floor)
  dot_raw      one int8 tensor-core dot of every row with q [M, W2]
  unpack_cur   the production unpack: each byte widened to 32 bits, & 15,
               >> 4, narrowed; two dots and the -8*sum(q) fold
  unpack_hi    the raw signed byte dotted directly, only the high nibble
               materialised, the low nibble's dot recovered from the two
  unpack_i8    & 15 and >> 4 four bytes an instruction (the flat
               decode-attention kernel's K unpack); two dots

Rates are GB/s of packed bytes streamed; stream_raw against unpack_cur is
the tax, and the candidates bound what a rewrite could recover. On the card
a variant's time is the best of 5 runs of 4 passes in a row between CUDA
events (the TPU script chains 4 passes through a scalar seed and takes the
best of 5). On the CPU the kernels' plain versions run on the host clock: a
check that every variant runs, not a device time. A variant that raises
prints FAILED and the script exits 1.

    python -m tpuserve_torch.scripts.unpack_microbench                 # the card
    TPUSERVE_UNPACK_MODES=stream_raw,unpack_cur python -m tpuserve_torch.scripts.unpack_microbench
    python -m tpuserve_torch.scripts.unpack_microbench --device cpu    # plain versions (slow)
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import torch

from tpuserve_torch.ops import unpack_probes
from tpuserve_torch.scripts.sweep_attention import time_per_call

M = 32           # query rows per dot (the Q_wide row count of a 7B slot)
W2 = 2048        # packed lane width = 7B W/2
BLR = 256        # rows per block: [256, 2048] int8 = 512 KB blocks
N_ROWS = 262144  # 0.537 GB packed stream
KERNELS = unpack_probes.PROBES
N_CHAIN = 4      # passes between the events of one timed run
RUNS = 5         # timed runs; the best counts


def dims() -> Dict[str, int]:
    return dict(M=M, W2=W2, BLR=BLR, N_ROWS=N_ROWS)


def setup(d: Dict[str, int], device, seed: int = 0):
    """x int8 [N_ROWS, W2] in [-128, 127] and q int8 [M, W2] in [-8, 7],
    made on the device from a seed (the TPU script's ranges)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randint(-128, 128, (d["N_ROWS"], d["W2"]), generator=g, device=device,
                      dtype=torch.int8)
    q = torch.randint(-8, 8, (d["M"], d["W2"]), generator=g, device=device, dtype=torch.int8)
    return x, q


def run(names: List[str], d: Dict[str, int], device) -> List[Dict]:
    """Run the variants in order, printing one line each and the tax line;
    returns their records. A variant that raises prints FAILED and is
    recorded as such."""
    x, q = setup(d, device)
    nbytes = x.numel()
    clock = "CUDA events" if device.type == "cuda" else "host clock, plain versions"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# x [{d['N_ROWS']}, {d['W2']}] int8 ({nbytes / 1e6:.0f} MB), q [{d['M']}, "
          f"{d['W2']}], blocks of {d['BLR']} rows; device {name} ({clock})", flush=True)
    records, rates = [], {}
    for var in names:
        try:
            fn = KERNELS[var]
            t0 = time.perf_counter()
            fn(x, q, 0, d["BLR"])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            first_s = time.perf_counter() - t0
            per = time_per_call(lambda: fn(x, q, 1, d["BLR"]), N_CHAIN, device, runs=RUNS)
        except Exception as e:  # reported and recorded; the caller decides
            print(f"{var:12s} FAILED: {type(e).__name__}: {e}", flush=True)
            records.append(dict(variant=var, failed=f"{type(e).__name__}: {e}"))
            continue
        rate = nbytes / per / 1e9
        rates[var] = rate
        print(f"{var:12s} {per * 1e3:8.4f} ms/pass {rate:7.1f} GB/s packed-bytes "
              f"(compile {first_s:.0f}s)", flush=True)
        records.append(dict(variant=var, ms=per * 1e3, gb_s=rate, bytes=nbytes, first_s=first_s))
    if rates.get("stream_raw") and rates.get("unpack_cur"):
        r0, rc = rates["stream_raw"], rates["unpack_cur"]
        print(f"# unpack tax: {r0:.0f} -> {rc:.0f} GB/s ({100 * (1 - rc / r0):.0f}% of stream "
              f"rate lost)", flush=True)
    return records


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu for the plain versions")
    names = [n for n in os.environ.get("TPUSERVE_UNPACK_MODES", ",".join(KERNELS)).split(",")
             if n]
    records = run(names, dims(), device)
    if any("failed" in r for r in records):
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
