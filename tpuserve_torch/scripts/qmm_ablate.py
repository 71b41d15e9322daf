"""Where the Hopper quant-matmul's time goes, on the card: copies of
csrc/quant_matmul.cu with one part cut out each, built side by side with
nvcc and timed against the kernel as it is at the 7B decode shapes.

Variants (each a text patch of the source; a patch that no longer matches
the source stops the script, so that it is brought up to date with the
kernel). The bf16 kernel (qmm_wgmma_kernel):
  base         the kernels as they are (timed on both entries)
  tma_only     the g128 consumers convert and multiply nothing: the TMA
               ring, the barriers and the scale epilogue alone
  no_wgmma     no wgmma issued (the fragments are still built)
  no_convert   the nibble-to-bf16 conversion replaced by a pass-through
  no_lds       the weight bytes not read from shared memory
  no_epilogue  the g128 group sums never scaled into the accumulators
and the W4A8 kernel (qmm_a8_kernel, int8 x from the row quantization):
  a8_tma_only     the g128 consumers load, convert and multiply nothing:
                  the ring, the barriers and the group flushes alone
  a8_no_wgmma     no wgmma issued (the fragments are still built)
  a8_no_convert   the nibble-to-s8 conversion replaced by a pass-through
  a8_no_ldmatrix  the weight bytes not read from shared memory
  a8_no_flush     the group sums never scaled into the accumulators

The outputs of the cut variants are wrong on purpose; only times count.
Times: CUDA events around a CUDA graph of 20 calls, weights L2-warm (one
copy per shape), the wrapper's own launch plan, B=64 and B=16; the W4A8
kernel alone on x quantized beforehand.

    python -m tpuserve_torch.scripts.qmm_ablate
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path

import torch

from tpuserve_torch import kernels
from tpuserve_torch.ops import quant_matmul as qm
from tpuserve_torch.quant.core import quantize

SHAPES = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000))
PATCHES = {
    "base": [],
    "tma_only": [("      g128_stage<BT>(cur, ", "      if (0) g128_stage<BT>(cur, ")],
    "no_wgmma": [("  Wgmma<BT>::mma(part, af, desc, accumulate);\n"
                  "  if (af2) Wgmma<BT>::mma(part, af2, desc2, 1);", "")],
    "no_convert": [("  const uint32_t v = prmt(m, 0x43434343u, sel);  // 128 + code in each half",
                    "  return m ^ sel;\n  const uint32_t v = 0;")],
    "no_lds": [("  const uint32_t a = *reinterpret_cast<const uint16_t*>(wt + off);\n"
                "  const uint32_t b = *reinterpret_cast<const uint16_t*>(wt + off + 64);",
                "  const uint32_t a = off * 3u, b = off + (uint32_t)(uintptr_t)wt;")],
    "no_epilogue": [("        scale_into<BT>(acc, prev, sp.x, sp.y);\n", "")],
    "a8_tma_only": [("      a8_g128_stage<BT>(cur, fc, ", "      if (0) a8_g128_stage<BT>(cur, fc, ")],
    "a8_no_wgmma": [("    WgmmaS8<BT>::mma(part, fr[i], desc_sw64(xb + (i >> 1) * xbox_bytes + 32 * (i & 1)), "
                     "i > 0);", "    (void)i;")],
    "a8_no_convert": [("  return ((w << sh) & 0xF0F0F0F0u) ^ 0x80808080u;", "  return w ^ sh;")],
    "a8_no_ldmatrix": [("  asm volatile(\"ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                        "{%0, %1, %2, %3}, [%4];\"\n"
                        "               : \"=r\"(r[0]), \"=r\"(r[1]), \"=r\"(r[2]), \"=r\"(r[3])\n"
                        "               : \"r\"(addr));",
                        "  r[0] = addr; r[1] = addr * 3u; r[2] = addr ^ 7u; r[3] = addr + 5u;")],
    "a8_no_flush": [("        acc[4 * j + e] += f * (e < 2 ? s0 : s1);", "        acc[4 * j + e] += s0 * (float)e;")],
}


def patched(name: str) -> str:
    """The kernel source with variant `name`'s parts cut out."""
    src = (kernels.CSRC / "quant_matmul.cu").read_text()
    for old, new in PATCHES[name]:
        if old not in src:
            raise SystemExit(f"qmm_ablate: variant {name} no longer matches the source")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict:
    """Every variant as its own library (all nvcc runs at once)."""
    procs = {}
    for name in PATCHES:
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        (d / "quant_matmul.cu").write_text(patched(name))
        so = out / f"lib_{name}.so"
        cmd = [kernels._nvcc(), "-gencode", kernels.ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-shared", "-I", str(d), str(d / "quant_matmul.cu"), "-o", str(so),
               "-ldl"]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"qmm_ablate: nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(so))
        fns[name] = {}
        for entry in ("tpuserve_quant_matmul_bf16", "tpuserve_quant_matmul_a8"):
            fn = getattr(lib, entry)
            fn.argtypes = kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[name]["a8" if entry.endswith("a8") else "bf16"] = fn
    return fns


def step_ms(fn, b: int, weights: dict, a8: bool = False) -> tuple:
    """(µs per shape, ms of the 129 calls of one 7B step) for one variant:
    the bf16 entry, or (a8) the W4A8 entry on int8 x."""
    dev = torch.device("cuda")
    cnt = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    per, total = [], 0.0
    for (k, n), qt in weights.items():
        x = torch.randn(b, k, device=dev, dtype=torch.bfloat16)
        if a8:
            x = torch.randint(-127, 128, (b, k), device=dev, dtype=torch.int32).to(torch.int8)
        bt, nwg_n, nwg_b, sps, splits = qm.hopper_plan(b, k, n, 4, kernels.sm_count(dev), a8=a8)
        out = torch.empty(b, n, device=dev, dtype=torch.bfloat16)
        ws = torch.empty(splits, b, n, device=dev)
        row_scale = torch.full((b,), 0.01, device=dev)

        def call():
            w = (qt.q.data_ptr(), qt.scale.data_ptr())
            tail = (bt, nwg_n, nwg_b, sps, splits, torch.cuda.current_stream().cuda_stream)
            if a8:   # int8 x, its row scales, bf16 out
                rc = fn(x.data_ptr(), *w, row_scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
                        cnt.data_ptr(), b, k, n, 128, 1, *tail)
            else:
                rc = fn(x.data_ptr(), *w, out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, k, n,
                        128, 4, *tail)
            if rc:
                raise RuntimeError(f"quant_matmul variant: CUDA error {rc}")

        call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(20):
                call()
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        per.append(ms * 1e3)
        total += ms * (1 if n == 32000 else 32)
    return per, total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", default="64,16", help="batch rows, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("qmm_ablate needs the card (nvcc and CUDA)")
    fns = build(kernels.BUILD_DIR / "qmm_ablate")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"# {smi}; int4 g128, shapes (K, N) {SHAPES}, L2-warm", flush=True)
    weights = {s: quantize(torch.randn(*s) * 0.05, bits=4, group_size=128).to("cuda")
               for s in SHAPES}
    for b in (int(v) for v in args.b.split(",")):
        for name, entry in fns.items():
            for a8 in (False, True):
                if (name.startswith("a8_") and not a8) or (a8 and not (
                        name == "base" or name.startswith("a8_"))):
                    continue
                per, total = step_ms(entry["a8" if a8 else "bf16"], b, weights, a8)
                print(f"B={b} {name:14s} {'w4a8' if a8 else 'bf16'} us "
                      f"{[round(v, 1) for v in per]} step_ms {total:.3f}", flush=True)


if __name__ == "__main__":
    main()
