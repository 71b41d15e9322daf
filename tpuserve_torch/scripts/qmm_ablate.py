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
and the masked steps of both (groups of no multiple of 16 values, bf16 x;
of 32, W4A8), timed at wo's width on x laid out beforehand:
  mk_no_build     no weight code read or masked: the fragments are made
                  from the step's position alone
  mk_no_fast      every K value built on its own, also where a half step
                  lies in one half of a group (the one-octet or ldmatrix
                  read off)
  mk_no_wgmma     no wgmma issued on the masked (and odd-group, general
                  W4A8) paths
  mk_no_flush     the group sums waited for but never scaled into the
                  accumulators
with the kernel that lays x out for them timed alone (bf16: stage_x;
W4A8: quantize_rows, which writes its codes in that layout).

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
    "no_wgmma": [("Wgmma<BT>::mma(part, af, xd(p, pc), pc > 0 || accumulate);", "(void)pc;"),
                 ("Wgmma<BT>::mma(part, af2, xd(p2, pc), 1);", "(void)pc;")],
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
    "mk_no_build": [
        ("    const int e0 = where(p + 8 * h), e7 = where(p + 8 * h + 7);\n"
         "    uint32_t m;\n"
         "    if (FAST && e0 >= 0 && e7 - e0 == 7 << 3) {\n"
         "      const uint32_t w = octet_word(wt, (e0 >> 3) + 2 * tq, warp, gid);\n"
         "      m = BITS == 4 ? (w >> (e0 & 7)) & 0x0F0F0F0Fu : w;\n"
         "    } else {\n"
         "      const int k = p + 8 * h + 2 * tq;\n"
         "      m = prmt(code_pair<BITS>(wt, where(k), warp, gid),\n"
         "               code_pair<BITS>(wt, where(k + 1), warp, gid), 0x5140u);\n"
         "    }\n",
         "    const uint32_t m = (uint32_t)(p + 8 * h + 2 * tq) & 0x07070707u;\n"),
        ("    const int e0 = where(p + 16 * h), e15 = where(p + 16 * h + 15);\n"
         "    if (e0 >= 0 && e15 - e0 == 15 << 3) {\n"
         "      const int j = lane & 7, m = (lane >> 3) & 1;  // a8_load's rows of matrices 0 and 1\n"
         "      const int row = (e0 >> 3) + 4 * (j >> 1) + 2 * ((j >> 2) ^ m) + (j & 1);\n"
         "      uint32_t r0, r1;\n"
         '      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"\n'
         '                   : "=r"(r0), "=r"(r1)\n'
         '                   : "r"(wts + row * 64 + ((warp ^ ((row >> 1) & 3)) << 4)));\n'
         "      f[2 * h] = codes16(prmt(r0, r1, sel0), (e0 & 7) ? 0 : 4);\n"
         "      f[2 * h + 1] = codes16(prmt(r0, r1, sel1), (e0 & 7) ? 0 : 4);\n"
         "      continue;\n"
         "    }\n"
         "    const int k = p + 16 * h + 4 * tq;\n"
         "    const uint32_t ab = prmt(code_pair<4>(wt, where(k), warp, gid),\n"
         "                             code_pair<4>(wt, where(k + 1), warp, gid), 0x5140u);\n"
         "    const uint32_t cd = prmt(code_pair<4>(wt, where(k + 2), warp, gid),\n"
         "                             code_pair<4>(wt, where(k + 3), warp, gid), 0x5140u);\n",
         "    const uint32_t ab = (uint32_t)(p + 4 * tq) & 0x07070707u, cd = ab ^ 0x01010101u;\n"),
    ],
    "mk_no_fast": [("    if (FAST && e0 >= 0 && e7 - e0 == 7 << 3) {", "    if (false) {"),
                   ("    if (e0 >= 0 && e15 - e0 == 15 << 3) {", "    if (false) {")],
    "mk_no_wgmma": [("      if (s < n) Wgmma<BT>::mma(part, fr[s], xdesc(px[s], pc), "
                     "s > 0 || pc > 0 || accumulate);", "      (void)s;"),
                    ("        if (i < n) WgmmaS8<BT>::mma(part, fr[i], xdesc(px[i]), "
                     "i > 0 || accumulate);", "        (void)i;")],
    "mk_no_flush": [("      close_group<BT>(acc, part, sc + j * COLS, c0);", "      wg_wait0();"),
                    ("        flush(sc + j * COLS);",
                     "        wg_wait0();\n        accumulate = 0;")],
}
# the masked routes' cases: (what, bits, W4A8, K, N, group); an odd-group
# case (g48, bf16 x) beside them for the per-group cost of the other path
MASKED = (("bf16 int4 g40", 4, False, 4000, 4096, 40), ("bf16 int4 g24", 4, False, 4032, 4096, 24),
          ("bf16 int8 g40", 8, False, 4000, 4096, 40), ("W4A8 g48", 4, True, 4032, 4096, 48),
          ("W4A8 g12", 4, True, 4032, 4096, 12), ("W4A8 g136", 4, True, 4080, 4096, 136),
          ("bf16 int4 g344 (w_down)", 4, False, 11008, 4096, 344),
          ("W4A8 g344 (w_down)", 4, True, 11008, 4096, 344),
          ("bf16 int4 g48 (odd)", 4, False, 4032, 4096, 48))


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


def graph_ms(call, reps: int = 20) -> float:
    """Device ms of one call: CUDA events around a CUDA graph of `reps`."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
            else:    # bf16 x: one piece
                rc = fn(x.data_ptr(), *w, out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, k, n,
                        128, 4, *tail[:-1], 1, tail[-1])
            if rc:
                raise RuntimeError(f"quant_matmul variant: CUDA error {rc}")

        ms = graph_ms(call)
        per.append(ms * 1e3)
        total += ms * (1 if n == 32000 else 32)
    return per, total


def masked_us(fns: dict, b: int) -> dict:
    """µs of each masked case (MASKED) for each variant's entries, on x
    laid out beforehand (the kernel that lays it out timed alone)."""
    dev = torch.device("cuda")
    cnt = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for what, bits, a8, k, n, gs in MASKED:
        rows = k // 2 if bits == 4 else k
        q = torch.randint(0, 256, (rows, n), generator=g, device=dev, dtype=torch.int32).to(
            torch.uint8 if bits == 4 else torch.int8)
        scale = torch.rand((k // gs, n), generator=g, device=dev) * 0.01
        x = torch.randn(b, k, device=dev, dtype=torch.bfloat16)
        masked = qm.masked_group(gs, a8)
        idx = qm.stage_index(bits, k, gs, dev) if masked else None
        if a8:   # int8 codes, in the masked layout where the group needs it
            xs = qm.quantize_rows(x, idx)[0]
            layout = {"quantize_rows": graph_ms(lambda: qm.quantize_rows(x, idx)) * 1e3}
        else:
            xs = qm.stage_x(x, idx) if masked else x
            layout = {"stage_x": graph_ms(lambda: qm.stage_x(x, idx)) * 1e3} if masked else {}
        plan = qm.hopper_plan(b, k, n, bits, kernels.sm_count(dev), gs=gs, a8=a8)
        res = torch.empty(b, n, device=dev, dtype=torch.bfloat16)
        ws = torch.empty(plan[4], b, n, device=dev)
        row_scale = torch.full((b,), 0.01, device=dev)
        times = dict(layout)
        for name, entry in fns.items():
            fn = entry["a8" if a8 else "bf16"]

            def call():
                tail = plan + (torch.cuda.current_stream().cuda_stream,)  # the capture's
                if a8:
                    rc = fn(xs.data_ptr(), q.data_ptr(), scale.data_ptr(), row_scale.data_ptr(),
                            res.data_ptr(), ws.data_ptr(), cnt.data_ptr(), b, k, n, gs, 1, *tail)
                else:    # bf16 x: one piece
                    rc = fn(xs.data_ptr(), q.data_ptr(), scale.data_ptr(), res.data_ptr(),
                            ws.data_ptr(), cnt.data_ptr(), b, k, n, gs, bits, *tail[:-1], 1,
                            tail[-1])
                if rc:
                    raise RuntimeError(f"quant_matmul variant {name}: CUDA error {rc}")

            times[name] = graph_ms(call) * 1e3
        out[what] = times
    return out


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
                if name.startswith("mk_"):
                    continue
                per, total = step_ms(entry["a8" if a8 else "bf16"], b, weights, a8)
                print(f"B={b} {name:14s} {'w4a8' if a8 else 'bf16'} us "
                      f"{[round(v, 1) for v in per]} step_ms {total:.3f}", flush=True)
        masked = masked_us({k: v for k, v in fns.items() if k == "base" or k.startswith("mk_")}, b)
        for what, times in masked.items():
            print(f"B={b} masked {what} at wo's width, us: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in times.items()), flush=True)


if __name__ == "__main__":
    main()
