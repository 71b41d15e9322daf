"""Where the unpack-microbenchmark kernels' time goes, on the card: copies
of csrc/unpack_probes.cu with one part cut out each, built side by side
with nvcc and timed against the kernel as it is at the microbenchmark's
defaults (x int8 [262144, 2048], 537 MB, past the L2; q [32, 2048]).

Variants (each a text patch of the source; a patch that no longer matches
the source stops the script, so that it is brought up to date with the
kernel):
  base         the kernel as it is
  no_unpack    the unpack variants' nibble instructions replaced by a
               pass-through (both A operands are the raw bytes)
  no_wgmma     no wgmma issued (the fragments are still loaded and
               unpacked)
  no_ldsm      the A fragments not loaded from shared memory
  ring_only    neither fragments nor wgmma: the TMA ring and barriers alone
  two_acc      the same function with the two dots of unpack_cur and
               unpack_i8 in two accumulators, added at the flush (a design
               alternative, exact)

The outputs of the cut variants are wrong on purpose; only times count.
Times: CUDA events around a CUDA graph of 20 passes, one SM-count grid,
as chip_smoke.py times the kernel. Then, for each variant's library,
cuobjdump's count of wgmma instructions (IGMMA) in each kernel instance
and of the waits for every pending wgmma (WARPGROUP.DEPBAR.LE gsb0, 0x0)
that ptxas placed among them.

    python -m tpuserve_torch.scripts.unpack_ablate
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import torch

from tpuserve_torch import kernels
from tpuserve_torch.ops import unpack_probes as up
from tpuserve_torch.scripts import unpack_microbench as ub

_UNPACK = ("          if (V == UNPACK_CUR) {\n"
           "            unpack_cur(w[i], p[u][i], r[u][i]);\n")
_RS = ("        Wg<MN>::rs(acc, p[u], db);\n"
       "        Wg<MN>::rs(V == UNPACK_HI ? acc2 : acc, r[u], db);\n")
_SS = ("        Wg<V == STREAM_RAW ? 8 : MN>::ss(acc, desc_sw128(xs + wg * 64 * BOX + 32 * u),\n"
       "                                         desc_sw128(bs + 32 * u));\n")
_LDSM = "        load_frag(w, xs, r0, u, lane);\n"
_NO_UNPACK = [(_UNPACK, "          if (true) {\n            p[u][i] = r[u][i] = w[i];\n"
                        "          } else if (V == UNPACK_CUR) {\n"
                        "            unpack_cur(w[i], p[u][i], r[u][i]);\n")]
_NO_WGMMA = [(_RS, "        fence_regs<4>(p[u]);\n        fence_regs<4>(r[u]);\n        (void)db;\n"),
             (_SS, "        (void)bs;\n")]
PATCHES = {
    "base": [],
    "no_unpack": _NO_UNPACK,
    "no_wgmma": _NO_WGMMA,
    "no_ldsm": [(_LDSM, "        for (int i = 0; i < 4; ++i) w[i] = xs + 16 * u + i + lane;\n")],
    "ring_only": _NO_WGMMA + _NO_UNPACK + [
        (_LDSM, "        for (int i = 0; i < 4; ++i) w[i] = xs + 16 * u + i + lane;\n")],
    "two_acc": [(_RS, "        Wg<MN>::rs(acc, p[u], db);\n        Wg<MN>::rs(acc2, r[u], db);\n"),
                ("        long long val = acc[i];\n",
                 "        long long val = acc[i] + (V == UNPACK_HI ? 0 : acc2[i]);\n")],
}


def patched(name: str) -> str:
    """The kernel source with variant `name`'s parts cut out."""
    src = (kernels.CSRC / "unpack_probes.cu").read_text()
    for old, new in PATCHES[name]:
        if old not in src:
            raise SystemExit(f"unpack_ablate: variant {name} no longer matches the source")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict:
    """Every variant as its own library (all nvcc runs at once)."""
    procs = {}
    for name in PATCHES:
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        (d / "unpack_probes.cu").write_text(patched(name))
        so = out / f"lib_{name}.so"
        cmd = [kernels._nvcc(), "-gencode", kernels.ARCH, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", "-shared", "-I", str(d), str(d / "unpack_probes.cu"), "-o", str(so),
               "-ldl"]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"unpack_ablate: nvcc failed for {name}:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(so)).tpuserve_unpack_probe
        fn.argtypes = kernels._SIGNATURES["tpuserve_unpack_probe"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def pass_ms(fn, variant: str, x, q, grid: int) -> float:
    """Device ms of one pass of `variant` through the library function `fn`."""
    n, w2 = x.shape
    out = torch.zeros((q.shape[0], 128), dtype=torch.int64, device=x.device)

    def call():
        rc = fn(x.data_ptr(), q.data_ptr(), out.data_ptr(), n, w2, q.shape[0],
                up.VARIANTS.index(variant), 0, grid, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"unpack probe variant: CUDA error {rc}")

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
    return start.elapsed_time(end) / 20


def sass_counts(so: Path) -> dict:
    """{kernel instance (variant, N): (wgmma instructions, waits for all)}
    from cuobjdump's SASS of one library."""
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        m = re.search(r"unpack_probe_kernelILi(\d)ELi(\d+)E", func.split("\n", 1)[0])
        if m:
            key = f"{up.VARIANTS[int(m.group(1))]} N{m.group(2)}"
            counts[key] = (func.count("GMMA."), func.count("DEPBAR.LE gsb0, 0x0"))
    return counts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(PATCHES), help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("unpack_ablate needs the card (nvcc and CUDA)")
    names = args.variants.split(",")
    unknown = [n for n in names if n not in PATCHES]
    if unknown:
        raise SystemExit(f"unpack_ablate: unknown variants {unknown}; known: {list(PATCHES)}")
    fns = build(kernels.BUILD_DIR / "unpack_ablate")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    d = ub.dims()
    x, q = ub.setup(d, torch.device("cuda"))
    grid = kernels.sm_count(x.device)
    print(f"# {smi}; x int8 [{d['N_ROWS']}, {d['W2']}], q [{d['M']}, {d['W2']}], grid {grid}; "
          f"ms a pass (CUDA graph of 20)", flush=True)
    for name in names:
        row = {v: pass_ms(fns[name], v, x, q, grid) for v in up.VARIANTS}
        print(f"{name:10s} " + " ".join(f"{v} {ms:.4f}" for v, ms in row.items()), flush=True)
    print("# SASS: wgmma instructions / waits for every pending wgmma, each kernel instance",
          flush=True)
    for name in names:
        counts = sass_counts(kernels.BUILD_DIR / "unpack_ablate" / f"lib_{name}.so")
        print(f"{name:10s} " + ", ".join(f"{k} {g}/{w}" for k, (g, w) in sorted(counts.items())),
              flush=True)


if __name__ == "__main__":
    main()
