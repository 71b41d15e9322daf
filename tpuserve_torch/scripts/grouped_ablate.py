"""Where the grouped Hopper decode attention's time goes, on the card:
copies of csrc/decode_attention_grouped_hopper.cu with its ring changed or
one part cut out, built side by side with nvcc and timed through the
port's wrappers at the [grouped] phase's shape (S=64, H=Hkv=32, L=256,
block_l 256, chip_smoke's step positions).

Variants (each a text patch of the source; a patch that no longer matches
the source stops the script, so that it is brought up to date with the
kernel):
  base         the kernel as it is (3 stages, 4 blocks an SM)
  s2b6         a 2-stage ring, 6 blocks an SM
  s4b3         a 4-stage ring, 3 blocks an SM
  s6b2         a 6-stage ring, 2 blocks an SM
  no_convert   V's codes go to the bf16 mma unconverted (raw bits)
  no_pv        no P @ V: neither the conversion nor the bf16 mma

The outputs of no_convert and no_pv are wrong on purpose; only times
count. Cases: the int8 window and the packed int4 window, under
TPUSERVE_ATTN_DYNSKIP=0 and =1 (one kv unit a block: g_kv changes nothing
on the card). Times: CUDA events around
a CUDA graph of 20 calls, two layers rotated (each more than the 50 MB
L2). One line a variant and case, in ms a layer, with the card's name and
power limit first; every time goes to chiprun_out/grouped_ablate.json.

    python -m tpuserve_torch.scripts.grouped_ablate
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
from pathlib import Path

import torch

from tpuserve_torch import kernels
from tpuserve_torch.ops import decode_attention as da

SOURCE = "decode_attention_grouped_hopper.cu"
ENTRY = "tpuserve_decode_attention_grouped_hopper"
_RING = ("  static constexpr int STAGES = 3;\n"
         "  static constexpr int BLOCKS = NT == 1 ? 4 : 3;\n")
_S8 = ("              const uint32_t a0 = s8_to_bf16x2<0, 2>(r0), a1 = s8_to_bf16x2<1, 3>(r0);\n"
       "              const uint32_t a2 = s8_to_bf16x2<0, 2>(r1), a3 = s8_to_bf16x2<1, 3>(r1);\n")
_U4 = ("              const uint32_t la0 = u4_to_bf16x2<0, 2>(l0), la1 = u4_to_bf16x2<1, 3>(l0);\n"
       "              const uint32_t la2 = u4_to_bf16x2<0, 2>(l1), la3 = u4_to_bf16x2<1, 3>(l1);\n"
       "              const uint32_t ha0 = u4_to_bf16x2<0, 2>(h0), ha1 = u4_to_bf16x2<1, 3>(h0);\n"
       "              const uint32_t ha2 = u4_to_bf16x2<0, 2>(h1), ha3 = u4_to_bf16x2<1, 3>(h1);\n")


def _ring(stages: int, blocks1: int, blocks2: int) -> list:
    return [(_RING, f"  static constexpr int STAGES = {stages};\n"
                    f"  static constexpr int BLOCKS = NT == 1 ? {blocks1} : {blocks2};\n")]


PATCHES = {
    "base": [],
    "s2b6": _ring(2, 6, 4),
    "s4b3": _ring(4, 3, 3),
    "s6b2": _ring(6, 2, 2),
    "no_convert": [(_S8, "              const uint32_t a0 = r0, a1 = r0 >> 8, a2 = r1, a3 = r1 >> 8;\n"),
                   (_U4, "              const uint32_t la0 = l0, la1 = l0 >> 8, la2 = l1, la3 = l1 >> 8;\n"
                         "              const uint32_t ha0 = h0, ha1 = h0 >> 8, ha2 = h1, ha3 = h1 >> 8;\n")],
    "no_pv": [("                mma_bf16(pacc[c][n], la0, la1, la2, la3, pl[n], ph[n]);\n"
               "                mma_bf16(pacc_hi[c][n], ha0, ha1, ha2, ha3, pl[n], ph[n]);\n", ""),
              ("              for (int n = 0; n < NT; ++n) mma_bf16(pacc[c][n], a0, a1, a2, a3, pl[n], ph[n]);\n",
               "              for (int n = 0; n < NT; ++n) {}\n")],
}


def patched(name: str) -> str:
    """The kernel source with variant `name` applied."""
    src = (kernels.CSRC / SOURCE).read_text()
    for old, new in PATCHES[name]:
        if old not in src:
            raise SystemExit(f"grouped_ablate: variant {name} no longer matches the source")
        src = src.replace(old, new)
    return src


def build(out: Path) -> dict:
    """Every variant's grouped entry, each from its own library (all nvcc
    runs at once)."""
    procs = {}
    for name in PATCHES:
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(kernels.CSRC, d)
        (d / SOURCE).write_text(patched(name))
        so = out / f"lib_{name}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS[:-2], "-shared", "-I", str(d),
               str(d / SOURCE), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"grouped_ablate: nvcc failed for {name}:\n{log[-3000:]}")
        fn = getattr(ctypes.CDLL(str(so)), ENTRY)
        fn.argtypes = kernels._SIGNATURES[ENTRY]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


class _Lib:
    """The kernel library with the grouped entry taken from a variant."""

    def __init__(self, real, fn):
        self.real, self.fn = real, fn

    def __getattr__(self, name):
        return self.fn if name == ENTRY else getattr(self.real, name)


@contextlib.contextmanager
def variant(fn):
    """The port's wrappers calling `fn` as the grouped entry."""
    real = kernels.lib
    lib = _Lib(real(), fn)
    kernels.lib = lambda: lib
    try:
        yield
    finally:
        kernels.lib = real


def graph_ms(fn, reps: int = 20) -> float:
    """ms a call: CUDA events around a CUDA graph of `reps` calls."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(seed: int = 8):
    """Two layers of an int8 and a packed int4 window at the [grouped]
    phase's shape, f32 head-major scales, bf16 q, the step positions."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    s, l, hkv, hd = 64, 256, 32, 128
    pos = torch.randint(100, 250, (s,), generator=g, device=dev, dtype=torch.int32)
    pos[7] = -1
    kv8 = [torch.randint(-127, 128, (2, s, l, hkv * hd), generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8) for _ in range(2)]
    kv4 = [torch.randint(0, 256, (2, s, l, hkv * hd // 2), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8) for _ in range(2)]
    sc = [(torch.rand((2, s, hkv, l), generator=g, device=dev) + 0.5) * 0.01 for _ in range(2)]
    q = (torch.randn((s, hkv, hd), generator=g, device=dev) / hd ** 0.5).to(torch.bfloat16)
    return q, kv8, kv4, sc, pos


def cases(q, kv8, kv4, sc, pos):
    """(name, call) of every timed case."""
    s, hd = q.shape[0], q.shape[2]
    l, hkv = kv8[0].shape[2], sc[0].shape[2]

    def int8(i):
        return da.decode_attention(
            q, kv8[0][i % 2].view(s, l, hkv, hd), kv8[1][i % 2].view(s, l, hkv, hd),
            sc[0][i % 2].transpose(1, 2), sc[1][i % 2].transpose(1, 2), pos)

    def int4(i):
        return da.decode_attention_packed(q, kv4[0][i % 2], kv4[1][i % 2], sc[0][i % 2],
                                          sc[1][i % 2], pos)

    return [("int8", int8), ("int4", int4)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grouped_ablate needs the card (nvcc and CUDA)")
    fns = build(kernels.BUILD_DIR / "grouped_ablate")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"# {smi}; S=64 H=Hkv=32 L=256 block_l 256, step positions; ms a layer", flush=True)
    data = inputs()
    rows = {}
    saved = os.environ.get("TPUSERVE_ATTN_DYNSKIP")
    try:
        for skip in ("0", "1"):
            os.environ["TPUSERVE_ATTN_DYNSKIP"] = skip
            for name, fn in fns.items():
                with variant(fn):
                    for case, call in cases(*data):
                        rows[f"{name} dynskip={skip} {case}"] = ms = graph_ms(call)
                        print(f"{name:11s} dynskip={skip} {case:12s} {ms:.4f}", flush=True)
    finally:
        if saved is None:
            os.environ.pop("TPUSERVE_ATTN_DYNSKIP", None)
        else:
            os.environ["TPUSERVE_ATTN_DYNSKIP"] = saved
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "grouped_ablate.json"), "w") as fh:
        json.dump({"device": smi, "ms_a_layer": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
