#!/usr/bin/env python3
"""Chip smoke run of tpuserve_torch on one NVIDIA card (H100).

Phases, each fatal on failure:
  1. device   name, count, `nvidia-smi` name and power limit;
  2. build    every CUDA kernel from tpuserve_torch/csrc with nvcc (sm_90a);
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, with its time, the plain version's, a library
              yardstick's and the card's bound (the vector add in each of
              its seven dtypes beside torch.add); the paged decode attention
              also against the flat kernel on the same KV in shuffled pages;
              the multi-candidate (speculative verify) decode attention
              also against the flat kernel at positions + c, and timed
              against C flat calls;
  4. slice    a Llama-2-7B-width int4 model (random weights from a seed, 32
              layers, int4 g128, packed int4 KV, 64 slots, L=256) loaded
              through InferenceManager(device="cuda"), serving concurrent
              requests through the backend's generate; launch counters must
              show the kernels on that path; one full-width decode step
              through the kernels and through the plain versions must agree;
  4b. w4a8   the slice's configuration with activations int8 (random bf16
              weights from a seed, quantized at load: W4A8 on the int8
              wgmma kernel); 4c. odd, the same with int4 groups of 688
              (w_down's groups, which a 64-row stage cannot tile; the
              weights of K 4096 then have one group each); 4d. g344, groups
              of 344 (w_down's, in masked k16 steps), and 4e. w4a8-g344,
              the same with activations int8 (masked k32 steps): 4
              concurrent greedy requests of 16 new tokens each, every route
              counter exact, one full-width decode step against the plain
              versions (greedy tokens equal where the top two logits are
              apart), one profiled step with the quant-matmul's share of
              device time;
  4f. mixtral  a Mixtral-8x7B-width MoE model (32 layers, dim 4096, 32/8
              heads, 8 experts of ffn 14336, top-2; init random_quantized:
              int4 g128 expert stacks drawn on the card, a bf16 router)
              with the slice's serving settings: 8 concurrent greedy
              requests of 24 new tokens, (2 + 2E) x 32 + 1 = 577
              quant-matmuls a call and 32 flat decode attentions (GQA rep
              4: 8 query heads a packed int4 block) a decode step, exactly,
              and no plain version; one full-width decode step with every
              slot live (dispatch at cap 32) and the same step under
              TPUSERVE_MOE_DECODE_DISPATCH_T=128 (the dense loop), kernels
              against plain versions within 5% of the logit range, the
              plain path handed the kernel path's experts; host-clock step
              time and one profiled step each;
  5. paged    the same model with paged int8 KV (page_size 128, prefix
              sharing, prefill_chunk 128), loaded after the first is shut
              down: concurrent requests, two of them sharing a 128-token
              prefix with an earlier one; prefix hits, the pages returned,
              the launch counts, shared vs unshared first-token logits and
              one full-width paged decode step, kernels vs plain versions;
  6. spec     the JAX package's 7B speculation setting (int8 KV, 8 slots
              of 512, 8 drafts, 4 fused rounds): 8 concurrent greedy
              requests of a periodic prompt with speculation on, then off
              on the same engine; drafts, no disabled speculation, 32
              multi-kernel launches per verify round and no served request
              whose tokens on and off part on a clear step (top two logits
              of a prefill of the shared tokens apart) are required; one
              full-width verify_step against its plain versions and
              against C sequential decode steps (greedy tokens equal on
              every candidate whose top two logits are apart), no plain
              version in the profiled verify step;
  6b. spec-bf16  the same on the JAX package's default cache (kv_cache
              none, bf16): the multi kernel's float route;
  7. spec-paged  the paged setting with speculation: drafts, every page
              back, and no multi-kernel launch (the paged verify attends in
              plain torch);
  8. grouped  the slice's configuration served with
              TPUSERVE_DECODE_ATTN=grouped: 32 grouped-kernel launches per
              decode step (the Hopper kernel reading the packed int4 window
              in place) and no flat-kernel launch; one full-width decode
              step through the kernels against the plain versions, its
              logits under grouped, pallas and xla on copies of one cache
              (greedy tokens of grouped and pallas equal wherever the top
              two logits are apart), no plain unpack and no plain version
              in the timed and profiled steps, and the same requests
              served under pallas on the same engine, parting from
              grouped on no clear step;
  8b. grouped-bf16  the same on the default bf16 cache: the grouped
              kernel's bf16 route, 32 launches a decode step;
  9. sweep    the decode-attention diagnostic ladder
              (tpuserve_torch.scripts.sweep_attention) with every variant at
              its Llama-2-7B defaults: the probes' streaming rates, the
              grouped kernel's splits, decode_attention_wide and the einsum
              path;
 10. unpack   the int4 unpack microbenchmark
              (tpuserve_torch.scripts.unpack_microbench) at its defaults,
              then the unpack in place: the flat kernel (packed int4, the
              slice's step), the paged kernel (int4 pages) and the multi
              kernel (int4, S=8, C=9) under TPUSERVE_INT4_UNPACK=cur and
              =noop in turns, noop held against its own plain version;
 11. diag_bw  the HBM bandwidth probes (tpuserve_torch.scripts.diag_bw),
              every mode at its defaults, then the copy forms at smaller
              blocks;
 12. qmm_sweep  the quant-matmul sweep (tpuserve_torch.scripts.
              qmatmul_sweep) at its defaults: chained int4/int8 matmuls at
              the wrapper's split and at each block_k, and the
              dequantize-then-matmul control;
 13. moe_ab   the MoE decode FFN's dense loop against the dispatch
              (tpuserve_torch.scripts.ab_moe_decode) at Mixtral-8x7B's FFN,
              batch sizes 8 and 64, f32 h (the JAX script's) and bf16 h.
The kernel phase also holds the grouped kernel (packed int4, int8, bf16 at
g_kv 1, 16 // rep and Hkv, and f32; the packed route beside the parent's
unpack-then-int8 route),
decode_attention_wide, the three probes (dot_only on tensor cores), the
five unpack probes and the three copy forms against their plain
versions; the quant-matmul at B=64 (a decode step), B=72 (a verify step)
and W4A8 at B=64 with a per-step line each, two calls bitwise equal,
torch.matmul on the dequantized weights beside every case (W4A8 also
torch._int_mm), groups a 64-row stage cannot tile (int4 48, 80, 96, 112,
688; int8 96) on the wgmma kernel, bf16 groups of no multiple of 16 (int4
40, 24; int8 40) and W4A8 groups of no multiple of 32 (48, 20, 136, 12) in
masked steps, per-channel int4 at K 4096, each route's counter checked;
the masked steps' x layout (stage_x for bf16 x, the row quantization's
codes written in it for W4A8) bitwise against its plain gather; f32 x on
the wgmma kernel as three bf16 pieces (g128, odd g96, masked g40; the
split kernel bitwise its plain version) beside torch.matmul in f32, and
W8A8 (torch._int_mm on the codes) beside torch._int_mm, as records; the
multi-candidate kernel also on bf16 and f32 caches beside SDPA; the flat,
multi and grouped (int8 and packed int4) kernels under
TPUSERVE_ATTN_DYNSKIP=0 against =1; and the [mixtral] path's shapes: the
quant-matmul on the expert views of stacked int4 experts (gate|up K 4096
x N 28672, down K 14336 x N 4096, at 8, 16, 32 and 64 rows) and the flat
core at GQA rep 4 (packed int4: 8 query heads a block; int8: 4).
The slice phase also runs one full-width decode step under
TPUSERVE_QMATMUL=xla against the kernel step. Then a `kernels` JSON line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.

    python3 chip_smoke.py            # needs one card

Imports torch and tpuserve_torch only (no JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM published memory rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}  # dense, published
L2_FLUSH_BYTES = 200 * 2 ** 20     # rotate inputs past the 50 MB L2
OUT_DIR = "chiprun_out"
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Device time of one call: CUDA events around a CUDA graph that replays
    `reps` calls, so host launch gaps do not count."""

    def __init__(self, torch):
        self.torch = torch

    def ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn(0)
        side = torch.cuda.Stream()  # warm up off the capture stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(1)
        torch.cuda.current_stream().wait_stream(side)
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


# --------------------------------------------------------------------- phases
def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi: {e}")
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvidia-smi: {smi_line}")
    return name, count, smi_line


def phase_build():
    from tpuserve_torch import kernels

    info = kernels.build(force=True)
    log(f"[build] nvcc {kernels.ARCH}: {len(kernels.SOURCES)} sources in "
        f"{info.seconds:.1f} s -> {info.path}")
    for src, text in info.log.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {src}: {line.strip()}")
    kernels.lib()
    return info


def check_vector_add(torch, timer, reps):
    """vector_add at 1M elements of each dtype the JAX function adds,
    bitwise equal to torch's a + b, timed beside torch.add (the library's
    call, which is also the plain version) with inputs rotated past the
    L2. The kernels line keeps the float32 case."""
    from tpuserve_torch.device.smoke import DTYPES, vector_add, vector_add_plain

    n = 1_000_000
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def operand(dtype):
        if dtype.is_floating_point:
            return torch.randn(n, generator=g, device="cuda").to(dtype)
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, (n,), generator=g, device="cuda",
                             dtype=dtype)

    cases = []
    for dtype in DTYPES:
        esize = torch.empty(0, dtype=dtype).element_size()
        copies = max(1, math.ceil(L2_FLUSH_BYTES / (3 * esize * n)))
        ab = [(operand(dtype), operand(dtype)) for _ in range(copies)]
        out, ref = vector_add(*ab[0]), vector_add_plain(*ab[0])
        torch.cuda.synchronize()
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[esize]
        if not torch.equal(out.view(bits), ref.view(bits)):   # one add an element: bitwise
            fail(f"vector_add {dtype}: not bitwise equal to a + b")
        err = (out.double() - ref.double()).abs().max().item()
        ms = timer.ms(lambda i: vector_add(*ab[i % copies]), reps)
        lib_ms = timer.ms(lambda i: torch.add(*ab[i % copies]), reps)
        b_ms, b_by = bound(3 * esize * n, n, PEAK_OPS["f32"])
        name = str(dtype).replace("torch.", "")
        log(f"[kernel] vector_add n={n} {name}: bitwise equal to a + b; {ms:.4f} ms, torch.add "
            f"(the plain version) {lib_ms:.4f} ms ({ms / lib_ms:.3f}x), bound {b_ms:.4f} ms "
            f"({b_by}), {3 * esize * n / ms / 1e6:.1f} GB/s")
        cases.append(dict(dtype=name, max_abs_err=err, tol=0.0, ms=ms, plain_ms=lib_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        del ab
    f32 = cases[0]
    return dict(max_abs_err=f32["max_abs_err"], ms=f32["ms"], plain_ms=f32["plain_ms"],
                bound_ms=f32["bound_ms"], bound_by=f32["bound_by"], library_ms=f32["library_ms"],
                per="one call, 1M float32", cases=cases)


def _qt_random(torch, bits, k, n, gs=128, act_bits=0):
    from tpuserve_torch.quant.core import QTensor

    g = torch.Generator(device="cuda")
    g.manual_seed(k * 7 + n)
    if bits == 4:
        q = torch.randint(0, 256, (k // 2, n), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    else:
        q = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    scale = (torch.rand((k // gs, n), generator=g, device="cuda") + 0.5) * (0.02 / 7)
    return QTensor(q=q, scale=scale, bits=bits, group_size=gs, orig_shape=(k, n),
                   act_bits=act_bits)


def check_quant_matmul(torch, timer, reps, p):
    """Every weight shape of a 7B step against the plain version: int4 g128
    at B=64 (a decode step) and B=72 (a verify step, S*C = 8*9), int8
    weights and W4A8 at B=64, and groups a 64-row stage cannot tile (int4
    48, 80, 96, 112, 688; int8 96) on the wgmma kernel, with each call
    repeated for bitwise-equal outputs (split K adds in a fixed order);
    torch.matmul on the dequantized bf16 weights beside every case (W4A8:
    also torch._int_mm on the int8 x and codes, and the kernel alone);
    per-step totals of the kernel, its bound and torch.matmul at B=64 and 72
    and for W4A8; bf16 groups of no multiple of 16 (int4 40 and 24, int8
    40) and W4A8 groups of no multiple of 32 (48, 20, 136, 12) in masked
    steps on the Hopper kernels; per-channel int4 at the K-4096 shapes;
    every route's counter checked."""
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    from tpuserve_torch.quant.core import dequantize, quantize_activation, unpack_int4

    qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim
    shapes = {  # (K, N) -> launches per decode step
        "wqkv": ((p.dim, qd + 2 * kvd), p.n_layers),
        "wo": ((qd, p.dim), p.n_layers),
        "w_gateup": ((p.dim, 2 * p.ffn_dim), p.n_layers),
        "w_down": ((p.ffn_dim, p.dim), p.n_layers),
        "lm_head": ((p.dim, p.vocab_size), 1),
    }
    # (name, (K, N), launches per step, bits, act_bits, B, group size, step, route)
    cases = [(name, kn, per, 4, 0, 64, 128, "decode", "wgmma")
             for name, (kn, per) in shapes.items()]
    cases += [(name, kn, per, 4, 0, 72, 128, "verify", "wgmma")
              for name, (kn, per) in shapes.items()]
    cases += [(name, kn, 0, 8, 0, 64, 128, None, "wgmma") for name, (kn, per) in shapes.items()]
    cases += [(name, kn, per, 4, 8, 64, 128, "w4a8", "w4a8")
              for name, (kn, per) in shapes.items()]
    cases += [("wqkv", shapes["wqkv"][0], 0, 4, 0, 256, 128, None, "wgmma")]  # prefill batch
    # group sizes other than 128 (the kernel reads them at run time)
    cases += [("w_gateup", shapes["w_gateup"][0], 0, 4, 0, 64, 32, None, "wgmma"),
              ("wo", shapes["wo"][0], 0, 8, 0, 64, shapes["wo"][0][0], None, "wgmma")]
    # groups a 64-row stage cannot tile, on the wgmma kernel in stages cut
    # along the groups: K = 4032 = 42 * 96 = 36 * 112 (the nearest to dim
    # 4096 that 96, 48 and 112 divide), 4080 = 51 * 80; w_down in groups of
    # 688 = 11008 / 16 (the [odd] phase's configuration)
    odd = [("wo", (4032, p.dim), 0, 4, 0, 64, 96, None, "odd"),
           ("wo", (4032, p.dim), 0, 4, 0, 64, 48, None, "odd"),
           ("wo", (4080, p.dim), 0, 4, 0, 64, 80, None, "odd"),
           ("wo", (4032, p.dim), 0, 4, 0, 64, 112, None, "odd"),
           ("wo", (4032, p.dim), 0, 8, 0, 64, 96, None, "odd"),
           ("w_down", shapes["w_down"][0], 0, 4, 0, 64, 688, None, "odd")]
    # groups whose k-steps cross a group's end, in masked steps on the
    # Hopper kernels: bf16 x in groups of no multiple of 16 (int4 40 and 24,
    # int8 40), W4A8 in groups of no multiple of 32 (48, 20, 136, 12; K the
    # nearest to dim 4096 that the group divides)
    routed_cases = [("wo", (4000, p.dim), 0, 4, 0, 64, 40, None, "group_route"),
                    ("wo", (4032, p.dim), 0, 4, 8, 64, 48, None, "w4a8_route"),
                    ("wo", (4000, p.dim), 0, 4, 8, 64, 20, None, "w4a8_route"),
                    ("wo", (4080, p.dim), 0, 4, 8, 64, 136, None, "w4a8_route"),
                    ("wo", (4032, p.dim), 0, 4, 8, 64, 12, None, "w4a8_route"),
                    ("wo", (4032, p.dim), 0, 4, 0, 64, 24, None, "group_route"),
                    ("wo", (4000, p.dim), 0, 8, 0, 64, 40, None, "group_route")]
    # per-channel int4 with bf16 x (one group of K, in pieces of one group):
    # a record of the route, no counter of its own
    channel = [(name, shapes[name][0], 0, 4, 0, 64, shapes[name][0][0], None, "channel")
               for name in ("wqkv", "wo", "w_gateup")]
    cases += odd + routed_cases + channel
    counters = ("group_route_launches", "odd_group_launches", "w4a8_launches",
                "w4a8_route_launches")
    counts0 = {c: getattr(tqm, c) for c in counters}
    want = {"odd": "odd_group_launches", "w4a8": "w4a8_launches",
            "group_route": "group_route_launches", "w4a8_route": "w4a8_route_launches"}
    steps = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
                       int_mm_ms=0.0, kernel_ms=0.0)
             for key in ("decode", "verify", "w4a8")}
    worst, rows = 0.0, []
    for name, (k, n), per_step, bits, act_bits, b, gs, step_name, route in cases:
        qt = _qt_random(torch, bits, k, n, gs, act_bits)
        wbytes = qt.nbytes
        copies = max(1, math.ceil(L2_FLUSH_BYTES / wbytes))
        qts = [qt] + [_qt_random(torch, bits, k, n, gs, act_bits) for _ in range(copies - 1)]
        x = torch.randn((b, k), device="cuda").to(torch.bfloat16)
        before = {c: getattr(tqm, c) for c in counters}
        out, ref = quant_matmul(x, qt), quant_matmul_plain(x, qt)
        again = quant_matmul(x, qt)
        torch.cuda.synchronize()
        moved = {c for c in counters if getattr(tqm, c) != before[c]}
        if moved != ({want[route]} if route in want else set()):
            fail(f"quant_matmul {name} int{bits} act{act_bits} g{gs}: route counters {moved} "
                 f"moved, expected {want.get(route)}")
        err = (out.float() - ref.float()).abs().max().item()
        # both round an f32 sum of the same products to bf16 (W4A8: int32
        # group sums, then f32): one bf16 step at the largest output
        tol = 2 ** -7 * ref.float().abs().max().item()
        if not err <= tol:
            fail(f"quant_matmul {name} int{bits} act{act_bits} B={b} g{gs}: max|err| {err} > {tol}")
        if not torch.equal(out, again):
            fail(f"quant_matmul {name} int{bits} act{act_bits} B={b} g{gs}: two calls differ")
        worst = max(worst, err)
        ms = timer.ms(lambda i: quant_matmul(x, qts[i % copies]), reps)
        row = dict(name=name, K=k, N=n, B=b, bits=bits, act_bits=act_bits, group_size=gs,
                   route=route, max_abs_err=err, tol=tol, ms=ms, step=step_name)
        nbytes = b * k * 2 + wbytes + b * n * 2
        ops = 2.0 * b * k * n
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, ops, PEAK_OPS["int8" if act_bits == 8 else "bf16"])
        if step_name in ("decode", "w4a8") or route not in ("wgmma", "w4a8") or bits == 8:
            # the plain version at B=64 (and every int8-weight case)
            row["plain_ms"] = timer.ms(lambda i: quant_matmul_plain(x, qts[i % copies]),
                                       max(2, reps // 5))
        # the library yardstick: torch.matmul on the dequantized bf16 weights
        wd = [dequantize(t, torch.bfloat16) for t in qts[:max(1, math.ceil(
            L2_FLUSH_BYTES / (k * n * 2)))]]
        row["library_ms"] = timer.ms(lambda i: torch.matmul(x, wd[i % len(wd)]), reps)
        del wd
        if act_bits == 8:
            # the kernel alone on x quantized beforehand (the wrapper adds the
            # row quantization kernel), and torch._int_mm on the int8 x and
            # the codes: the int8 tensor cores' rate for the product without
            # the group scales
            xq, sx = quantize_activation(x)
            outb = torch.empty((b, n), dtype=torch.bfloat16, device="cuda")
            gsz = gs if gs < k else k
            # the codes as the kernel reads them (a masked group's laid out)
            xk = tqm.quantize_rows(x, tqm.stage_index(4, k, gsz, x.device)
                                   if tqm.masked_group(gsz, a8=True) else None)[0]
            row["kernel_ms"] = timer.ms(lambda i: tqm._launch_hopper(
                xk, qts[i % copies].q, qts[i % copies].scale, outb, qts[i % copies], gsz, None,
                sx), reps) if route in ("w4a8", "w4a8_route") else None
            codes_t = [unpack_int4(t.q, gsz).t().contiguous() for t in qts]
            row["int_mm_ms"] = timer.ms(lambda i: torch._int_mm(xq, codes_t[i % copies].t()),
                                        reps)
            del codes_t
        if step_name:
            step = steps[step_name]
            for key in ("ms", "plain_ms", "bound_ms", "library_ms", "int_mm_ms", "kernel_ms"):
                step[key] += per_step * (row.get(key) or 0.0)
            step["bytes"] += per_step * nbytes
            step["ops"] += per_step * ops
        rows.append(row)
        log(f"[kernel] quant_matmul {name} K={k} N={n} B={b} int{bits} g{gs}"
            f"{' W4A8' if act_bits else ''} ({route}): max|err| {err:.3g} (tol {tol:.3g}), two "
            f"calls equal; {ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
            + (f", plain {row['plain_ms']:.4f} ms" if "plain_ms" in row else "")
            + f", torch.matmul bf16 {row['library_ms']:.4f} ms"
            + (f", kernel alone {row['kernel_ms']:.4f} ms" if row.get("kernel_ms") else "")
            + (f", torch._int_mm {row['int_mm_ms']:.4f} ms" if "int_mm_ms" in row else ""))
        del qts, qt
        torch.cuda.empty_cache()
    for key, what in (("decode", "decode step (B=64), 129 calls int4 g128"),
                      ("verify", "verify step (B=72), 129 calls int4 g128"),
                      ("w4a8", "W4A8 decode step (B=64), 129 calls int4 g128 x int8")):
        step = steps[key]
        step["bound_ms"], step["bound_by"] = bound(
            step["bytes"], step["ops"], PEAK_OPS["int8" if key == "w4a8" else "bf16"])
        log(f"[kernel] quant_matmul per {what}: {step['ms']:.3f} ms, "
            f"bound {step['bound_ms']:.3f} ms ({step['bound_by']}), torch.matmul bf16 "
            f"{step['library_ms']:.3f} ms ({step['ms'] / step['library_ms']:.2f}x)"
            + (f", plain {step['plain_ms']:.3f} ms" if key != "verify" else "")
            + (f", torch._int_mm {step['int_mm_ms']:.3f} ms, the kernel alone (x quantized "
               f"beforehand) {step['kernel_ms']:.3f} ms" if key == "w4a8" else ""))
    dec, ver = steps["decode"], steps["verify"]
    log(f"[kernel] quant_matmul verify step / decode step: {ver['ms'] / dec['ms']:.3f}")
    routed = {c: getattr(tqm, c) - counts0[c] for c in counters}
    log(f"[kernel] quant_matmul route launches in this check: {routed}")
    odd_rows = [r for r in rows if r["route"] == "odd"]
    main_odd = odd_rows[0]                      # wo int4 g96

    def route_entry(route, per):                # the route's first case and its worst error
        rs = [r for r in rows if r["route"] == route]
        return dict(max_abs_err=max(r["max_abs_err"] for r in rs), ms=rs[0]["ms"],
                    plain_ms=rs[0]["plain_ms"], bound_ms=rs[0]["bound_ms"],
                    bound_by=rs[0]["bound_by"], library_ms=rs[0]["library_ms"],
                    int_mm_ms=rs[0].get("int_mm_ms"), kernel_ms=rs[0].get("kernel_ms"), per=per)

    w4 = steps["w4a8"]
    return dict(max_abs_err=worst, ms=dec["ms"], plain_ms=dec["plain_ms"],
                bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                library_ms=dec["library_ms"],
                per="one decode step: 129 launches, int4 g128, B=64 bf16",
                verify=dict(ms=ver["ms"], bound_ms=ver["bound_ms"], bound_by=ver["bound_by"],
                            library_ms=ver["library_ms"],
                            per="one verify step: 129 launches, int4 g128, B=72 bf16"),
                w4a8=dict(max_abs_err=max(r["max_abs_err"] for r in rows if r["route"] == "w4a8"),
                          ms=w4["ms"], plain_ms=w4["plain_ms"], bound_ms=w4["bound_ms"],
                          bound_by=w4["bound_by"], library_ms=w4["library_ms"],
                          int_mm_ms=w4["int_mm_ms"], kernel_ms=w4["kernel_ms"],
                          per="one W4A8 decode step: 129 launches, int4 g128 x int8, B=64"),
                odd=dict(max_abs_err=max(r["max_abs_err"] for r in odd_rows), ms=main_odd["ms"],
                         plain_ms=main_odd["plain_ms"], bound_ms=main_odd["bound_ms"],
                         bound_by=main_odd["bound_by"], library_ms=main_odd["library_ms"],
                         per="one call: wo K=4032 N=4096 int4 g96, B=64 bf16"),
                group_route=route_entry("group_route",
                                        "one call: wo K=4000 N=4096 int4 g40, B=64 bf16"),
                w4a8_route=route_entry("w4a8_route",
                                       "one call: wo K=4032 N=4096 int4 g48 x int8, B=64"),
                route_launches=routed, cases=rows)


def _qexperts_random(torch, e_n, k, n, gs=128):
    """A stack of e_n random int4 experts [e_n, K/2, N] with scales in
    [0.5, 1.5) * 0.02/7, drawn in place on the card."""
    from tpuserve_torch.quant.core import QExperts

    g = torch.Generator(device="cuda")
    g.manual_seed(k * 11 + n)
    q = torch.empty((e_n, k // 2, n), dtype=torch.uint8, device="cuda")
    q.random_(0, 256, generator=g)
    scale = (torch.rand((e_n, k // gs, n), generator=g, device="cuda") + 0.5) * (0.02 / 7)
    return QExperts(q=q, scale=scale, bits=4, group_size=gs, orig_shape=(e_n, k, n))


def check_quant_matmul_experts(torch, timer, reps, p):
    """The quant-matmul on the expert views of stacked int4 g128 experts at
    p's (Mixtral-8x7B's) widths: moe_gateup K=dim N=2*ffn and moe_down
    K=ffn N=dim, each expert a view at an offset e*K/2*N of the codes and
    e*groups*N*4 bytes of the scales (every view 16-byte aligned, as TMA
    reads it, and passed to the kernel without a copy), at the row counts
    the [mixtral] path gives it: 32 (a decode step's dispatch capacity at
    64 slots; also a 64-token prefill chunk's), 64 (the dense loop over 64
    slots), 8 and 16 (the capacities of prefills of 16 and 32 tokens).
    Each against the plain version within one bf16 step of the largest
    output and two calls bitwise equal, for the first, a middle and the
    last expert; timed rotating through all experts (the stack is past the
    L2) beside its bound and torch.matmul on the dequantized bf16 expert;
    per-step totals of a layer's experts times the layers, for the
    dispatch (B=32) and the dense loop (B=64)."""
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    from tpuserve_torch.quant.core import dequantize

    e_n = p.n_experts
    stacks = {"moe_gateup": _qexperts_random(torch, e_n, p.dim, 2 * p.ffn_dim),
              "moe_down": _qexperts_random(torch, e_n, p.ffn_dim, p.dim)}
    for name, st in stacks.items():
        for e in range(e_n):
            ex = st.expert(e)
            if ex.q.data_ptr() % 16 or ex.scale.data_ptr() % 16 or not ex.q.is_contiguous():
                fail(f"quant_matmul {name} expert {e}: view not 16-byte aligned and contiguous")
            if ex.q.data_ptr() != st.q.data_ptr() + e * ex.q.numel():
                fail(f"quant_matmul {name} expert {e}: not a view of the stack")
    steps = {b: dict(ms=0.0, bound_ms=0.0, library_ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)
             for b in (32, 64)}
    worst, rows = 0.0, []
    for name, st in stacks.items():
        k, n = st.orig_shape[1:]
        experts = [st.expert(e) for e in range(e_n)]
        wd = [dequantize(ex, torch.bfloat16) for ex in experts]
        for b in (32, 64, 8, 16):
            x = torch.randn((b, k), device="cuda").to(torch.bfloat16)
            err = 0.0
            for e in (0, e_n // 2, e_n - 1):
                before = tqm.launches
                out, ref = quant_matmul(x, experts[e]), quant_matmul_plain(x, experts[e])
                again = quant_matmul(x, experts[e])
                torch.cuda.synchronize()
                if tqm.launches != before + 2:
                    fail(f"quant_matmul {name} expert {e} B={b}: not two kernel launches")
                e_err = (out.float() - ref.float()).abs().max().item()
                tol = 2 ** -7 * ref.float().abs().max().item()
                if not e_err <= tol:
                    fail(f"quant_matmul {name} expert {e} B={b}: max|err| {e_err} > {tol}")
                if not torch.equal(out, again):
                    fail(f"quant_matmul {name} expert {e} B={b}: two calls differ")
                err = max(err, e_err)
            worst = max(worst, err)
            ms = timer.ms(lambda i: quant_matmul(x, experts[i % e_n]), reps)
            lib_ms = timer.ms(lambda i: torch.matmul(x, wd[i % e_n]), reps)
            plain_ms = timer.ms(lambda i: quant_matmul_plain(x, experts[i % e_n]),
                                max(2, reps // 5)) if b in steps else None
            wbytes = experts[0].nbytes
            nbytes = b * k * 2 + wbytes + b * n * 2
            ops = 2.0 * b * k * n
            b_ms, b_by = bound(nbytes, ops, PEAK_OPS["bf16"])
            row = dict(name=name, K=k, N=n, B=b, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            if b in steps:    # a step: every expert of every layer
                per = e_n * p.n_layers
                for key in ("ms", "bound_ms", "library_ms", "plain_ms"):
                    steps[b][key] += per * row[key]
                steps[b]["bytes"] += per * nbytes
                steps[b]["ops"] += per * ops
            log(f"[kernel] quant_matmul expert view {name} K={k} N={n} B={b} int4 g128: max|err| "
                f"{err:.3g} (tol {tol:.3g}), two calls equal, experts 0, {e_n // 2}, {e_n - 1}; "
                f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
                + (f", plain {plain_ms:.4f} ms" if plain_ms else "")
                + f", torch.matmul bf16 {lib_ms:.4f} ms ({ms / lib_ms:.2f}x)")
        del wd
    for b, what in ((32, "dispatch at cap 32"), (64, "dense loop over 64 slots")):
        st = steps[b]
        st["bound_ms"], st["bound_by"] = bound(st["bytes"], st["ops"], PEAK_OPS["bf16"])
        log(f"[kernel] quant_matmul experts per decode step, {what} ({2 * e_n * p.n_layers} "
            f"calls, B={b}): {st['ms']:.3f} ms, bound {st['bound_ms']:.3f} ms "
            f"({st['bound_by']}), torch.matmul bf16 {st['library_ms']:.3f} ms "
            f"({st['ms'] / st['library_ms']:.2f}x), plain {st['plain_ms']:.3f} ms")
    del stacks
    torch.cuda.empty_cache()
    d = steps[32]
    return dict(max_abs_err=worst, ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
                bound_by=d["bound_by"], library_ms=d["library_ms"],
                per=f"one decode step's experts at dispatch: {2 * e_n * p.n_layers} launches on "
                    f"expert views, int4 g128, B=32 bf16",
                dense=steps[64], cases=rows)


def check_quant_records(torch, timer, reps, p):
    """Records of two quant-matmul routes no phase of this script serves.
    f32 x on qmm_wgmma_kernel as three bf16 pieces (split_x, then the
    kernel with pieces 3) at wo's shape in int4 g128 (B=64), and at wo's
    width in an odd group (g96, K 4032) and a masked one (g40, K 4000):
    each against its plain version (within 1e-5 of the largest output),
    beside torch.matmul in f32 with TF32 off on the dequantized weights,
    the f32 and split counters checked and the split kernel bitwise its
    plain version; two bounds, the card's for the same exact work (three
    bf16 products a value, bf16 peak) and the figure of the same dot in
    f32 FMA at the f32 peak. W8A8 (int8 weights per channel, int8 x:
    quant/core.py::_w8a8_matmul, the row kernel and torch._int_mm where K
    and N are multiples of 8) at the five 7B shapes, the codes K-major as
    quantize_param_tree stores them, against torch._int_mm on the same
    codes, whose int32 sums scaled alike must give the same bits; beside
    it torch._int_mm on the codes row-major."""
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    from tpuserve_torch.quant import core as qcore
    from tpuserve_torch.quant.core import _w8a8_matmul, dequantize, quantize_activation

    b = 64
    wo_k = p.n_heads * p.head_dim
    f32_rows = []
    for k, gs, what in ((wo_k, 128, "g128"), (4032, 96, "g96, odd"), (4000, 40, "g40, masked")):
        n = p.dim
        qt = _qt_random(torch, 4, k, n, gs)
        copies = max(1, math.ceil(L2_FLUSH_BYTES / qt.nbytes))
        qts = [qt] + [_qt_random(torch, 4, k, n, gs) for _ in range(copies - 1)]
        x = torch.randn((b, k), device="cuda")
        counts = (tqm.f32_launches, tqm.split_launches, tqm.group_route_launches,
                  tqm.odd_group_launches)
        out, ref = quant_matmul(x, qt), quant_matmul_plain(x, qt)
        again = quant_matmul(x, qt)
        index = tqm.stage_index(4, k, gs, x.device) if tqm.masked_group(gs) else None
        pieces = tqm.split_x(x, index)
        torch.cuda.synchronize()
        if (tqm.f32_launches, tqm.split_launches, tqm.group_route_launches,
                tqm.odd_group_launches) != (counts[0] + 2, counts[1] + 3, counts[2], counts[3]):
            fail(f"quant_matmul f32 x {what}: the f32 route's counters did not move alone")
        plain_pieces = tqm.split_x_plain(x)
        if index is not None:
            plain_pieces = torch.stack([tqm._gather(t, index) for t in plain_pieces])
        if not torch.equal(pieces.view(torch.int16), plain_pieces.view(torch.int16)):
            fail(f"split_x {what}: not bitwise its plain version")
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        if not err <= tol:
            fail(f"quant_matmul f32 x {what}: max|err| {err} > {tol}")
        if not torch.equal(out, again):
            fail(f"quant_matmul f32 x {what}: two calls differ")
        wd = [dequantize(t, torch.float32) for t in qts[:max(1, math.ceil(L2_FLUSH_BYTES /
                                                                         (k * n * 4)))]]
        row = dict(name="wo", K=k, N=n, B=b, group_size=gs, route="f32 pieces", max_abs_err=err,
                   tol=tol, ms=timer.ms(lambda i: quant_matmul(x, qts[i % copies]), reps),
                   split_ms=timer.ms(lambda i: tqm.split_x(x, index), reps),
                   plain_ms=timer.ms(lambda i: quant_matmul_plain(x, qts[i % copies]),
                                     max(2, reps // 5)),
                   library_ms=timer.ms(lambda i: torch.matmul(x, wd[i % len(wd)]), reps))
        nbytes = b * k * 4 + qt.nbytes + b * n * 4
        row["bound_ms"], row["bound_by"] = bound(nbytes, tqm.PIECES * 2.0 * b * k * n,
                                                 PEAK_OPS["bf16"])
        row["bound_f32_fma_ms"] = bound(nbytes, 2.0 * b * k * n, PEAK_OPS["f32"])[0]
        f32_rows.append(row)
        log(f"[kernel] quant_matmul f32 x wo K={k} N={n} B={b} int4 {what} (qmm_wgmma_kernel, "
            f"three bf16 pieces): max|err| {err:.3g} (tol {tol:.3g}), two calls equal, split "
            f"bitwise its plain version; {row['ms']:.4f} ms (split_x alone "
            f"{row['split_ms']:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}; f32 "
            f"FMA {row['bound_f32_fma_ms']:.4f}), plain {row['plain_ms']:.4f} ms, torch.matmul "
            f"f32 (TF32 off) {row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.3f}x)")
        del qts, wd
        torch.cuda.empty_cache()
    f32 = dict(f32_rows[0], cases=f32_rows)

    qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim
    shapes = {"wqkv": ((p.dim, qd + 2 * kvd), p.n_layers), "wo": ((qd, p.dim), p.n_layers),
              "w_gateup": ((p.dim, 2 * p.ffn_dim), p.n_layers),
              "w_down": ((p.ffn_dim, p.dim), p.n_layers), "lm_head": ((p.dim, p.vocab_size), 1)}
    w8a8, step = [], dict(ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    paths0 = (qcore.w8a8_int_mm_calls, qcore.w8a8_float64_calls)
    for name, ((k, n), per) in shapes.items():
        # the codes K-major, as quantize_param_tree stores W8A8 weights
        qts = [dataclasses.replace(_qt_random(torch, 8, k, n, k, act_bits=8), group_size=0)
               for _ in range(max(1, math.ceil(L2_FLUSH_BYTES / (k * n))))]
        for t in qts:
            t.q = t.q.t().contiguous().t()
        qt, copies = qts[0], len(qts)
        x = torch.randn((b, k), device="cuda").to(torch.bfloat16)
        xq, sx = quantize_activation(x)
        out = _w8a8_matmul(x, qt)
        acc = torch._int_mm(xq, qt.q)
        ref = (acc.to(torch.float32) * sx * qt.scale[0][None, :]).to(x.dtype)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"W8A8 {name}: _w8a8_matmul differs from torch._int_mm's sums scaled alike")
        codes_row = [t.q.contiguous() for t in qts]
        row = dict(name=name, K=k, N=n, B=b,
                   ms=timer.ms(lambda i: _w8a8_matmul(x, qts[i % copies]), reps),
                   library_ms=timer.ms(lambda i: torch._int_mm(xq, qts[i % copies].q), reps),
                   int_mm_row_major_ms=timer.ms(
                       lambda i: torch._int_mm(xq, codes_row[i % copies]), reps))
        nbytes, ops = b * k * 2 + qt.nbytes + b * n * 2, 2.0 * b * k * n
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, PEAK_OPS["int8"])
        for key in ("ms", "library_ms"):
            step[key] += per * row[key]
        step["bytes"] += per * nbytes
        step["ops"] += per * ops
        w8a8.append(row)
        log(f"[kernel] W8A8 {name} K={k} N={n} B={b} (_w8a8_matmul on torch._int_mm): equal "
            f"to torch._int_mm's sums; {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), torch._int_mm {row['library_ms']:.4f} ms on the codes "
            f"K-major, {row['int_mm_row_major_ms']:.4f} row-major")
        del qts, codes_row
        torch.cuda.empty_cache()
    paths = (qcore.w8a8_int_mm_calls - paths0[0], qcore.w8a8_float64_calls - paths0[1])
    if paths[0] < 1:
        fail(f"W8A8: no call took torch._int_mm (int_mm, float64 calls: {paths})")
    step["bound_ms"], step["bound_by"] = bound(step["bytes"], step["ops"], PEAK_OPS["int8"])
    step["paths"] = dict(int_mm=paths[0], float64=paths[1])
    log(f"[kernel] W8A8 per decode step (B=64, 129 calls): {step['ms']:.3f} ms (the float64 "
        f"contraction before: 52.88 ms, PERF.md), bound {step['bound_ms']:.3f} ms, "
        f"torch._int_mm {step['library_ms']:.3f} ms; calls by path {step['paths']}")
    return dict(f32=f32, w8a8=w8a8, w8a8_step=step)


def check_quantize_rows(torch, timer, reps, p):
    """W4A8's row quantization kernel at the decode step's shapes (B=64;
    K = dim and ffn_dim, bf16 x; one row of zeros) against
    quantize_activation, its plain version: codes and scales bitwise equal;
    and at w_down's width in groups of 344 ([w4a8-g344]'s masked route),
    its codes written in the masked steps' layout, against the plain codes
    gathered alike. No single PyTorch call computes it (library: none)."""
    from tpuserve_torch.ops.quant_matmul import _gather, quantize_rows, stage_index
    from tpuserve_torch.quant.core import quantize_activation

    rows, main = [], None
    for k, gs in ((p.dim, 0), (p.ffn_dim, 0), (p.ffn_dim, 344)):
        b = 64
        index = stage_index(4, k, gs, "cuda") if gs else None
        w = k if index is None else index.numel()
        copies = max(1, math.ceil(L2_FLUSH_BYTES / (b * k * 3)))
        xs = [torch.randn((b, k), device="cuda").to(torch.bfloat16) for _ in range(copies)]
        xs[0][5] = 0

        def plain(x):
            q, sx = quantize_activation(x)
            return (q if index is None else _gather(q, index)), sx

        q, sx = quantize_rows(xs[0], index)
        ref_q, ref_s = plain(xs[0])
        torch.cuda.synchronize()
        if not (torch.equal(q, ref_q) and torch.equal(sx, ref_s)):
            fail(f"quantize_rows K={k} g{gs}: codes or scales differ from quantize_activation")
        ms = timer.ms(lambda i: quantize_rows(xs[i % copies], index), reps)
        plain_ms = timer.ms(lambda i: plain(xs[i % copies]), reps)
        b_ms, b_by = bound(b * k * 2 + b * w + b * 4 + (0 if index is None else w * 4),
                           3.0 * b * k, PEAK_OPS["f32"])
        row = dict(B=b, K=k, group_size=gs, max_abs_err=0.0, tol=0.0, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        main = main or row
        rows.append(row)
        log(f"[kernel] quantize_rows B={b} K={k} bf16" + (f", codes laid out for g{gs}" if gs
                                                          else "")
            + f": codes and scales bitwise equal to quantize_activation"
            + (" gathered alike" if gs else "") + f"; {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        del xs
    return dict(main, per=f"one call: B=64, K={p.dim}, bf16 x", cases=rows)


def check_stage_x(torch, timer, reps, p):
    """The masked steps' x gather (bf16 x laid out a stage at a time, so
    that every TMA box starts 16-byte aligned) at wo's width in groups of 40
    and w_down's in groups of 344 ([g344]'s masked route), B=64, against
    its plain version (pad, then index_select): bitwise equal. Library:
    torch.index_select on x padded beforehand."""
    from tpuserve_torch.ops.quant_matmul import _gather, stage_index, stage_x

    rows = []
    for name, k, gs in (("wo", 4000, 40), ("w_down", p.ffn_dim, 344)):
        b = 64
        index = stage_index(4, k, gs, "cuda")
        w = index.numel()
        copies = max(1, math.ceil(L2_FLUSH_BYTES / (b * (k + w) * 2)))
        xs = [torch.randn((b, k), device="cuda").to(torch.bfloat16) for _ in range(copies)]
        out, ref = stage_x(xs[0], index), _gather(xs[0], index)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int16), ref.view(torch.int16)):
            fail(f"stage_x {name} g{gs}: not bitwise equal to its plain gather")
        padded = [torch.nn.functional.pad(x, (0, 1)) for x in xs]
        il = index.long()
        row = dict(name=name, B=b, K=k, group_size=gs, W=w, max_abs_err=0.0, tol=0.0,
                   ms=timer.ms(lambda i: stage_x(xs[i % copies], index), reps),
                   plain_ms=timer.ms(lambda i: _gather(xs[i % copies], index), reps),
                   library_ms=timer.ms(lambda i: torch.index_select(padded[i % copies], 1, il),
                                       reps))
        row["bound_ms"], row["bound_by"] = bound(b * k * 2 + w * 4 + b * w * 2, 0.0,
                                                 PEAK_OPS["f32"])
        rows.append(row)
        log(f"[kernel] stage_x {name} K={k} g{gs} B={b} -> {w} values a row: bitwise equal to its "
            f"plain gather; {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, torch.index_select on x padded "
            f"beforehand {row['library_ms']:.4f} ms")
        del xs, padded
    return dict(rows[1], per="one call: w_down K=11008 g344, B=64 bf16 x", cases=rows)


def check_decode_attention(torch, timer, reps, p, tag="", full_step=False):
    """The flat core (decode_attention_wide_cache) at p's heads against its
    plain version, timed beside its bound and SDPA on the dequantized bf16
    window; S=64, L=256. The per-step line is the packed int4 case at
    random positions (full_step: at the full-width step's, all 64 slots
    live from 100 to 249)."""
    from tpuserve_torch.ops.decode_attention import (
        decode_attention_wide_cache, decode_attention_wide_cache_plain)

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    s, h, hkv, l, hd = 64, p.n_heads, p.n_kv_heads, 256, p.head_dim
    worst, rows, main = 0.0, [], None
    pos_main = torch.randint(0, l, (s,), generator=g, device="cuda", dtype=torch.int32)
    pos_main[::9] = -1            # inactive slots
    pos_main[1] = l - 1
    pos_step = step_positions(torch, g, s)
    # (kind, window, S, H, Hkv, L, at the full-width step's positions)
    cases = [("int4", None, s, h, hkv, l, False), ("int8", None, s, h, hkv, l, False),
             ("bf16", None, s, h, hkv, l, False), ("int8", 128, s, h, hkv, l, False),
             # the TPU's packed (2b) case: W = 256 makes win*W*sb < 1 MiB, so
             # one P requant covers the whole 256-row window
             ("int8", None, 16, 8, 2, l, False),
             ("int4", None, s, h, hkv, l, True)]
    if full_step:   # every slot live, as in the [mixtral] phase's step
        pos_step = torch.randint(100, 250, (s,), generator=g, device="cuda", dtype=torch.int32)
        cases = [c for c in cases if c[2] == s and c[0] != "bf16" and not c[1]]
    for kind, window, ss, hh, kk, lcache, at_step in cases:
        ww = kk * hd
        win = window or lcache
        if at_step:
            pos = pos_step
        elif ss == s:
            pos = pos_main.clamp(max=win - 1)
            pos[::9] = -1
        else:
            pos = torch.randint(0, win, (ss,), generator=g, device="cuda", dtype=torch.int32)
            pos[1], pos[2] = -1, win - 1
        live = (pos.clamp(min=-1) + 1).sum().item()  # KV rows the data needs
        elem = {"int4": 0.5, "int8": 1, "bf16": 2}[kind]
        kv_live = 2 * live * ww * elem + (2 * live * kk * 2 if kind != "bf16" else 0)
        # enough layers that the live rows read while rotating through them
        # exceed the L2: every timed call reads its KV from device memory
        n_layers = max(2, math.ceil(L2_FLUSH_BYTES / kv_live))
        shape = (n_layers, ss, lcache, ww // 2 if kind == "int4" else ww)
        if kind == "int4":
            kv = [torch.randint(0, 256, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.uint8) for _ in range(2)]
        elif kind == "int8":
            kv = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
        else:
            kv = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        sc = None
        if kind != "bf16":
            sc = [((torch.rand((n_layers, ss, kk, lcache), generator=g, device="cuda") + 0.5)
                   * 0.01).to(torch.bfloat16) for _ in range(2)]
        q = (torch.randn((ss, hh, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)

        def call(fn, i):
            li = i % n_layers
            ks, vs = (None, None) if sc is None else (sc[0][li], sc[1][li])
            return fn(q, kv[0], kv[1], ks, vs, pos, li, window=window)

        out = call(decode_attention_wide_cache, 1)
        ref = call(decode_attention_wide_cache_plain, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # same requant points and exact integer dots, but where exp() of a
        # score differs by an ulp between the kernel's expf and PyTorch's
        # exp, a P code can round the other way: one P step is pmax/127 of
        # one V row over the row sum, so allow 2e-3 of the output range
        tol = 2e-3 * ref.abs().max().item() + 1e-6
        if not err <= tol:
            fail(f"decode_attention {kind} S={ss} window={window}: max|err| {err} > {tol}")
        if not torch.all(out[pos < 0] == 0):
            fail(f"decode_attention {kind}: inactive slots are not zero")
        worst = max(worst, err)
        ms = timer.ms(lambda i: call(decode_attention_wide_cache, i), reps)
        plain_ms = timer.ms(lambda i: call(decode_attention_wide_cache_plain, i),
                            max(2, reps // 5))
        nbytes = kv_live + q.numel() * 2 + q.numel() * 4 + pos.numel() * 4
        ops = 2 * 2 * live * hh * hd
        b_ms, b_by = bound(nbytes, ops, PEAK_OPS["int8" if kind != "bf16" else "bf16"])
        lib_ms = sdpa_ms(torch, timer, reps, q, kv[0][0, :, :win], kv[1][0, :, :win],
                         None if sc is None else sc[0][0, :, :, :win],
                         None if sc is None else sc[1][0, :, :, :win], pos, kind)
        row = dict(kind=kind, S=ss, H=hh, Hkv=kk, L=lcache, window=window, live_rows=live,
                   step_positions=at_step, layers_rotated=n_layers, max_abs_err=err, tol=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if kind == "int4" and ss == s and at_step == full_step:
            main = row
        rows.append(row)
        log(f"[kernel] decode_attention{tag} {kind} S={ss} H={hh} Hkv={kk} L={lcache} "
            f"window={window}{' step positions' if at_step else ''}: max|err| {err:.3g} "
            f"(tol {tol:.3g}); {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, SDPA bf16 {lib_ms:.4f} ms; "
            f"{n_layers} layers rotated")
        del kv, sc
        torch.cuda.empty_cache()
    n_l = p.n_layers
    return dict(max_abs_err=worst, ms=n_l * main["ms"], plain_ms=n_l * main["plain_ms"],
                bound_ms=n_l * main["bound_ms"], bound_by=main["bound_by"],
                library_ms=n_l * main["library_ms"],
                per=f"one decode step: {n_l} launches, packed int4 KV, S=64, H={h}, Hkv={hkv}, "
                    f"L=256" + (", every slot live at 100-249" if full_step else ""), cases=rows)


def step_positions(torch, g, s):
    """Positions of the slices' full-width decode step: every slot live at
    100-249 but slot 7, so most slots read two 128-row blocks."""
    pos = torch.randint(100, 250, (s,), generator=g, device="cuda", dtype=torch.int32)
    pos[7] = -1
    return pos


def sdpa_ms(torch, timer, reps, q, kw, vw, ks, vs, pos, kind):
    """Library yardstick: SDPA over the dequantized bf16 window, masked by
    position, on copies that together exceed the L2. q is [S, H, hd], or
    [S, C, H, hd] for C candidates, candidate c masked past pos + c; kw/vw
    are one layer's window [S, win, Wst] of codes or values, ks/vs its
    scales [S, Hkv, win] or None."""
    import torch.nn.functional as F
    from tpuserve_torch.models.llama import unpack_kv_codes

    if q.dim() == 3:
        q = q[:, None]
    ss, cc, hh, hd = q.shape
    win = kw.shape[1]
    if kind == "int4":
        kw, vw = unpack_kv_codes(kw), unpack_kv_codes(vw)
    kk = kw.shape[-1] // hd
    kd = kw.reshape(ss, win, kk, hd).permute(0, 2, 1, 3).float()
    vd = vw.reshape(ss, win, kk, hd).permute(0, 2, 1, 3).float()
    if ks is not None:
        kd = kd * ks.float()[..., None]
        vd = vd * vs.float()[..., None]
    kd = kd.to(torch.bfloat16).repeat_interleave(hh // kk, dim=1).contiguous()
    vd = vd.to(torch.bfloat16).repeat_interleave(hh // kk, dim=1).contiguous()
    copies = max(1, math.ceil(L2_FLUSH_BYTES / (2 * kd.numel() * 2)))
    kvd = [(kd, vd)] + [(kd.clone(), vd.clone()) for _ in range(copies - 1)]
    horizon = pos[:, None] + torch.arange(cc, device="cuda")[None, :]        # [S, C]
    mask = (torch.arange(win, device="cuda")[None, None, :] <= horizon[:, :, None])[:, None]
    qs = q.permute(0, 2, 1, 3)                                                # [S, H, C, hd]
    ms = timer.ms(lambda i: F.scaled_dot_product_attention(
        qs, *kvd[i % copies], attn_mask=mask, scale=1.0), reps)
    del kvd, kd, vd
    return ms


def check_decode_attention_paged(torch, timer, reps, p):
    """The paged kernel at the paged slice's shapes (S=64, L=256 as two
    pages of 128, shuffled across the pool) against its plain version and
    against the flat kernel on the same KV laid out contiguously."""
    from tpuserve_torch.ops.decode_attention import (
        decode_attention_wide_cache, decode_attention_wide_paged,
        decode_attention_wide_paged_plain)
    from tpuserve_torch.serving.paged_kv import pad8

    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    s, h, hkv, hd, ps, l = 64, p.n_heads, p.n_kv_heads, p.head_dim, 128, 256
    n_cols, hp, w = l // ps, pad8(hkv), hkv * hd
    n_pages = s * n_cols + 1                       # page 0 is the reserved zero page
    table = (1 + torch.randperm(n_pages - 1, generator=g, device="cuda")).view(
        s, n_cols).to(torch.int32)
    pos_rand = torch.randint(0, l, (s,), generator=g, device="cuda", dtype=torch.int32)
    pos_rand[::9] = -1                                  # inactive slots
    pos_rand[1], pos_rand[2], pos_rand[3] = l - 1, ps - 1, ps  # last row, page edges
    pos_step = step_positions(torch, g, s)
    idx = table.long()
    worst, rows, main = 0.0, [], None
    for kind, at_step in (("int8", False), ("int4", False), ("bf16", False), ("int8", True)):
        pos = pos_step if at_step else pos_rand
        live = int((pos.clamp(min=-1) + 1).sum().item())      # KV rows the data needs
        pages_read = int(torch.div(pos + ps, ps, rounding_mode="floor").sum().item())
        elem = {"int4": 0.5, "int8": 1, "bf16": 2}[kind]
        kv_live = 2 * live * w * elem + (2 * live * hkv * 4 if kind != "bf16" else 0)
        n_layers = max(2, math.ceil(L2_FLUSH_BYTES / kv_live))
        shape = (n_layers, n_pages, ps, w // 2 if kind == "int4" else w)
        if kind == "int4":
            kv = [torch.randint(0, 256, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.uint8) for _ in range(2)]
        elif kind == "int8":
            kv = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
        else:
            kv = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        sc = [None, None]
        if kind != "bf16":
            sc = [(torch.rand((n_layers, n_pages, hp, ps), generator=g, device="cuda") + 0.5)
                  * 0.01 for _ in range(2)]
        q = (torch.randn((s, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
        # the same KV laid out contiguously, [n_layers, S, L + ps, Wst] with
        # scales [n_layers, S, Hkv, L + ps]: one junk page past the window
        # keeps the flat side on its L-blocked form at any width
        flat = [torch.cat([t[:, idx].reshape(n_layers, s, l, -1),
                           t[:, :1].expand(-1, s, -1, -1)], dim=2) for t in kv]
        flat_sc = [None if t is None else torch.cat(
            [t[:, idx].permute(0, 1, 3, 2, 4).reshape(n_layers, s, hp, l),
             t[:, idx[:, 0]]], dim=3)[:, :, :hkv].contiguous() for t in sc]

        def call(fn, i):
            return fn(q, kv[0], kv[1], sc[0], sc[1], table, pos, i % n_layers)

        def call_flat(i):
            li = i % n_layers
            ks, vs = (None, None) if sc[0] is None else (flat_sc[0][li], flat_sc[1][li])
            return decode_attention_wide_cache(q, flat[0], flat[1], ks, vs, pos, li, window=l,
                                               block_l=ps)

        out = call(decode_attention_wide_paged, 1)
        ref = call(decode_attention_wide_paged_plain, 1)
        out_flat = call_flat(1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # as the flat kernel's check: exact integer dots and the same requant
        # points; an ulp of exp() can tip one P code: 2e-3 of the range
        tol = 2e-3 * ref.abs().max().item() + 1e-6
        if not err <= tol:
            fail(f"decode_attention_paged {kind}: max|err| {err} > {tol}")
        # the flat kernel with block_l = ps runs the same blocks in the same
        # order over the same bytes: equal up to f32 rounding (expected 0)
        flat_err = (out - out_flat).abs().max().item()
        flat_tol = 1e-6
        if not flat_err <= flat_tol:
            fail(f"decode_attention_paged {kind}: differs from the flat kernel by {flat_err}")
        if not torch.all(out[pos < 0] == 0):
            fail(f"decode_attention_paged {kind}: inactive slots are not zero")
        worst = max(worst, err)
        ms = timer.ms(lambda i: call(decode_attention_wide_paged, i), reps)
        flat_ms = timer.ms(call_flat, reps)
        plain_ms = timer.ms(lambda i: call(decode_attention_wide_paged_plain, i),
                            max(2, reps // 5))
        nbytes = kv_live + pages_read * 4 + q.numel() * 2 + q.numel() * 4 + s * 4
        ops = 2 * 2 * live * h * hd
        b_ms, b_by = bound(nbytes, ops, PEAK_OPS["int8" if kind != "bf16" else "bf16"])
        ks0, vs0 = (None, None) if sc[0] is None else (flat_sc[0][0, :, :, :l],
                                                       flat_sc[1][0, :, :, :l])
        lib_ms = sdpa_ms(torch, timer, reps, q, flat[0][0, :, :l], flat[1][0, :, :l],
                         ks0, vs0, pos, kind)
        row = dict(kind=kind, S=s, H=h, Hkv=hkv, page_size=ps, L=l, live_rows=live,
                   pages_read=pages_read, step_positions=at_step, layers_rotated=n_layers,
                   max_abs_err=err, tol=tol, flat_err=flat_err, flat_tol=flat_tol, ms=ms,
                   flat_ms=flat_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        if kind == "int8" and not at_step:          # the paged slice's KV
            main = row
        rows.append(row)
        log(f"[kernel] decode_attention_paged {kind} S={s} H={h} Hkv={hkv} ps={ps} L={l}"
            f"{' step positions' if at_step else ''}: "
            f"max|err| {err:.3g} (tol {tol:.3g}), vs flat kernel {flat_err:.3g} (tol "
            f"{flat_tol}); {ms:.4f} ms, flat kernel on the same KV {flat_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, SDPA bf16 {lib_ms:.4f} ms; "
            f"{n_layers} layers rotated")
        del kv, sc, flat, flat_sc
        torch.cuda.empty_cache()
    n_l = p.n_layers
    return dict(max_abs_err=worst, ms=n_l * main["ms"], plain_ms=n_l * main["plain_ms"],
                bound_ms=n_l * main["bound_ms"], bound_by=main["bound_by"],
                library_ms=n_l * main["library_ms"], flat_ms=n_l * main["flat_ms"],
                per="one decode step: 32 launches, int8 pool, S=64, ps=128, L=256",
                cases=rows)


def check_decode_attention_multi(torch, timer, reps, p):
    """The multi-candidate (speculative verify) kernel at the [spec] phase's
    shapes (S=8 slots, C=9 candidates, L=512, Llama-2-7B heads, positions
    100-400; int8, packed int4, bf16 and f32 caches, each beside SDPA)
    against its plain version, and each candidate c against the flat kernel
    at positions + c on the same KV. The bf16 case is the [spec-bf16]
    phase's route (the float multi entry of the kernels line)."""
    from tpuserve_torch.ops.decode_attention import (
        decode_attention_wide_cache, decode_attention_wide_cache_multi,
        decode_attention_wide_cache_multi_plain)

    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    s, c, h, hkv, hd, l = 8, 9, p.n_heads, p.n_kv_heads, p.head_dim, 512
    w = hkv * hd
    pos = torch.randint(100, 401, (s,), generator=g, device="cuda", dtype=torch.int32)
    pos_c = [pos + j for j in range(c)]
    live = int((pos + c).sum().item())          # KV rows the kernel reads, once each
    cand_rows = sum(int((pc + 1).sum().item()) for pc in pos_c)  # rows each candidate sees
    rows, main, main_f = [], None, None
    for kind in ("int8", "int4", "bf16", "f32"):
        flt = kind in ("bf16", "f32")
        elem = {"int4": 0.5, "int8": 1, "bf16": 2, "f32": 4}[kind]
        kv_live = 2 * live * w * elem + (0 if flt else 2 * live * hkv * 4)   # f32 scales
        n_layers = max(2, math.ceil(L2_FLUSH_BYTES / kv_live))
        shape = (n_layers, s, l, w // 2 if kind == "int4" else w)
        if kind == "int4":
            kv = [torch.randint(0, 256, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.uint8) for _ in range(2)]
        elif kind == "int8":
            kv = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
        else:
            kv = [torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16 if kind == "bf16" else torch.float32) for _ in range(2)]
        sc = None
        if not flt:
            sc = [(torch.rand((n_layers, s, hkv, l), generator=g, device="cuda") + 0.5) * 0.01
                  for _ in range(2)]
        q = (torch.randn((s, c, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
        q_c = [q[:, j].contiguous() for j in range(c)]

        def scales(li):
            return (None, None) if sc is None else (sc[0][li], sc[1][li])

        def call(fn, i):
            li = i % n_layers
            return fn(q, kv[0], kv[1], *scales(li), pos, li, window=l)

        def call_flat(i):  # C flat-kernel calls, candidate j at positions + j
            li = i % n_layers
            return [decode_attention_wide_cache(q_c[j], kv[0], kv[1], *scales(li),
                                                pos_c[j], li, window=l) for j in range(c)]

        out = call(decode_attention_wide_cache_multi, 1)
        ref = call(decode_attention_wide_cache_multi_plain, 1)
        out_flat = torch.stack(call_flat(1), dim=1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # as the flat kernel's check: exact integer dots and the same requant
        # points; an ulp of exp() can tip one P code: 2e-3 of the range
        tol = 2e-3 * ref.abs().max().item() + 1e-6
        if not err <= tol:
            fail(f"decode_attention_multi {kind}: max|err| {err} > {tol}")
        # every cache: candidate j runs the flat kernel's blocks (the same
        # core) over the same bytes with the same arithmetic, and blocks past
        # its horizon add nothing: equal up to f32 rounding (expected 0)
        flat_err = (out - out_flat).abs().max().item()
        flat_tol = 1e-6 * out_flat.abs().max().item() + 1e-7
        if not flat_err <= flat_tol:
            fail(f"decode_attention_multi {kind}: differs from the flat kernel at "
                 f"positions + c by {flat_err} > {flat_tol}")
        # an inactive slot (positions -1): candidate 0 exactly 0
        pos_off = pos.clone()
        pos_off[1] = -1
        out_off = decode_attention_wide_cache_multi(q, kv[0], kv[1], *scales(1), pos_off, 1,
                                                    window=l)
        if not torch.all(out_off[1, 0] == 0):
            fail(f"decode_attention_multi {kind}: an inactive slot's candidate 0 is not zero")
        ms = timer.ms(lambda i: call(decode_attention_wide_cache_multi, i), reps)
        flat_ms = timer.ms(call_flat, reps)
        plain_ms = timer.ms(lambda i: call(decode_attention_wide_cache_multi_plain, i),
                            max(2, reps // 5))
        nbytes = kv_live + q.numel() * 2 + q.numel() * 4 + s * 4
        ops = 2 * 2 * cand_rows * h * hd
        b_ms, b_by = bound(nbytes, ops, PEAK_OPS[kind if flt else "int8"])
        lib_ms = sdpa_ms(torch, timer, reps, q, kv[0][0], kv[1][0], *scales(0), pos, kind)
        row = dict(kind=kind, S=s, C=c, H=h, Hkv=hkv, L=l, live_rows=live,
                   candidate_rows=cand_rows, layers_rotated=n_layers, max_abs_err=err, tol=tol,
                   flat_err=flat_err, flat_tol=flat_tol, ms=ms, flat_ms=flat_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        if kind == "int8":                      # the [spec] phase's KV
            main = row
        if kind == "bf16":                      # the [spec-bf16] phase's KV
            main_f = row
        rows.append(row)
        log(f"[kernel] decode_attention_multi {kind} S={s} C={c} H={h} Hkv={hkv} L={l}: "
            f"max|err| {err:.3g} (tol {tol:.3g}), vs flat kernel at pos + c {flat_err:.3g} "
            f"(tol {flat_tol:.3g}); {ms:.4f} ms, {c} flat-kernel calls {flat_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {live} live rows), plain {plain_ms:.4f} ms, SDPA bf16 with "
            f"the candidates' causal mask {lib_ms:.4f} ms; {n_layers} layers rotated")
        del kv, sc, q, q_c
        torch.cuda.empty_cache()
    # C = 1 against the flat kernel at the slice's decode step (S=64, L=256,
    # step positions): whether the multi kernel could serve plain decode too
    s1, l1 = 64, 256
    pos1 = step_positions(torch, g, s1)
    live1 = int((pos1.clamp(min=-1) + 1).sum().item())
    c1_rows = []
    for kind in ("int4", "int8"):
        elem = {"int4": 0.5, "int8": 1}[kind]
        n_layers = max(2, math.ceil(L2_FLUSH_BYTES / (2 * live1 * w * elem)))
        kv = [torch.randint(*((0, 256) if kind == "int4" else (-127, 128)),
                            (n_layers, s1, l1, w // 2 if kind == "int4" else w), generator=g,
                            device="cuda", dtype=torch.int32).to(
                                torch.uint8 if kind == "int4" else torch.int8) for _ in range(2)]
        sc = [((torch.rand((n_layers, s1, hkv, l1), generator=g, device="cuda") + 0.5)
               * 0.01).to(torch.bfloat16) for _ in range(2)]
        q1 = (torch.randn((s1, 1, h, hd), generator=g, device="cuda") / hd ** 0.5).to(
            torch.bfloat16)
        q1_flat = q1[:, 0].contiguous()

        def one(i):
            li = i % n_layers
            return decode_attention_wide_cache_multi(q1, kv[0], kv[1], sc[0][li], sc[1][li],
                                                     pos1, li)

        def flat1(i):
            li = i % n_layers
            return decode_attention_wide_cache(q1_flat, kv[0], kv[1], sc[0][li], sc[1][li],
                                               pos1, li)

        c1_err = (one(1)[:, 0] - flat1(1)).abs().max().item()
        if not c1_err <= 1e-6:   # the same blocks in the same order: expected 0
            fail(f"decode_attention_multi C=1 {kind}: differs from the flat kernel by {c1_err}")
        c1_rows.append(dict(kind=kind, S=s1, C=1, L=l1, step_positions=True, flat_err=c1_err,
                            ms=timer.ms(one, reps), flat_ms=timer.ms(flat1, reps)))
        log(f"[kernel] decode_attention_multi C=1 {kind} S={s1} L={l1} step positions: vs flat "
            f"kernel {c1_err:.3g}; {c1_rows[-1]['ms']:.4f} ms, flat kernel "
            f"{c1_rows[-1]['flat_ms']:.4f} ms; {n_layers} layers rotated")
        del kv, sc, q1, q1_flat
        torch.cuda.empty_cache()
    n_l = p.n_layers
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows if r["kind"] in ("int8", "int4")),
                ms=n_l * main["ms"], plain_ms=n_l * main["plain_ms"],
                bound_ms=n_l * main["bound_ms"], bound_by=main["bound_by"],
                library_ms=n_l * main["library_ms"], flat_ms=n_l * main["flat_ms"],
                per="one verify step: 32 launches, int8 KV, S=8, C=9, L=512",
                cases=rows + c1_rows,
                float=dict(max_abs_err=max(r["max_abs_err"] for r in rows
                                           if r["kind"] in ("bf16", "f32")),
                           ms=n_l * main_f["ms"], plain_ms=n_l * main_f["plain_ms"],
                           bound_ms=n_l * main_f["bound_ms"], bound_by=main_f["bound_by"],
                           library_ms=n_l * main_f["library_ms"],
                           flat_ms=n_l * main_f["flat_ms"],
                           per="one verify step: 32 launches, bf16 KV (kv_cache none), S=8, "
                               "C=9, L=512"))


def check_decode_attention_grouped(torch, timer, reps, p):
    """The grouped kernel at the [grouped] phase's shapes (S=64, L=256,
    Llama-2-7B heads, step positions) and at a rep-4 shape (H=32, Hkv=8):
    the packed int4 route (the [grouped] path: the Hopper kernel reads the
    packed window), int8, bf16 (the [grouped-bf16] path) and f32, with the
    default split (one kv head a block), bf16 also with the JAX package's
    16 // rep, and g_kv = Hkv, against their plain versions; the flat
    kernel on the same KV beside them, and for packed int4 the parent's
    route (the window unpacked by unpack_kv_codes, then the int8 kernel)."""
    from tpuserve_torch.ops.decode_attention import (
        decode_attention, decode_attention_packed, decode_attention_packed_plain,
        decode_attention_plain, decode_attention_wide_cache, unpack_kv_codes)

    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    s, l, hd = 64, 256, p.head_dim
    pos = step_positions(torch, g, s)
    live = int((pos.clamp(min=-1) + 1).sum().item())        # KV rows the data needs
    rows, main, main_f = [], None, None
    for kind, h, hkv in (("int4", p.n_heads, p.n_kv_heads), ("int8", p.n_heads, p.n_kv_heads),
                         ("bf16", p.n_heads, p.n_kv_heads), ("f32", p.n_heads, p.n_kv_heads),
                         ("int4", p.n_heads, 8), ("int8", p.n_heads, 8), ("bf16", p.n_heads, 8)):
        w = hkv * hd
        flt = kind in ("bf16", "f32")
        elem = {"int4": 0.5, "int8": 1, "bf16": 2, "f32": 4}[kind]
        # read-all (TPUSERVE_ATTN_DYNSKIP=0, the default here) reads every row;
        # the bound counts the live ones
        kv_live = 2 * live * w * elem + (0 if flt else 2 * live * hkv * 4)
        n_layers = max(2, math.ceil(L2_FLUSH_BYTES / (2 * s * l * w * elem)))
        shape = (n_layers, s, l, w // 2 if kind == "int4" else w)
        if kind == "int4":
            kv = [torch.randint(0, 256, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.uint8) for _ in range(2)]
        elif kind == "int8":
            kv = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(2)]
        else:
            kv = [torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16 if kind == "bf16" else torch.float32) for _ in range(2)]
        sc = [None, None]
        if not flt:     # f32 head-major, as the engine's cache
            sc = [(torch.rand((n_layers, s, hkv, l), generator=g, device="cuda") + 0.5) * 0.01
                  for _ in range(2)]
        q = (torch.randn((s, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
        g_kvs = {"bf16": (None, 16 // (h // hkv), hkv), "f32": (None,)}.get(kind, (None, hkv))
        for g_kv in g_kvs:
            def call(fn, i, g_kv=g_kv):
                li = i % n_layers
                if kind == "int4":     # the packed window and head-major scales, in place
                    return fn(q, kv[0][li], kv[1][li], sc[0][li], sc[1][li], pos, g_kv=g_kv)
                ks, vs = ((None, None) if sc[0] is None
                          else (sc[0][li].transpose(1, 2), sc[1][li].transpose(1, 2)))
                k4, v4 = (t[li].view(s, l, hkv, hd) for t in kv)
                return fn(q, k4, v4, ks, vs, pos, g_kv=g_kv)

            def flat(i):
                li = i % n_layers
                ks, vs = (None, None) if sc[0] is None else (sc[0][li], sc[1][li])
                return decode_attention_wide_cache(q, kv[0], kv[1], ks, vs, pos, li)

            def unpacked(i):       # the parent's route for a packed window
                li = i % n_layers
                k4, v4 = (unpack_kv_codes(t[li]).view(s, l, hkv, hd) for t in kv)
                return decode_attention(q, k4, v4, sc[0][li].transpose(1, 2),
                                        sc[1][li].transpose(1, 2), pos)

            kern = decode_attention_packed if kind == "int4" else decode_attention
            plain = decode_attention_packed_plain if kind == "int4" else decode_attention_plain
            out = call(kern, 1)
            ref = call(plain, 1)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            # the same arithmetic and exact integer (bf16: f32-exact) products;
            # an ulp of expf against torch.exp, or of the order of f32 sums,
            # can tip one P entry across a bf16 rounding boundary (2^-8 of
            # it): 1e-3 of the output range
            tol = 1e-3 * ref.abs().max().item() + 1e-7
            if not err <= tol:
                fail(f"decode_attention_grouped {kind} H={h} Hkv={hkv} g_kv={g_kv}: "
                     f"max|err| {err} > {tol}")
            if not torch.all(out[pos < 0] == 0):
                fail("decode_attention_grouped: inactive slots are not zero")
            ms = timer.ms(lambda i: call(kern, i), reps)
            flat_ms = timer.ms(flat, reps)
            unpack_ms = timer.ms(unpacked, reps) if kind == "int4" and g_kv is None else None
            plain_ms = timer.ms(lambda i: call(plain, i), max(2, reps // 5))
            nbytes = kv_live + q.numel() * 2 + q.numel() * 4 + s * 4
            ops = 2 * 2 * live * h * hd
            b_ms, b_by = bound(nbytes, ops, PEAK_OPS[kind if flt else "int8"])
            lib_ms = sdpa_ms(torch, timer, reps, q, kv[0][0], kv[1][0],
                             None if sc[0] is None else sc[0][0],
                             None if sc[0] is None else sc[1][0], pos, kind)
            row = dict(kind=kind, S=s, H=h, Hkv=hkv, L=l, g_kv=g_kv or 1, live_rows=live,
                       layers_rotated=n_layers, max_abs_err=err, tol=tol, ms=ms, flat_ms=flat_ms,
                       unpack_then_int8_ms=unpack_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            if hkv == p.n_kv_heads and g_kv is None and kind in ("int4", "bf16"):
                if kind == "int4":     # the [grouped] path
                    main = row
                else:                  # the [grouped-bf16] path
                    main_f = row
            rows.append(row)
            extra = "" if unpack_ms is None else f", unpack + int8 kernel {unpack_ms:.4f} ms"
            log(f"[kernel] decode_attention_grouped {kind} S={s} H={h} Hkv={hkv} L={l} "
                f"g_kv={g_kv or 1} step positions: max|err| {err:.3g} (tol {tol:.3g}); "
                f"{ms:.4f} ms, flat kernel on the same KV {flat_ms:.4f} ms{extra}, bound "
                f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, SDPA bf16 {lib_ms:.4f} ms; "
                f"{n_layers} layers rotated")
        del kv, sc, q
        torch.cuda.empty_cache()
    n_l = p.n_layers
    worst = lambda kinds: max(r["max_abs_err"] for r in rows if r["kind"] in kinds)
    return dict(max_abs_err=worst(("int4", "int8")), ms=n_l * main["ms"],
                plain_ms=n_l * main["plain_ms"],
                bound_ms=n_l * main["bound_ms"], bound_by=main["bound_by"],
                library_ms=n_l * main["library_ms"], flat_ms=n_l * main["flat_ms"],
                unpack_then_int8_ms=n_l * main["unpack_then_int8_ms"],
                per="one decode step: 32 launches, packed int4 window read in place, S=64, "
                    "L=256, TPUSERVE_ATTN_DYNSKIP=0", cases=rows,
                float=dict(max_abs_err=worst(("bf16", "f32")), ms=n_l * main_f["ms"],
                           plain_ms=n_l * main_f["plain_ms"], bound_ms=n_l * main_f["bound_ms"],
                           bound_by=main_f["bound_by"], library_ms=n_l * main_f["library_ms"],
                           flat_ms=n_l * main_f["flat_ms"],
                           per="one decode step: 32 launches, bf16 window (kv_cache none), S=64, "
                               "L=256, g_kv 1, TPUSERVE_ATTN_DYNSKIP=0"))


def check_dynskip(torch, timer, reps, p):
    """TPUSERVE_ATTN_DYNSKIP=0 against =1 on the flat (packed int4 KV, the
    slice's step positions), multi-candidate (int8, the spec phase's S=8,
    C=9, L=512) and grouped (int8 window, and the packed int4 window of the
    grouped phase, at its shapes) kernels: "0" reads and masks the blocks
    past a slot's position, "1" skips them; the outputs must agree (masked
    rows add exact zeros) and both are timed, the KV rotated past the L2."""
    from tpuserve_torch.ops.decode_attention import (decode_attention,
                                                     decode_attention_packed,
                                                     decode_attention_wide_cache,
                                                     decode_attention_wide_cache_multi)

    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    h, hkv, hd = p.n_heads, p.n_kv_heads, p.head_dim
    w = hkv * hd

    def layers(nbytes):
        return max(2, math.ceil(L2_FLUSH_BYTES / nbytes))

    def codes(shape, int4):
        lo, hi = (0, 256) if int4 else (-127, 128)
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32).to(
            torch.uint8 if int4 else torch.int8)

    s, l = 64, 256
    pos = step_positions(torch, g, s)
    nl = layers(2 * s * l * w // 2)
    kv4 = [codes((nl, s, l, w // 2), True) for _ in range(2)]
    sc4 = [((torch.rand((nl, s, hkv, l), generator=g, device="cuda") + 0.5) * 0.01)
           .to(torch.bfloat16) for _ in range(2)]
    q = (torch.randn((s, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)

    def flat(i):
        li = i % nl
        return decode_attention_wide_cache(q, kv4[0], kv4[1], sc4[0][li], sc4[1][li], pos, li)

    sm, cm, lm = 8, 9, 512
    posm = torch.randint(100, 401, (sm,), generator=g, device="cuda", dtype=torch.int32)
    nlm = layers(2 * sm * lm * w)
    kvm = [codes((nlm, sm, lm, w), False) for _ in range(2)]
    scm = [(torch.rand((nlm, sm, hkv, lm), generator=g, device="cuda") + 0.5) * 0.01
           for _ in range(2)]
    qm = (torch.randn((sm, cm, h, hd), generator=g, device="cuda") / hd ** 0.5).to(
        torch.bfloat16)

    def multi(i):
        li = i % nlm
        return decode_attention_wide_cache_multi(qm, kvm[0], kvm[1], scm[0][li], scm[1][li],
                                                 posm, li)

    nlg = layers(2 * s * l * w)
    kvg = [codes((nlg, s, l, w), False) for _ in range(2)]
    scg = [(torch.rand((nlg, s, hkv, l), generator=g, device="cuda") + 0.5) * 0.01
           for _ in range(2)]

    def grouped(i):
        li = i % nlg
        k4, v4 = (t[li].view(s, l, hkv, hd) for t in kvg)
        return decode_attention(q, k4, v4, scg[0][li].transpose(1, 2),
                                scg[1][li].transpose(1, 2), pos, block_l=l)

    def grouped4(i):
        li = i % nl
        return decode_attention_packed(q, kv4[0][li], kv4[1][li], sc4[0][li], sc4[1][li], pos,
                                       block_l=l)

    rows = []
    for name, fn in (("flat int4 S=64 L=256", flat), ("multi int8 S=8 C=9 L=512", multi),
                     ("grouped int8 S=64 L=256", grouped),
                     ("grouped packed int4 S=64 L=256", grouped4)):
        outs, times = {}, {}
        for mode in ("1", "0", "0", "1"):    # in turns
            with env_set("TPUSERVE_ATTN_DYNSKIP", mode):
                outs[mode] = fn(1)
                times.setdefault(mode, []).append(timer.ms(fn, reps))
        torch.cuda.synchronize()
        live = outs["1"] if "multi" not in name else outs["1"][:, 0]
        err = (outs["0"] - outs["1"]).abs().max().item()
        # the same arithmetic: masked rows add exact zeros
        tol = 1e-6 * live.abs().max().item()
        if not err <= tol:
            fail(f"dynskip {name}: outputs under 0 and 1 differ by {err} > {tol}")
        row = dict(kernel=name, max_abs_diff=err, tol=tol, ms_skip=min(times["1"]),
                   ms_read=min(times["0"]), times=times)
        rows.append(row)
        log(f"[kernel] dynskip {name}: max|0 - 1| {err:.3g} (tol {tol:.3g}); "
            f"DYNSKIP=1 {row['ms_skip']:.4f} ms, DYNSKIP=0 {row['ms_read']:.4f} ms "
            f"({row['ms_read'] / row['ms_skip']:.2f}x), turns 1,0,0,1")
    del kv4, kvm, kvg
    torch.cuda.empty_cache()
    return rows


def sweep_inputs(torch, copies=2):
    """`copies` sets of the sweep's inputs at its defaults (S=64, L=256,
    Hkv=32, rep 1; every slot at L-1): K and V 64 MB each per set."""
    from tpuserve_torch.scripts import sweep_attention as sweep

    dims = sweep.shapes()
    return dims, [sweep.setup(dims, torch.device("cuda"), seed=i) for i in range(copies)]


def check_decode_attention_wide(torch, timer, reps):
    """decode_attention_wide (the prebuilt-Q_wide entry, the flat kernel on
    a one-layer view) at the sweep's shape, block_l 256 and 128, against
    its plain version."""
    from tpuserve_torch.ops.decode_attention import (decode_attention_wide,
                                                     decode_attention_wide_plain)

    dims, sets = sweep_inputs(torch)
    q, k, v, ks, vs, pos = sets[0]
    s, l, hkv, hd = k.shape
    live = int((pos + 1).sum().item())
    rows, main, worst = [], None, 0.0
    for block_l in (256, 128):
        out = decode_attention_wide(q, k, v, ks, vs, pos, block_l=block_l)
        ref = decode_attention_wide_plain(q, k, v, ks, vs, pos, block_l=block_l)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 2e-3 * ref.abs().max().item() + 1e-6    # the flat kernel's (a P code may tip)
        if not err <= tol:
            fail(f"decode_attention_wide block_l={block_l}: max|err| {err} > {tol}")
        worst = max(worst, err)
        ms = timer.ms(lambda i: decode_attention_wide(*sets[i % 2], block_l=block_l), reps)
        plain_ms = timer.ms(lambda i: decode_attention_wide_plain(*sets[i % 2], block_l=block_l),
                            max(2, reps // 5))
        nbytes = 2 * live * hkv * hd + 2 * live * hkv * 4 + q.numel() * 2 + q.numel() * 4 + s * 4
        b_ms, b_by = bound(nbytes, 2 * 2 * live * q.shape[1] * hd, PEAK_OPS["int8"])
        lib_ms = sdpa_ms(torch, timer, reps, q, k.view(s, l, -1), v.view(s, l, -1), ks, vs, pos,
                         "int8")
        row = dict(S=s, L=l, Hkv=hkv, H=q.shape[1], block_l=block_l, live_rows=live,
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by)
        main = main or row
        rows.append(row)
        log(f"[kernel] decode_attention_wide int8 S={s} H={q.shape[1]} Hkv={hkv} L={l} "
            f"block_l={block_l}: max|err| {err:.3g} (tol {tol:.3g}); {ms:.4f} ms "
            f"({nbytes / ms / 1e6:.1f} GB/s), bound {b_ms:.4f} ms ({b_by}), plain "
            f"{plain_ms:.4f} ms, SDPA bf16 {lib_ms:.4f} ms")
    del sets
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"],
                per="one call at the sweep's shape: int8, S=64, L=256, Hkv=32, block_l 256",
                cases=rows)


def check_probes(torch, timer, reps):
    """The three probes at the sweep's shape against their plain versions,
    with the rate each streams K and V at, as a share of 3.35 TB/s."""
    from tpuserve_torch.ops import attention_probes as probes

    dims, sets = sweep_inputs(torch)
    k0, v0 = sets[0][1], sets[0][2]
    kv_bytes = k0.numel() + v0.numel()
    qis = [probes.probe_q(st[0]) for st in sets]
    results = {}
    cases = {
        "probe_dma_bound": (lambda i: probes.dma_bound(*sets[i % 2][1:3]),
                            lambda i: probes.colsum_plain(*sets[i % 2][1:3]), 0),
        "probe_dma_wide": (lambda i: probes.dma_wide(*sets[i % 2][1:3]),
                           lambda i: probes.colsum_plain(*sets[i % 2][1:3]), 0),
        "probe_dma_wide3d": (lambda i: probes.dma_wide(*sets[i % 2][1:3], three_d=True),
                             lambda i: probes.colsum_plain(*sets[i % 2][1:3]), 0),
        "probe_dot_only": (lambda i: probes.dot_only(qis[i % 2], *sets[i % 2][1:3]),
                           lambda i: probes.dot_only_plain(qis[i % 2], *sets[i % 2][1:3]),
                           4 * qis[0].shape[0] * qis[0].shape[1] * k0.shape[1] * k0.shape[2]
                           * k0.shape[3]),
    }
    for name, (fn, plain, ops) in cases.items():
        out, ref = fn(0), plain(0)
        torch.cuda.synchronize()
        if out.dtype == torch.int32:
            err, tol = float((out - ref).abs().max().item()), 0.0   # integer sums: exact
        else:
            err = (out - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()      # f32 atomics in any order
        if not err <= tol:
            fail(f"{name}: max|err| {err} > {tol}")
        ms = timer.ms(fn, reps)
        plain_ms = timer.ms(plain, max(2, reps // 5))
        nbytes = kv_bytes + (qis[0].numel() + 4 * qis[0].numel() if ops else 4 * 128)
        b_ms, b_by = bound(nbytes, ops, PEAK_OPS["int8"])
        rate = kv_bytes / ms / 1e6             # GB/s: bytes over ms
        # the column sums' plain version is one torch.sum per tensor, the
        # library's call for the function; dot_only has none
        lib_ms = None if ops else plain_ms
        results[name] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms, gb_s=rate,
                             hbm_share=rate * 1e9 / HBM_BYTES_PER_S,
                             per="one call at the sweep's shape: K and V int8 [64, 256, 32, 128]")
        log(f"[kernel] {name}: max|err| {err:.3g} (tol {tol:.3g}); {ms:.4f} ms, "
            f"{rate:.1f} GB/s of K and V ({100 * rate * 1e9 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s), "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms")
    del sets, qis
    torch.cuda.empty_cache()
    return results


def check_unpack_probes(torch, timer, reps):
    """The five unpack-microbenchmark kernels at the script's defaults (x
    int8 [262144, 2048], 537 MB, past the L2; q int8 [32, 2048]; blocks of
    256 rows) against their plain versions, exactly (integer sums)."""
    from tpuserve_torch.ops import unpack_probes as up
    from tpuserve_torch.scripts import unpack_microbench as ub

    d = ub.dims()
    x, q = ub.setup(d, torch.device("cuda"))
    n, w2, m, blr = d["N_ROWS"], d["W2"], d["M"], d["BLR"]
    results = {}
    for name in up.VARIANTS:
        fn = up.PROBES[name]
        out = fn(x, q, 3, blr)
        ref = up.unpack_probe_plain(name, x, q, 3, blr)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max().item())
        if err != 0:                             # integer sums: exact
            fail(f"unpack probe {name}: max|err| {err} > 0")
        ms = timer.ms(lambda i: fn(x, q, i, blr), reps)
        plain_ms = timer.ms(lambda i: up.unpack_probe_plain(name, x, q, i, blr), 2)
        dots = {"stream_raw": 0, "dot_raw": 1}.get(name, 2)
        ops = 2 * m * n * w2 * dots if dots else n * w2
        b_ms, b_by = bound(n * w2 + (m * w2 if dots else 0) + m * 128 * 8, ops,
                           PEAK_OPS["int8"])
        lib_ms = None
        if name == "stream_raw":
            lib_ms = timer.ms(lambda i: x.sum(dtype=torch.int32), reps)
        elif name == "dot_raw":       # cuBLASLt's int8 product: the scores before the fold
            lib_ms = timer.ms(lambda i: torch._int_mm(q, x.t()), reps)
        rate = n * w2 / ms / 1e6
        results[_unpack_unit(name)] = dict(
            max_abs_err=err, tol=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, gb_s=rate,
            per="one pass at the microbenchmark's defaults: x int8 [262144, 2048], q [32, 2048]")
        log(f"[kernel] unpack probe {name}: max|err| {err:.3g} (tol 0); {ms:.4f} ms, {rate:.1f} "
            f"GB/s ({100 * rate * 1e9 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s), bound {b_ms:.4f} "
            f"ms ({b_by}), plain {plain_ms:.4f} ms"
            + ("" if lib_ms is None else f", library {lib_ms:.4f} ms"))
    del x, q
    torch.cuda.empty_cache()
    return results


def check_diag_copy(torch, timer, reps):
    """diag_bw's copy kernel in its three forms at the script's defaults (K
    and V int8 [64, 256, 32, 128], g 16, block_l 256, every slot at L-1),
    two sets of inputs rotated past the L2, against the plain versions,
    exactly; the library's torch.sum over the views beside them; the card's
    grid of CTAs and the TPU's grid it cuts."""
    from tpuserve_torch.ops import attention_probes as probes
    from tpuserve_torch.scripts import diag_bw

    d = dict(S=64, L=256, N_KV=32, HD=128, G=16, BLOCK_L=256)
    sets = [diag_bw.setup(d, torch.device("cuda"), seed=i) for i in range(2)]
    kv_bytes = 2 * sets[0][0].numel()
    rows, main = [], None
    hd = d["HD"]
    lib_ms = timer.ms(lambda i: (sets[i % 2][0].view(-1, hd).sum(0, dtype=torch.int32)
                                 + sets[i % 2][1].view(-1, hd).sum(0, dtype=torch.int32)), reps)
    for mode in probes.COPY_MODES:
        def call(fn, i, mode=mode):
            k, v, pos = sets[i % 2]
            return fn(k, v, mode, d["BLOCK_L"], d["G"], pos if mode == "pdyn" else None)

        out, ref = call(probes.diag_copy, 0), call(probes.diag_copy_plain, 0)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max().item())
        if err != 0:                             # integer sums: exact
            fail(f"diag_copy {mode}: max|err| {err} > 0")
        ms = timer.ms(lambda i: call(probes.diag_copy, i), reps)
        plain_ms = timer.ms(lambda i: call(probes.diag_copy_plain, i), max(2, reps // 5))
        b_ms, b_by = bound(kv_bytes + d["S"] * 4 + d["HD"] * 4, kv_bytes, PEAK_OPS["int8"])
        shape = sets[0][0].shape
        rpc, cpb, grid = probes.diag_copy_plan(shape, mode, d["BLOCK_L"], d["G"],
                                               torch.cuda.get_device_properties(0)
                                               .multi_processor_count)
        tpu_grid = probes.diag_copy_tpu_grid(shape, mode, d["BLOCK_L"], d["G"])
        rate = kv_bytes / ms / 1e6
        row = dict(mode=mode, grid=grid, tpu_grid=tpu_grid, rows_a_cta=rpc, ctas_a_block=cpb,
                   max_abs_err=err, tol=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=b_ms, bound_by=b_by, gb_s=rate)
        rows.append(row)
        if mode == "pcopy4d":    # the attention's per-head-group access pattern
            main = row
        log(f"[kernel] diag_copy {mode} CTAs {grid} ({cpb} of {rpc} rows a TPU block of the TPU's "
            f"grid {tpu_grid}): max|err| {err:.3g} (tol 0); {ms:.4f} ms, "
            f"{rate:.1f} GB/s of K and V ({100 * rate * 1e9 / HBM_BYTES_PER_S:.1f}% of 3.35 "
            f"TB/s), bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, torch.sum over the "
            f"views {lib_ms:.4f} ms")
    del sets
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=lib_ms,
                per="one call at diag_bw's defaults: pcopy4d, K and V int8 [64, 256, 32, 128], "
                    "g 16, block_l 256", cases=rows)


def phase_kernels(torch, timer, reps, p, p_moe):
    results = {"vector_add": check_vector_add(torch, timer, reps)}
    results["quant_matmul"] = check_quant_matmul(torch, timer, reps, p)
    results["quant_matmul_experts"] = check_quant_matmul_experts(torch, timer, reps, p_moe)
    results["quant_records"] = check_quant_records(torch, timer, reps, p)
    results["quantize_rows"] = check_quantize_rows(torch, timer, reps, p)
    results["stage_x"] = check_stage_x(torch, timer, reps, p)
    results["decode_attention"] = check_decode_attention(torch, timer, reps, p)
    results["decode_attention_gqa"] = check_decode_attention(torch, timer, reps, p_moe,
                                                             tag=" (GQA)", full_step=True)
    results["decode_attention_paged"] = check_decode_attention_paged(torch, timer, reps, p)
    results["decode_attention_multi"] = check_decode_attention_multi(torch, timer, reps, p)
    results["decode_attention_grouped"] = check_decode_attention_grouped(torch, timer, reps, p)
    results["dynskip"] = check_dynskip(torch, timer, reps, p)
    results["decode_attention_wide"] = check_decode_attention_wide(torch, timer, reps)
    results.update(check_probes(torch, timer, reps))
    results.update(check_unpack_probes(torch, timer, reps))
    results["diag_copy"] = check_diag_copy(torch, timer, reps)
    return results


def _model_config(p):
    return {
        "name": "llama2_7b_int4", "platform": "llm", "architecture": "llama",
        "model_params": {
            "vocab_size": p.vocab_size, "dim": p.dim, "n_layers": p.n_layers,
            "n_heads": p.n_heads, "n_kv_heads": p.n_kv_heads, "head_dim": p.head_dim,
            "ffn_dim": p.ffn_dim, "init": "random_quantized", "seed": 0},
        "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int4"},
        "generation": {"max_seq_len": 256, "max_slots": 64, "eos_token_id": -1,
                       "max_new_tokens": 32, "prefill_chunk": 64, "decode_horizon": 8},
    }


def _write_repo(cfg) -> str:
    """A model repository in a temporary directory holding one config.json
    (the weights are made from the config's seed)."""
    tmp = tempfile.mkdtemp(prefix="tpuserve_torch_repo_")
    os.makedirs(os.path.join(tmp, cfg["name"], "1"))
    with open(os.path.join(tmp, cfg["name"], "1", "config.json"), "w") as fh:
        json.dump(cfg, fh)
    return tmp


def profile_step(torch, step, tag="slice", what="decode step"):
    """Device busy share of one step: the time of the device's own events
    (kernels, copies, sets) summed by torch.profiler over the step's wall
    time (host clock, synchronized). The host-side rows (aten::...) carry
    their kernels' device time too and are left out, or it would count
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        dev_us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    kernels = sum(r[2] for r in rows)
    if not busy_us:
        log(f"[{tag}] profiler: no device time recorded (not measured)")
        return None
    log(f"[{tag}] profiler, one {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), {kernels} device ops")
    for dev_us, key, count in rows[:8]:
        log(f"[{tag}]   {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, device_ops=kernels,
                top=[(k, d / 1e3, c) for d, k, c in rows[:12]], names=[k for _, k, _ in rows],
                rows=[(k, d / 1e3, c) for d, k, c in rows])


@contextlib.contextmanager
def plain_kernels(llama):
    """Route the model's kernel calls to their plain PyTorch versions for a
    reference run on the card, and restore them after. The served models'
    weights are int4, with bf16 or (W4A8) int8 activations, for which
    qmatmul is exactly quant_matmul."""
    from tpuserve_torch.ops.decode_attention import (decode_attention_packed_plain,
                                                     decode_attention_plain,
                                                     decode_attention_wide_cache_multi_plain,
                                                     decode_attention_wide_cache_plain,
                                                     decode_attention_wide_paged_plain)
    from tpuserve_torch.ops.quant_matmul import quant_matmul_plain

    names = ("qmatmul", "decode_attention_wide_cache", "decode_attention_wide_paged",
             "decode_attention_wide_cache_multi", "decode_attention", "decode_attention_packed")
    saved = [getattr(llama, n) for n in names]
    for n, fn in zip(names, (quant_matmul_plain, decode_attention_wide_cache_plain,
                             decode_attention_wide_paged_plain,
                             decode_attention_wide_cache_multi_plain, decode_attention_plain,
                             decode_attention_packed_plain)):
        setattr(llama, n, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(llama, n, fn)


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every plain version of the attention and
    quant-matmul wrappers (a wrapper takes it only for CPU tensors), to show
    that a profiled step ran none: yields the list of the names called."""
    from tpuserve_torch.ops import decode_attention, quant_matmul

    calls, saved = [], []
    for mod in (decode_attention, quant_matmul):
        for name in dir(mod):
            fn = getattr(mod, name)
            if name.endswith("_plain") and callable(fn):
                saved.append((mod, name, fn))
                setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (calls.append(_n),
                                                                      _fn(*a, **kw))[1])
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def cache_tensors(cache):
    """The contiguous cache's tensors (a float cache has no scales)."""
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


def qmatmul_xla_step(torch, llama, engine, p, toks, cache, pos, logits_k, restore, busy):
    """One full-width decode step under TPUSERVE_QMATMUL=xla (every weight
    dequantized to bf16, then torch.matmul): its logits against the kernel
    step's, no quant-matmul launch in it, and both steps' device time."""
    from tpuserve_torch.ops import quant_matmul

    before = quant_matmul.launches
    with env_set("TPUSERVE_QMATMUL", "xla"):
        logits_x, _ = llama.decode_step(engine.params, p, toks, cache, pos)
        restore()
        busy_x = profile_step(torch, lambda: llama.decode_step(engine.params, p, toks, cache,
                                                                pos),
                              what="decode step under TPUSERVE_QMATMUL=xla")
        restore()
    torch.cuda.synchronize()
    if quant_matmul.launches != before:
        fail("TPUSERVE_QMATMUL=xla: the quant-matmul kernel was launched")
    ref_max = logits_k.abs().max().item()
    err = (logits_x - logits_k).abs().max().item()
    live = pos >= 0
    agree = (logits_x.argmax(-1) == logits_k.argmax(-1))[live].float().mean().item()
    finite = bool(torch.isfinite(logits_x).all())
    tol = 0.05 * ref_max     # as the kernel step against the plain versions
    dev = lambda b: "not measured" if b is None else f"{b['busy_ms']:.2f} ms"
    log(f"[slice] TPUSERVE_QMATMUL=xla full-width decode step vs the kernel step: max|diff| "
        f"{err:.4g} of {ref_max:.4g} (tol {tol:.4g}); argmax agreement {agree:.4f}; finite "
        f"{finite}; device busy: kernels {dev(busy)}, xla {dev(busy_x)}")
    if not finite or not err <= tol:
        fail("TPUSERVE_QMATMUL=xla: its decode step disagrees with the kernel step")
    return dict(max_abs_diff=err, tol=tol, argmax_agreement=agree, profile=busy_x)


def phase_slice(torch, p, smi_line):
    from tpuserve_torch.device import smoke
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import decode_attention, quant_matmul

    counters = (smoke, quant_matmul, decode_attention)
    tmp = _write_repo(_model_config(p))

    torch.cuda.reset_peak_memory_stats()
    for mod in counters:       # the main path's run starts here
        mod.launches = 0
    if not smoke.run_smoke_test(device=DEVICE):
        fail("run_smoke_test returned False")
    mgr = InferenceManager(tmp, num_workers=1, device=DEVICE)
    t_load = time.monotonic()
    mgr.load_model("llama2_7b_int4")
    load_s = time.monotonic() - t_load
    backend = mgr.get_model("llama2_7b_int4").backend
    engine = backend.engine
    rng = torch.Generator().manual_seed(11)

    def prompt(n):
        return torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()

    repeat = prompt(12)
    jobs = [
        dict(prompt_ids=prompt(5), max_new_tokens=24),
        dict(prompt_ids=prompt(200), max_new_tokens=16),                 # chunked (64)
        dict(prompt_ids=prompt(33), max_new_tokens=20, temperature=0.8, top_p=0.9),
        dict(prompt_ids=prompt(90), max_new_tokens=12, temperature=0.8, top_p=0.9),
        dict(prompt_ids=prompt(17), max_new_tokens=32, logprobs=True),
        dict(prompt_ids=repeat, max_new_tokens=24),
        dict(prompt_ids=repeat, max_new_tokens=24),
        dict(prompt_ids=prompt(150), max_new_tokens=10, temperature=0.8, top_p=0.9),
    ]
    # a stop id: the 4th token the stop request would emit without one
    probe = backend.generate(jobs[4]["prompt_ids"], max_new_tokens=8)["generated_ids"]
    jobs[4]["stop_token_ids"] = [probe[3]]
    results = [None] * len(jobs)
    errors = []

    def run(i):
        kw = dict(jobs[i])
        try:
            results[i] = backend.generate(kw.pop("prompt_ids"), **kw)
        except Exception as e:  # recorded, then fatal below
            errors.append(f"request {i}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    steps0, prefills0 = engine.steps, engine.prefill_calls
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {mod.__name__.rsplit(".", 1)[-1]: mod.launches for mod in counters}
    if errors or any(r is None for r in results):
        fail(f"requests failed: {errors}")
    for i, (job, res) in enumerate(zip(jobs, results)):
        want = job["max_new_tokens"]
        if job.get("stop_token_ids"):
            stop = job["stop_token_ids"][0]
            want = probe.index(stop) + 1
            if res["finish_reason"] != "stop" or res["generated_ids"][-1] != stop:
                fail(f"request {i}: stop id not honoured: {res['finish_reason']}")
            if len(res.get("logprobs", [])) != want:
                fail(f"request {i}: {len(res.get('logprobs', []))} logprobs for {want} tokens")
        if res["num_generated"] != want:
            fail(f"request {i}: {res['num_generated']} tokens, expected {want}")
    if results[5]["generated_ids"] != results[6]["generated_ids"]:
        fail("the repeated greedy prompt gave different tokens")
    if results[4]["generated_ids"] != probe[:len(results[4]["generated_ids"])]:
        fail("the greedy stop request differs from its probe run")
    steps = engine.steps            # every decode step and prefill call of the run
    prefills = engine.prefill_calls
    want_qmm = (4 * p.n_layers + 1) * (steps + prefills)  # 4 per layer + lm_head
    want_attn = p.n_layers * steps
    log(f"[slice] {len(jobs)} concurrent requests + 1 probe answered; decode steps {steps}, "
        f"prefill calls {prefills}; launches {launches} "
        f"(expected quant_matmul {want_qmm}, decode_attention {want_attn}, smoke 1)")
    if launches["quant_matmul"] != want_qmm or launches["decode_attention"] != want_attn:
        fail("kernel launch counts do not match the path's calls")
    if min(launches.values()) < 1:
        fail(f"a kernel of the path was never launched: {launches}")
    generated = sum(r["num_generated"] for r in results)
    tok_s = generated / wall
    log(f"[slice] {generated} tokens in {wall:.2f} s of concurrent serving: {tok_s:.1f} tok/s "
        f"(decode steps {engine.steps - steps0}, prefill calls {engine.prefill_calls - prefills0}); "
        f"load {load_s:.1f} s; card {smi_line}")

    # one full-width decode step: all 64 slots live, kernel path vs plain path
    cache = engine.cache
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    toks = torch.randint(0, p.vocab_size, (64,), generator=g, device=DEVICE)
    pos = torch.randint(100, 250, (64,), generator=g, device=DEVICE, dtype=torch.int32)
    pos[7] = -1
    snapshot = [t.clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]

    def restore():
        for dst, src in zip((cache.k, cache.v, cache.k_scale, cache.v_scale), snapshot):
            dst.copy_(src)

    logits_k, _ = llama.decode_step(engine.params, p, toks, cache, pos)
    restore()
    with plain_kernels(llama):
        logits_p, _ = llama.decode_step(engine.params, p, toks, cache, pos)
    restore()
    torch.cuda.synchronize()
    ref_max = logits_p.abs().max().item()
    err = (logits_k - logits_p).abs().max().item()
    live = pos >= 0
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1))[live].float().mean().item()
    finite = bool(torch.isfinite(logits_k).all())
    # bf16 activations through 32 layers: the two paths round at the same
    # points, and a rounding step that tips one way (a bf16 activation, a
    # KV or P code) carries forward; bound: 5% of the logit range
    tol = 0.05 * ref_max
    log(f"[slice] full-width decode step, kernels vs plain: max|err| {err:.4g} of "
        f"{ref_max:.4g} (tol {tol:.4g}); argmax agreement {agree:.4f}; finite {finite}")
    if not finite or not err <= tol:
        fail("full-width decode step: kernel path and plain path disagree")

    # step time of the kernel path (host clock around synchronized steps)
    step_ms, times = _host_ms(torch, lambda i: llama.decode_step(engine.params, p, toks, cache,
                                                                 pos + i))
    restore()
    busy = profile_step(torch, lambda: llama.decode_step(engine.params, p, toks, cache, pos))
    restore()
    xla = qmatmul_xla_step(torch, llama, engine, p, toks, cache, pos, logits_k, restore, busy)
    peak = torch.cuda.max_memory_allocated()
    log(f"[slice] decode step (64 slots, L=256, {p.n_layers} layers): median {step_ms:.2f} ms "
        f"-> {64 / step_ms * 1e3:.1f} tok/s at full batch; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; card {smi_line}")
    mgr.shutdown()
    return dict(launches=launches, want=dict(quant_matmul=want_qmm, decode_attention=want_attn),
                decode_steps=steps, prefill_calls=prefills, tokens=generated, wall_s=wall,
                tok_s=tok_s, step_ms=step_ms, step_times_ms=times, profile=busy,
                full_step_err=err,
                full_step_tol=tol, argmax_agreement=agree, max_memory_allocated=peak,
                load_s=load_s, qmatmul_xla=xla)


def phase_quant_route(torch, p, smi_line, tag, quant, per_call):
    """The slice's configuration with `quant` (W4A8: activations int8;
    odd: int4 in groups of 688, which a 64-row stage cannot tile; g344:
    groups of 344 = 11008 / 32, w_down's, in masked k16 steps, with bf16 x
    or, w4a8-g344, int8 x in masked k32 steps; the weights of K = 4096 then
    have one group, per channel), its weights random bf16 from a seed and
    quantized at load, the path a checkpoint takes (init random_quantized
    makes codes directly and, as the JAX package's, leaves activations
    out). 4 concurrent greedy requests of 16 new tokens; each route
    counter must show exactly the launches `per_call` gives it for every
    decode step and prefill call, every other route counter none, and the
    row quantization one for every W4A8 launch;
    one full-width decode step through the kernels against the plain
    versions, through one layer (logits within 5% of their range) and all
    32 (greedy tokens equal wherever the top two logits are further apart
    than twice the two paths' largest difference); one profiled decode
    step: device time and the quant-matmul's share."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import quant_matmul as tqm

    cfg = _model_config(p)
    cfg["name"] = f"llama2_7b_{tag}"
    cfg["model_params"]["init"] = "random"
    cfg["quantization"].update(quant)
    tmp = _write_repo(cfg)
    mgr = InferenceManager(tmp, num_workers=1, device=DEVICE)
    t_load = time.monotonic()
    mgr.load_model(cfg["name"])
    load_s = time.monotonic() - t_load
    backend = mgr.get_model(cfg["name"]).backend
    engine = backend.engine
    rng = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()
               for n in (9, 40, 100, 23)]
    results, errors = [None] * len(prompts), []

    def run(i):
        try:
            results[i] = backend.generate(prompts[i], max_new_tokens=16)
        except Exception as e:  # recorded, then fatal below
            errors.append(f"request {i}: {e}")

    counters = ("launches", "group_route_launches", "odd_group_launches", "w4a8_launches",
                "w4a8_route_launches", "stage_launches", "quantize_launches")
    for c in counters:          # the path's run starts here
        setattr(tqm, c, 0)
    steps0, prefills0 = engine.steps, engine.prefill_calls
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {c: getattr(tqm, c) for c in counters}
    if errors or any(r is None for r in results):
        fail(f"[{tag}] requests failed: {errors}")
    if any(r["num_generated"] != 16 for r in results):
        fail(f"[{tag}] a request did not generate 16 tokens")
    calls = engine.steps - steps0 + engine.prefill_calls - prefills0
    want = {c: per_call.get(c, 0) * calls for c in counters[1:-2]}
    want["launches"] = (4 * p.n_layers + 1) * calls
    want["stage_launches"] = want["group_route_launches"]   # bf16 x laid out for each
    want["quantize_launches"] = want["w4a8_launches"] + want["w4a8_route_launches"]
    log(f"[{tag}] {len(prompts)} concurrent greedy requests, 16 new tokens each, in "
        f"{wall:.2f} s; decode steps {engine.steps - steps0}, prefill calls "
        f"{engine.prefill_calls - prefills0}; quant_matmul launches {counts} (expected "
        f"{want}); load {load_s:.1f} s")
    if counts != want:
        fail(f"[{tag}] route launches do not match the path's calls")

    cache = engine.cache
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    toks = torch.randint(0, p.vocab_size, (64,), generator=g, device=DEVICE)
    pos = torch.randint(100, 250, (64,), generator=g, device=DEVICE, dtype=torch.int32)
    pos[7] = -1
    snapshot = [t.clone() for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)]

    def restore():
        for dst, src in zip((cache.k, cache.v, cache.k_scale, cache.v_scale), snapshot):
            dst.copy_(src)

    # Two depths: one layer (layer 0, the final norm and lm_head: every
    # weight shape of the path once) held to [slice]'s 5% of the logit
    # range, and all 32, where a randomly initialised model grows any
    # one-ulp difference (W4A8's int8 rounding of each matmul's input turns
    # one near a row's absmax into half a code step), so greedy tokens are
    # held equal wherever the top two logits are further apart than twice
    # the paths' difference.
    depths = {}
    for depth in (1, p.n_layers):
        pd = dataclasses.replace(p, n_layers=depth)
        logits_k, _ = llama.decode_step(engine.params, pd, toks, cache, pos)
        restore()
        with plain_kernels(llama):
            logits_p, _ = llama.decode_step(engine.params, pd, toks, cache, pos)
        restore()
        torch.cuda.synchronize()
        live = pos >= 0
        ref_max = logits_p.abs().max().item()
        err = (logits_k - logits_p)[live].abs().max().item()
        top2 = logits_p.float().topk(2, dim=-1).values
        clear = live & ((top2[:, 0] - top2[:, 1]) > 2 * err)
        same = logits_k.argmax(-1) == logits_p.argmax(-1)
        finite = bool(torch.isfinite(logits_k).all())
        tol = 0.05 * ref_max if depth == 1 else None
        log(f"[{tag}] full-width decode step, {depth} layer(s), kernels vs plain: max|err| "
            f"{err:.4g} of {ref_max:.4g}" + (f" (tol {tol:.4g})" if tol else " (no bound)")
            + f"; greedy tokens equal on {int((same & live).sum())} of {int(live.sum())} live "
            f"slots, on all {int(clear.sum())} whose top two logits are more than 2x max|err| "
            f"apart: {bool(same[clear].all())}; finite {finite}")
        if not finite or (tol and not err <= tol) or not bool(same[clear].all()):
            fail(f"[{tag}] full-width decode step: kernel path and plain path disagree")
        depths[depth] = dict(err=err, tol=tol, range=ref_max, greedy_equal=int((same & live).sum()),
                             live=int(live.sum()), clear=int(clear.sum()))
    busy = profile_step(torch, lambda: llama.decode_step(engine.params, p, toks, cache, pos),
                        tag=tag)
    restore()
    qmm_ms = quant_ms = None
    if busy:
        qmm_ms = sum(ms for key, ms, _ in busy["rows"] if "qmm_" in key)
        quant_ms = sum(ms for key, ms, _ in busy["rows"] if "quantize_rows" in key)
        log(f"[{tag}] quant-matmul kernels in the profiled step: {qmm_ms:.3f} ms of "
            f"{busy['busy_ms']:.3f} ms device time ({100 * qmm_ms / busy['busy_ms']:.1f}%), the "
            f"row quantization {quant_ms:.3f} ms; card {smi_line}")
    mgr.shutdown()
    return dict(launches=counts, want=want, load_s=load_s, wall_s=wall,
                full_step=depths, profile=busy, qmm_ms=qmm_ms, quantize_ms=quant_ms)


def _mixtral_config(p):
    """Mixtral-8x7B-v0.1's published widths (its config.json) at init
    random_quantized (seeded int4 g128 codes, a seeded bf16 router), served
    as the slice is: packed int4 KV with f32 scales, 64 slots, L=256,
    prefill_chunk 64, decode_horizon 8."""
    mp = {f: getattr(p, f) for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                                      "head_dim", "ffn_dim", "rope_theta", "rms_eps",
                                      "n_experts", "n_experts_per_tok")}
    return {
        "name": "mixtral_8x7b_int4", "platform": "llm", "architecture": "mixtral",
        "model_params": dict(mp, init="random_quantized", seed=0),
        "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int4"},
        "generation": {"max_seq_len": 256, "max_slots": 64, "eos_token_id": -1,
                       "max_new_tokens": 32, "prefill_chunk": 64, "decode_horizon": 8},
    }


@contextlib.contextmanager
def moe_routes(torch, llama, replay=None):
    """Record the top-k experts of every moe_combine_weights call (replay
    None), or hand each call the recorded experts in turn, its gates the
    softmax of this path's own logits at them, and count the rows whose own
    top-k parts from the record. Yields dict(picks=[[T, k] indices ...],
    parted=[tensor ...])."""
    real = llama.moe_combine_weights
    rec = dict(picks=[], parted=[])
    given = iter(replay or ())

    def combine(logits, n_experts, k):
        logits = logits.to(torch.float32)
        own = llama._top_k(logits, k)[1]
        if replay is None:
            rec["picks"].append(own)
            return real(logits, n_experts, k)
        idx = next(given)
        rec["parted"].append((own.sort(-1).values != idx.sort(-1).values).any(-1).sum())
        only = torch.full_like(logits, -math.inf).scatter(-1, idx, logits.gather(-1, idx))
        return real(only, n_experts, k)

    llama.moe_combine_weights = combine
    try:
        yield rec
    finally:
        llama.moe_combine_weights = real


def phase_mixtral(torch, p, smi_line):
    """A Mixtral-8x7B-width MoE model (p: 32 layers, 8 experts, top-2, GQA
    32/8) at full depth through InferenceManager(device="cuda"): 8
    concurrent greedy requests (prompts of 5-200 tokens, 24 new tokens each)
    through the backend's generate, every call launching (2 + 2E) x n_layers
    + 1 quant-matmuls (wqkv, wo, each expert's gate|up and down, lm_head;
    every expert runs on every call) and each decode step n_layers flat
    decode attentions, no plain version called; one full-width decode step
    (all 64 slots live: dispatch at cap 32) and the same step under
    TPUSERVE_MOE_DECODE_DISPATCH_T=128 (the dense loop over 64 rows),
    kernels against plain versions within 5% of the logit range, the plain
    path handed the kernel path's per-layer top-k experts (the two route
    from activations rounded in other orders; the rows whose own top-k
    parts are counted); host-clock step time and one profiled step's device
    time with the quant-matmul's and the attention's shares."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.models.llama_bench import param_bytes
    from tpuserve_torch.ops import decode_attention, quant_matmul

    cfg = _mixtral_config(p)
    tmp = _write_repo(cfg)
    torch.cuda.reset_peak_memory_stats()
    mgr = InferenceManager(tmp, num_workers=1, device=DEVICE)
    t_load = time.monotonic()
    mgr.load_model(cfg["name"])
    load_s = time.monotonic() - t_load
    backend = mgr.get_model(cfg["name"]).backend
    engine = backend.engine
    wbytes = param_bytes(engine.params)
    rng = torch.Generator().manual_seed(17)
    prompts = [torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()
               for n in (5, 200, 33, 90, 17, 64, 150, 120)]
    per_call = (2 + 2 * p.n_experts) * p.n_layers + 1
    quant_matmul.launches = decode_attention.launches = 0     # the path's run starts here
    steps0, prefills0 = engine.steps, engine.prefill_calls
    with plain_calls() as plain:
        tokens, wall = _serve_wave(backend, prompts, 24, "mixtral")
    launches = dict(quant_matmul=quant_matmul.launches,
                    decode_attention=decode_attention.launches)
    steps, prefills = engine.steps - steps0, engine.prefill_calls - prefills0
    want = dict(quant_matmul=per_call * (steps + prefills),
                decode_attention=p.n_layers * steps)
    generated = sum(len(t) for t in tokens)
    log(f"[mixtral] {len(prompts)} concurrent greedy requests, 24 new tokens each, in {wall:.2f} s "
        f"({generated / wall:.1f} tok/s); decode steps {steps}, prefill calls {prefills}; "
        f"launches {launches} (expected {want}: {per_call} quant-matmuls a call); plain "
        f"versions called {sorted(set(plain))}; weights {wbytes / 1e9:.2f} GB, load {load_s:.1f} s")
    if launches != want:
        fail("[mixtral] kernel launch counts do not match the path's calls")
    if plain:
        fail(f"[mixtral] plain versions ran on the served path: {sorted(set(plain))}")

    cache = engine.cache
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    toks = torch.randint(0, p.vocab_size, (64,), generator=g, device=DEVICE)
    pos = torch.randint(100, 250, (64,), generator=g, device=DEVICE, dtype=torch.int32)
    snapshot = [t.clone() for t in cache_tensors(cache)]

    def restore():
        for dst, src in zip(cache_tensors(cache), snapshot):
            dst.copy_(src)

    def step():
        return llama.decode_step(engine.params, p, toks, cache, pos)[0]

    steps_out = {}
    for label, decode_t in (("dispatch", None), ("dense", "128")):
        with env_set("TPUSERVE_MOE_DECODE_DISPATCH_T", decode_t):
            before = quant_matmul.launches
            with moe_routes(torch, llama) as routed:
                logits_k = step()
            restore()
            n_qmm = quant_matmul.launches - before
            with plain_kernels(llama), moe_routes(torch, llama, routed["picks"]) as replayed:
                logits_p = step()
            restore()
            torch.cuda.synchronize()
            parted = int(sum(t.item() for t in replayed["parted"]))
            # pairs past an expert's capacity (cap 32 of 64 tokens), per layer
            counts = torch.stack([torch.bincount(pk.reshape(-1), minlength=p.n_experts)
                                  for pk in routed["picks"]])
            over = int((counts - 32).clamp_min(0).sum().item())
            ref_max = logits_p.abs().max().item()
            err = (logits_k - logits_p).abs().max().item()
            agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
            finite = bool(torch.isfinite(logits_k).all())
            tol = 0.05 * ref_max
            log(f"[mixtral] full-width decode step, {label} (64 slots live), kernels vs plain "
                f"(the plain path given the kernel path's experts): max|err| {err:.4g} of "
                f"{ref_max:.4g} (tol {tol:.4g}); argmax agreement {agree:.4f}; finite {finite}; "
                f"{n_qmm} quant-matmuls; rows whose own top-{p.n_experts_per_tok} parted in the "
                f"plain path: {parted} of {64 * p.n_layers}; pairs past capacity 32: {over} "
                f"over {p.n_layers} layers (max per expert and layer {int(counts.max())})")
            if not finite or not err <= tol:
                fail(f"[mixtral] full-width decode step ({label}): kernel path and plain path "
                     "disagree")
            if n_qmm != per_call:
                fail(f"[mixtral] the {label} step launched {n_qmm} quant-matmuls, not {per_call}")
            step_ms, times = _host_ms(torch, lambda i: llama.decode_step(
                engine.params, p, toks, cache, pos + i))
            restore()
            busy = profile_step(torch, step, tag="mixtral", what=f"decode step ({label})")
            restore()
            qmm_ms = attn_ms = None
            if busy:
                qmm_ms = sum(ms for key, ms, _ in busy["rows"] if "qmm_" in key)
                attn_ms = sum(ms for key, ms, _ in busy["rows"] if "attn_core_kernel" in key)
                log(f"[mixtral] {label} step: host clock median {step_ms:.2f} ms; device busy "
                    f"{busy['busy_ms']:.2f} ms: quant-matmul {qmm_ms:.3f} ms "
                    f"({100 * qmm_ms / busy['busy_ms']:.1f}%), decode attention {attn_ms:.3f} ms "
                    f"({100 * attn_ms / busy['busy_ms']:.1f}%); weights {wbytes / 1e9:.2f} GB: "
                    f"bytes bound {wbytes / HBM_BYTES_PER_S * 1e3:.2f} ms (a reference point); "
                    f"card {smi_line}")
            steps_out[label] = dict(err=err, tol=tol, range=ref_max, argmax_agreement=agree,
                                    parted_rows=parted, pairs_past_cap=over, qmm_launches=n_qmm,
                                    step_ms=step_ms, step_times_ms=times, profile=busy,
                                    qmm_ms=qmm_ms, attn_ms=attn_ms, logits=logits_k)
    diff = (steps_out["dispatch"].pop("logits") - steps_out["dense"].pop("logits")).abs().max()
    log(f"[mixtral] dispatch step against the dense-loop step: max|diff| {diff.item():.4g} "
        "(they part where a pair overflowed, and by bf16 rounding)")
    peak = torch.cuda.max_memory_allocated()
    log(f"[mixtral] max_memory_allocated {peak / 2**30:.2f} GiB; card {smi_line}")
    mgr.shutdown()
    return dict(launches=launches, want=want, decode_steps=steps, prefill_calls=prefills,
                tokens=generated, wall_s=wall, load_s=load_s, weight_bytes=wbytes,
                steps=steps_out, dispatch_vs_dense=diff.item(), max_memory_allocated=peak)


def _paged_model_config(p):
    """bench.py's paged setting (TPUSERVE_BENCH_PAGED=1: int8 pool,
    page_size 128, num_pages 0 = n_slots * pages per slot + 1), with prefix
    sharing and chunks of one page."""
    cfg = _model_config(p)
    cfg["name"] = "llama2_7b_int4_paged"
    cfg["quantization"]["kv_cache"] = "int8"
    cfg["generation"].update(paged=True, page_size=128, num_pages=0, prefix_sharing=True,
                             prefill_chunk=128)
    return cfg


def _pages_back(engine, want, timeout=30.0):
    """Serving stats once `want` pages are free or cached: a slot's pages go
    back just after its request completes, on the scheduler's thread."""
    t_end = time.monotonic() + timeout
    while True:
        st = engine.serving_stats()
        back = st["kv_free_pages"] + st.get("prefix_cached_blocks", 0)
        if back == want or time.monotonic() > t_end:
            return st, back
        time.sleep(0.01)


def phase_paged_slice(torch, p, smi_line):
    from tpuserve_torch.device import smoke
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import decode_attention, quant_matmul

    cfg = _paged_model_config(p)
    name = cfg["name"]
    tmp = _write_repo(cfg)
    torch.cuda.reset_peak_memory_stats()
    mgr = InferenceManager(tmp, num_workers=1, device=DEVICE)
    t_load = time.monotonic()
    mgr.load_model(name)
    load_s = time.monotonic() - t_load
    backend = mgr.get_model(name).backend
    engine = backend.engine
    ptm, cache = engine.ptm, engine.cache
    ps, n_pages = ptm.page_size, cache.n_pages
    rng = torch.Generator().manual_seed(13)

    def prompt(n):
        return torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()

    stem = prompt(ps)                                   # one full page, shared
    shared = [stem + prompt(n) for n in (20, 37, 9)]
    jobs = [
        dict(prompt_ids=prompt(200), max_new_tokens=16),                   # chunked: 128 + 72
        dict(prompt_ids=shared[1], max_new_tokens=16),                     # shares the stem
        dict(prompt_ids=shared[2], max_new_tokens=12, temperature=0.8, top_p=0.9),
        dict(prompt_ids=prompt(6), max_new_tokens=24),
        dict(prompt_ids=prompt(40), max_new_tokens=20, temperature=0.8, top_p=0.9),
        dict(prompt_ids=prompt(100), max_new_tokens=10, temperature=0.7, top_k=40),
        dict(prompt_ids=prompt(9), max_new_tokens=32, repetition_penalty=1.2),
    ]
    results = [None] * len(jobs)
    errors = []

    def run(i):
        kw = dict(jobs[i])
        try:
            results[i] = backend.generate(kw.pop("prompt_ids"), **kw)
        except Exception as e:  # recorded, then fatal below
            errors.append(f"request {i}: {e}")

    for mod in (smoke, quant_matmul, decode_attention):  # the paged path's run starts here
        mod.launches = 0
    decode_attention.paged_launches = 0
    steps0, prefills0 = engine.steps, engine.prefill_calls
    t0 = time.monotonic()
    first = backend.generate(shared[0], max_new_tokens=16)  # registers the stem's page
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"quant_matmul": quant_matmul.launches,
                "decode_attention": decode_attention.launches,
                "decode_attention_paged": decode_attention.paged_launches}
    steps = engine.steps - steps0
    prefills = engine.prefill_calls - prefills0
    if errors or any(r is None for r in results):
        fail(f"paged requests failed: {errors}")
    for i, (job, res) in enumerate(zip(jobs + [dict(max_new_tokens=16)], results + [first])):
        if res["num_generated"] != job["max_new_tokens"]:
            fail(f"paged request {i}: {res['num_generated']} tokens, "
                 f"expected {job['max_new_tokens']}")
    stats, back = _pages_back(engine, n_pages - 1)
    want_qmm = (4 * p.n_layers + 1) * (steps + prefills)
    want_paged = p.n_layers * steps
    generated = first["num_generated"] + sum(r["num_generated"] for r in results)
    log(f"[paged] {len(jobs) + 1} requests answered ({generated} tokens in {wall:.2f} s, "
        f"{generated / wall:.1f} tok/s); decode steps {steps}, prefill calls {prefills}; "
        f"launches {launches} (expected quant_matmul {want_qmm}, decode_attention_paged "
        f"{want_paged}, decode_attention 0); prefix hits {stats['prefix_hits']} blocks, "
        f"{stats['prefix_hit_tokens']} tokens; pages free {stats['kv_free_pages']} + cached "
        f"{stats['prefix_cached_blocks']} of {n_pages - 1}; load {load_s:.1f} s")
    if (launches["decode_attention_paged"] != want_paged
            or launches["quant_matmul"] != want_qmm or launches["decode_attention"] != 0):
        fail("paged slice: kernel launch counts do not match the path's calls")
    if min(launches["decode_attention_paged"], launches["quant_matmul"]) < 1:
        fail(f"paged slice: a kernel of the path was never launched: {launches}")
    if stats["prefix_hit_tokens"] < ps:
        fail(f"paged slice: prefix_hit_tokens {stats['prefix_hit_tokens']} < {ps}")
    if back != n_pages - 1:
        fail(f"paged slice: {back} of {n_pages - 1} pages came back after retirement")

    # first-token logits of a shared admission (the cached stem page, then a
    # suffix prefill over it, as GenerationEngine._dev_admit runs it) against
    # an unshared full prefill of the same prompt into private pages. Every
    # request has retired and the scheduler waits on its queue.
    slot, errs, agree, firsts, shared_max = 0, [], [], [], 0.0
    for ids in shared + [stem + prompt(50)]:
        bucket = engine._bucket_len(len(ids))
        _, matched = ptm.admit_shared(slot, ids)
        if matched < ps:
            fail(f"paged slice: the stem was not matched ({matched} tokens)")
        ptm.ensure(slot, bucket)
        suffix = ids[matched:]
        cb = engine._bucket_len(len(suffix))
        win = -(-min(matched + cb, engine.max_seq_len) // ps) * ps
        l_shared, _ = llama.prefill_paged_suffix(
            engine.params, p, engine._tokens(suffix, cb), cache, ptm.device_table(), slot,
            matched, len(suffix), window=win)
        ptm.release(slot)
        ptm.ensure(slot, bucket)                        # private pages only
        l_full, _ = llama.prefill_paged(engine.params, p, engine._tokens(ids, bucket), cache,
                                        ptm.device_table(), slot, len(ids))
        ptm.release(slot)
        l_shared, l_full = l_shared.float(), l_full.float()
        errs.append((l_shared - l_full).abs().max().item())
        shared_max = max(shared_max, l_full.abs().max().item())
        agree.append(int(l_shared.argmax().item() == l_full.argmax().item()))
        firsts.append(l_full.argmax().item())
    # the suffix attends over int8 pages of the prefix where the full
    # prefill attends over its fresh bf16 K/V: one KV quantization step per
    # prefix row, carried through 32 layers; bound: 5% of the logit range
    shared_tol = 0.05 * shared_max
    log(f"[paged] shared vs unshared first-token logits, {len(errs)} prompts: max|err| "
        f"{max(errs):.4g} of {shared_max:.4g} (tol {shared_tol:.4g}); argmax agreement "
        f"{sum(agree)}/{len(agree)} ({len(set(firsts))} distinct first tokens)")
    if not max(errs) <= shared_tol:
        fail("paged slice: shared and unshared admissions disagree")

    # one full-width paged decode step: 64 slots over shuffled pages filled
    # with random codes and scales, kernel path vs plain path
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    for t in (cache.k, cache.v):
        t.random_(-127, 128, generator=g)
    for t in (cache.k_scale, cache.v_scale):
        t.uniform_(0.005, 0.015, generator=g)
    n_cols = -(-engine.max_seq_len // ps)
    table = (1 + torch.randperm(n_pages - 1, generator=g, device=DEVICE))[:64 * n_cols]
    table = table.view(64, n_cols).to(torch.int32)
    toks = torch.randint(0, p.vocab_size, (64,), generator=g, device=DEVICE)
    pos = torch.randint(100, 250, (64,), generator=g, device=DEVICE, dtype=torch.int32)
    pos[7] = -1
    pool = (cache.k, cache.v, cache.k_scale, cache.v_scale)
    snapshot = [t.clone() for t in pool]

    def restore():
        for dst, src in zip(pool, snapshot):
            dst.copy_(src)

    def step(i=0):
        return llama.decode_step_paged(engine.params, p, toks, cache, table, pos + i)[0]

    logits_k = step()
    restore()
    with plain_kernels(llama):
        logits_p = step()
    restore()
    torch.cuda.synchronize()
    ref_max = logits_p.abs().max().item()
    err = (logits_k - logits_p).abs().max().item()
    live = pos >= 0
    agree_step = (logits_k.argmax(-1) == logits_p.argmax(-1))[live].float().mean().item()
    finite = bool(torch.isfinite(logits_k).all())
    tol = 0.05 * ref_max  # as the contiguous slice's full-width step
    log(f"[paged] full-width decode_step_paged, kernels vs plain: max|err| {err:.4g} of "
        f"{ref_max:.4g} (tol {tol:.4g}); argmax agreement {agree_step:.4f}; finite {finite}")
    if not finite or not err <= tol:
        fail("full-width paged decode step: kernel path and plain path disagree")

    step_ms, times = _host_ms(torch, step)
    restore()
    busy = profile_step(torch, step, tag="paged")
    restore()
    # the page table's upload, as the engine makes it once per decode dispatch
    uploads = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.monotonic()
        ptm.device_table()
        torch.cuda.synchronize()
        uploads.append((time.monotonic() - t) * 1e3)
    upload_ms = sorted(uploads)[len(uploads) // 2]
    peak = torch.cuda.max_memory_allocated()
    log(f"[paged] paged decode step (64 slots, L=256, {p.n_layers} layers, int8 pool): median "
        f"{step_ms:.2f} ms -> {64 / step_ms * 1e3:.1f} tok/s at full batch; page-table upload "
        f"{upload_ms:.4f} ms; max_memory_allocated {peak / 2**30:.2f} GiB; card {smi_line}")
    mgr.shutdown()
    return dict(launches=launches, want=dict(quant_matmul=want_qmm,
                                             decode_attention_paged=want_paged),
                decode_steps=steps, prefill_calls=prefills, tokens=generated, wall_s=wall,
                stats=stats, shared_errs=errs, shared_tol=shared_tol, shared_ref_max=shared_max,
                shared_argmax_agree=agree, full_step_err=err, full_step_tol=tol,
                argmax_agreement=agree_step, step_ms=step_ms, step_times_ms=times,
                profile=busy, table_upload_ms=upload_ms, max_memory_allocated=peak,
                load_s=load_s)


def _spec_model_config(p):
    """The JAX package's 7B speculation setting (scripts/spec_bench.py):
    int4 g128 weights, int8 KV, 8 slots of 512 tokens, up to 8 drafts per
    verify, 4 fused rounds, decode horizon 4; speculation_min_gain 0, so
    every eligible step speculates."""
    cfg = _model_config(p)
    cfg["name"] = "llama2_7b_int4_spec"
    cfg["quantization"]["kv_cache"] = "int8"
    cfg["generation"] = {"max_seq_len": 512, "max_slots": 8, "eos_token_id": -1,
                         "max_new_tokens": 256, "decode_horizon": 4, "speculation_tokens": 8,
                         "speculation_rounds": 4, "speculation_min_gain": 0}
    return cfg


def _periodic_prompt(vocab_size):
    """spec_bench.py's repetitive prompt: a 12-token period drawn from
    numpy's default_rng(0), repeated to 96 tokens."""
    import numpy as np

    period = np.random.default_rng(0).integers(100, vocab_size - 1, 12).tolist()
    return (period * 10)[:96]


def _serve_wave(backend, prompts, new, tag):
    """One concurrent greedy request per prompt, a thread each; fatal unless
    every one returns `new` tokens. Returns (token lists, wall seconds)."""
    import torch

    results, errors = [None] * len(prompts), []

    def run(i):
        try:
            results[i] = backend.generate(prompts[i], max_new_tokens=new)
        except Exception as e:  # recorded, then fatal below
            errors.append(f"request {i}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if errors or any(r is None for r in results):
        fail(f"[{tag}] requests failed: {errors}")
    for i, r in enumerate(results):
        if r["num_generated"] != new:
            fail(f"[{tag}] request {i}: {r['num_generated']} tokens, expected {new}")
    return [r["generated_ids"] for r in results], wall


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _gate_served(torch, engine, p, prompts, a_tokens, b_tokens, margin, tag, what):
    """Fail on a served request whose first token that differs between two
    runs (`a_tokens` against `b_tokens`) falls on a clear step: one prefill
    of its prompt and the tokens the runs share gives that step's logits,
    and the step is clear where their top two are further apart than
    `margin` (twice the two paths' difference on the full-width step). A
    near tie that tipped is reported. Returns the differing steps' gaps."""
    from tpuserve_torch.models import llama

    gaps = []
    for i, (prompt, a, b) in enumerate(zip(prompts, a_tokens, b_tokens)):
        d = _first_diff(a, b)
        if d is None:
            continue
        seq = list(prompt) + list(a[:d])
        cache = llama.KVCache.create(p, 1, len(seq), quantized=False, device=DEVICE)
        toks = torch.tensor([seq], dtype=torch.long, device=DEVICE)
        top2 = llama.prefill(engine.params, p, toks, cache, 0, len(seq))[0].float().topk(2)
        gap = (top2.values[0, 0] - top2.values[0, 1]).item()
        gaps.append(gap)
        del cache
        if gap > margin:
            fail(f"[{tag}] request {i}: {what} differ at token {d}, a clear step (top-two gap "
                 f"{gap:.4g} > {margin:.4g})")
    log(f"[{tag}] served tokens, {what}: top-two gaps at the first differing tokens {gaps} "
        f"(fatal above {margin:.4g})")
    return gaps


def _host_ms(torch, fn, n=6):
    """Median host-clock time of fn(i), synchronized, the first call left out."""
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.monotonic()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.monotonic() - t) * 1e3)
    rest = sorted(times[1:])
    return rest[len(rest) // 2], times


def phase_spec(torch, p, smi_line, tag="spec", kv_cache="int8"):
    """Speculative decoding through the served path: 8 concurrent greedy
    requests of the periodic prompt, speculation on (the main path's run of
    the multi kernel) and then off on the same engine; then one full-width
    verify_step, kernels vs plain versions and vs C sequential decode steps
    (greedy tokens equal on every slot whose top two logits are apart), and
    one profiled verify step with no plain-version call. `kv_cache` "none"
    (the [spec-bf16] phase) is the JAX package's default bf16 cache."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import decode_attention, quant_matmul

    cfg = _spec_model_config(p)
    cfg["quantization"]["kv_cache"] = kv_cache
    cfg["name"] = name = f"{cfg['name']}_{kv_cache}"
    torch.cuda.reset_peak_memory_stats()
    mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
    mgr.load_model(name)
    backend = mgr.get_model(name).backend
    engine = backend.engine
    gen = engine.config.generation
    spec_k, n_slots, new = int(gen.speculation_tokens), engine.n_slots, 64
    prompts = [_periodic_prompt(p.vocab_size)] * n_slots
    backend.generate(prompts[0], max_new_tokens=8)      # warm-up, outside the counted run

    for mod in (quant_matmul, decode_attention):        # the speculative path's run starts here
        mod.launches = 0
    decode_attention.paged_launches = decode_attention.multi_launches = 0
    base = dict(steps=engine.steps, prefills=engine.prefill_calls, verifies=engine.verify_calls,
                drafted=engine.spec_drafted, accepted=engine.spec_accepted)
    on_tokens, on_wall = _serve_wave(backend, prompts, new, tag)
    launches = {"quant_matmul": quant_matmul.launches,
                "decode_attention": decode_attention.launches,
                "decode_attention_paged": decode_attention.paged_launches,
                "decode_attention_multi": decode_attention.multi_launches}
    steps = engine.steps - base["steps"]                 # a verify round counts one step
    prefills = engine.prefill_calls - base["prefills"]
    verifies = engine.verify_calls - base["verifies"]
    drafted = engine.spec_drafted - base["drafted"]
    accepted = engine.spec_accepted - base["accepted"]
    want = {"quant_matmul": (4 * p.n_layers + 1) * (steps + prefills),
            "decode_attention": p.n_layers * (steps - verifies),
            "decode_attention_paged": 0,
            "decode_attention_multi": p.n_layers * verifies}
    acceptance = accepted / drafted if drafted else None
    on_tok_s = n_slots * new / on_wall
    log(f"[{tag}] {n_slots} concurrent greedy requests of the periodic 96-token prompt, {new} "
        f"tokens each: {on_wall:.2f} s, {on_tok_s:.1f} tok/s; verify calls {verifies} (rounds), "
        f"decode steps {steps - verifies}, prefill calls {prefills}; drafted {drafted}, "
        f"accepted {accepted} (acceptance {acceptance}); launches {launches} (expected {want}); "
        f"speculation disabled {engine._spec_disabled}")
    if drafted <= 0:
        fail(f"[{tag}] no token was drafted")
    if engine._spec_disabled:
        fail(f"[{tag}] a verify dispatch failed and disabled speculation")
    if verifies < 1 or launches != want:
        fail(f"[{tag}] kernel launch counts do not match the path's calls")

    gen.speculation_tokens = 0                           # the same engine, speculation off
    off_tokens, off_wall = _serve_wave(backend, prompts, new, f"{tag}-off")
    gen.speculation_tokens = spec_k
    off_tok_s = n_slots * new / off_wall
    diffs = [_first_diff(a, b) for a, b in zip(on_tokens, off_tokens)]
    log(f"[{tag}] speculation off, same engine and traffic: {off_wall:.2f} s, {off_tok_s:.1f} "
        f"tok/s (on/off {on_tok_s / off_tok_s:.3f}); first differing token per request, on vs "
        f"off (None = equal): {diffs}; card {smi_line}")

    # one full-width verify_step: 8 slots x 9 candidates at positions 100-400
    # (one slot with 3 drafts, one inactive), kernels vs plain versions, and
    # against C sequential decode steps on a copy of the cache
    cache = engine.cache
    g = torch.Generator(device=DEVICE)
    g.manual_seed(4)
    c = spec_k + 1
    toks = torch.randint(0, p.vocab_size, (n_slots, c), generator=g, device=DEVICE)
    pos = torch.randint(100, 401, (n_slots,), generator=g, device=DEVICE, dtype=torch.int32)
    lens = torch.full((n_slots,), c, dtype=torch.int32, device=DEVICE)
    lens[3] = 4
    pos[5], lens[5] = -1, 0
    valid = torch.arange(c, device=DEVICE)[None, :] < lens[:, None]
    tensors = cache_tensors(cache)
    snapshot = [t.clone() for t in tensors]

    def restore():
        for dst, src in zip(tensors, snapshot):
            dst.copy_(src)

    def verify(i=0):
        return llama.verify_step(engine.params, p, toks, cache,
                                 torch.where(pos >= 0, pos + i, pos), lens)[0]

    logits_k = verify().float()
    restore()
    with plain_kernels(llama):
        logits_p = verify().float()
    restore()
    seq = llama.KVCache(*[t.clone() for t in snapshot], *[None] * (4 - len(snapshot)))
    seq_logits = []
    for j in range(c):
        step_pos = torch.where(lens > j, pos + j, -1).to(torch.int32)
        seq_logits.append(llama.decode_step(engine.params, p, toks[:, j], seq, step_pos)[0].float())
    logits_s = torch.stack(seq_logits, dim=1)
    del seq
    torch.cuda.synchronize()
    ref_max = logits_p[valid].abs().max().item()
    err = (logits_k - logits_p)[valid].abs().max().item()
    seq_err = (logits_k - logits_s)[valid].abs().max().item()
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1))[valid].float().mean().item()
    seq_agree = (logits_k.argmax(-1) == logits_s.argmax(-1))[valid].float().mean().item()
    # greedy tokens of the verify and of the sequential steps, equal on every
    # (slot, candidate) whose top two logits are further apart than twice
    # the two paths' difference
    top2 = logits_s.topk(2, dim=-1).values
    clear = valid & ((top2[..., 0] - top2[..., 1]) > 2 * seq_err)
    clear_equal = bool((logits_k.argmax(-1) == logits_s.argmax(-1))[clear].all())
    finite = bool(torch.isfinite(logits_k).all())
    zero = bool((logits_k[~valid] == 0).all())
    # as the full-width decode steps: bf16 activations through 32 layers
    # round at the same points, and a step that tips one way carries
    # forward. The sequential decode steps also compute each candidate's
    # K/V in a batch of another shape. Bound: 5% of the logit range
    tol = 0.05 * ref_max
    log(f"[{tag}] full-width verify_step (S={n_slots}, C={c}), kernels vs plain: max|err| "
        f"{err:.4g} of {ref_max:.4g} (tol {tol:.4g}), argmax agreement {agree:.4f}; vs {c} "
        f"sequential decode steps: max|err| {seq_err:.4g} (tol {tol:.4g}), argmax agreement "
        f"{seq_agree:.4f}, equal on all {int(clear.sum())} clear of {int(valid.sum())}: "
        f"{clear_equal}; finite {finite}; invalid rows zero {zero}")
    if not finite or not zero or not err <= tol or not seq_err <= tol or not clear_equal:
        fail(f"[{tag}] full-width verify_step disagrees with its plain path or sequential decode")
    served_gaps = _gate_served(torch, engine, p, prompts, on_tokens, off_tokens, 2 * seq_err, tag,
                               "speculation on and off")

    verify_ms, verify_times = _host_ms(torch, verify)
    decode_ms, decode_times = _host_ms(torch, lambda i: llama.decode_step(
        engine.params, p, toks[:, 0], cache, torch.where(pos >= 0, pos + i, pos)))
    restore()
    with plain_calls() as plain:
        busy = profile_step(torch, verify, tag=tag, what="verify step")
    restore()
    multi_dev = None
    if busy:
        multi_dev = sum(ms for key, ms, _ in busy["rows"] if "attn_core_kernel" in key)
    log(f"[{tag}] plain-version calls in the profiled verify step: {plain or 'none'}; the "
        f"multi-candidate kernel's device time in it: "
        f"{'not measured' if multi_dev is None else f'{multi_dev:.3f} ms'}")
    if plain:
        fail(f"[{tag}] the profiled verify step ran a plain version")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] verify step (S={n_slots}, C={c}, L=512) median {verify_ms:.2f} ms, decode step "
        f"(S={n_slots}) median {decode_ms:.2f} ms (ratio {verify_ms / decode_ms:.3f}); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; card {smi_line}")
    mgr.shutdown()
    return dict(launches=launches, want=want, decode_steps=steps - verifies, verify_calls=verifies,
                prefill_calls=prefills, drafted=drafted, accepted=accepted,
                acceptance=acceptance, on_wall_s=on_wall, on_tok_s=on_tok_s, off_wall_s=off_wall,
                off_tok_s=off_tok_s, first_diff=diffs, served_gaps=served_gaps,
                on_tokens=on_tokens, off_tokens=off_tokens,
                full_verify_err=err, full_verify_seq_err=seq_err, full_verify_tol=tol,
                argmax_agreement=agree, seq_argmax_agreement=seq_agree, verify_ms=verify_ms,
                verify_times_ms=verify_times, decode_ms=decode_ms, decode_times_ms=decode_times,
                profile=busy, multi_device_ms=multi_dev, clear=int(clear.sum()),
                clear_equal=clear_equal, max_memory_allocated=peak)


def phase_spec_paged(torch, p, smi_line):
    """Speculation over paged KV: the paged slice's setting with
    speculation_tokens 8 (one host-drafted verify per iteration, through
    verify_step_paged, which attends in plain torch and launches no multi
    kernel); 8 concurrent greedy requests of the periodic prompt."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.ops import decode_attention, quant_matmul

    cfg = _paged_model_config(p)
    cfg["name"] = "llama2_7b_int4_paged_spec"
    cfg["generation"]["speculation_tokens"] = 8
    name = cfg["name"]
    mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
    mgr.load_model(name)
    backend = mgr.get_model(name).backend
    engine = backend.engine
    n_pages = engine.cache.n_pages
    prompts, new = [_periodic_prompt(p.vocab_size)] * 8, 64

    for mod in (quant_matmul, decode_attention):        # the paged speculative run starts here
        mod.launches = 0
    decode_attention.paged_launches = decode_attention.multi_launches = 0
    steps0, prefills0, verifies0 = engine.steps, engine.prefill_calls, engine.verify_calls
    tokens, wall = _serve_wave(backend, prompts, new, "spec-paged")
    launches = {"quant_matmul": quant_matmul.launches,
                "decode_attention": decode_attention.launches,
                "decode_attention_paged": decode_attention.paged_launches,
                "decode_attention_multi": decode_attention.multi_launches}
    steps = engine.steps - steps0
    prefills = engine.prefill_calls - prefills0
    verifies = engine.verify_calls - verifies0
    stats, back = _pages_back(engine, n_pages - 1)
    want = {"quant_matmul": (4 * p.n_layers + 1) * (steps + prefills),
            "decode_attention": 0,
            "decode_attention_paged": p.n_layers * (steps - verifies),
            "decode_attention_multi": 0}
    drafted, accepted = stats.get("spec_drafted", 0), stats.get("spec_accepted", 0)
    log(f"[spec-paged] 8 concurrent greedy requests, {new} tokens each: {wall:.2f} s, "
        f"{8 * new / wall:.1f} tok/s; verify calls {verifies}, decode steps {steps - verifies}, "
        f"prefill calls {prefills}; drafted {drafted}, accepted {accepted}; launches {launches} "
        f"(expected {want}); pages free {stats['kv_free_pages']} + cached "
        f"{stats.get('prefix_cached_blocks', 0)} of {n_pages - 1}; speculation disabled "
        f"{engine._spec_disabled}")
    if drafted <= 0 or verifies < 1:
        fail("[spec-paged] no token was drafted")
    if engine._spec_disabled:
        fail("[spec-paged] a verify dispatch failed and disabled speculation")
    if launches != want:
        fail("[spec-paged] kernel launch counts do not match the path's calls")
    if back != n_pages - 1:
        fail(f"[spec-paged] {back} of {n_pages - 1} pages came back after retirement")
    mgr.shutdown()
    return dict(launches=launches, want=want, decode_steps=steps - verifies,
                verify_calls=verifies, prefill_calls=prefills, drafted=drafted,
                accepted=accepted, wall_s=wall, stats=stats, tokens=tokens)


def attn_mode(mode):
    """TPUSERVE_DECODE_ATTN set to `mode` (None: unset), restored after."""
    return env_set("TPUSERVE_DECODE_ATTN", mode)


def unpack_mode(mode):
    """TPUSERVE_INT4_UNPACK set to `mode` (None: unset), restored after."""
    return env_set("TPUSERVE_INT4_UNPACK", mode)


@contextlib.contextmanager
def env_set(key, mode):
    """The environment variable `key` set to `mode` (None: unset), restored
    after."""
    saved = os.environ.get(key)
    if mode is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved


def phase_grouped(torch, timer, p, smi_line, tag="grouped", kv_cache="int4"):
    """The slice's configuration (Llama-2-7B widths, int4 g128 weights,
    packed int4 KV, 64 slots, L=256, decode_horizon 8) served with
    TPUSERVE_DECODE_ATTN=grouped, loaded after the earlier engines are shut
    down: every decode step's attention goes through the grouped Hopper
    kernel, which reads the packed int4 window in place; the profiled step
    must hold no plain unpack and no plain version. `kv_cache` "none" (the
    [grouped-bf16] phase): the JAX package's default bf16 cache, its window
    read by the kernel's bf16 route. The same requests are then served under
    pallas on the same engine, and the full-width step's greedy tokens under
    grouped and pallas must be equal on every slot whose top two logits are
    apart."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import decode_attention, quant_matmul

    cfg = _model_config(p)
    cfg["quantization"]["kv_cache"] = kv_cache
    cfg["name"] = name = f"llama2_7b_{tag.replace('-', '_')}"
    with attn_mode("grouped"):
        torch.cuda.reset_peak_memory_stats()
        mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
        mgr.load_model(name)
        backend = mgr.get_model(name).backend
        engine = backend.engine
        rng = torch.Generator().manual_seed(17)
        prompts = [torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()
                   for n in (5, 200, 33, 90, 17, 12, 150, 64)]
        backend.generate(prompts[0], max_new_tokens=4)     # warm-up, outside the counted run
        for mod in (quant_matmul, decode_attention):       # the grouped path's run starts here
            mod.launches = 0
        decode_attention.grouped_launches = 0
        steps0, prefills0 = engine.steps, engine.prefill_calls
        tokens, wall = _serve_wave(backend, prompts, 24, tag)
        launches = {"quant_matmul": quant_matmul.launches,
                    "decode_attention": decode_attention.launches,
                    "decode_attention_grouped": decode_attention.grouped_launches}
        steps = engine.steps - steps0
        prefills = engine.prefill_calls - prefills0
        want = {"quant_matmul": (4 * p.n_layers + 1) * (steps + prefills),
                "decode_attention": 0, "decode_attention_grouped": p.n_layers * steps}
        tok_s = len(prompts) * 24 / wall
        log(f"[{tag}] {len(prompts)} concurrent greedy requests, 24 tokens each: {wall:.2f} s, "
            f"{tok_s:.1f} tok/s; decode steps {steps}, prefill calls {prefills}; launches "
            f"{launches} (expected {want}); card {smi_line}")
        if launches != want or steps < 1:
            fail(f"[{tag}] kernel launch counts do not match the path's calls")

        # one full-width decode step: 64 slots at positions 100-249 (slot 7
        # inactive), kernels vs plain versions, then under each mode on a copy
        # of the same cache
        cache = engine.cache
        g = torch.Generator(device=DEVICE)
        g.manual_seed(3)
        toks = torch.randint(0, p.vocab_size, (64,), generator=g, device=DEVICE)
        pos = step_positions(torch, g, 64)
        tensors = cache_tensors(cache)
        snapshot = [t.clone() for t in tensors]

        def restore():
            for dst, src in zip(tensors, snapshot):
                dst.copy_(src)

        def step(i=0):
            return llama.decode_step(engine.params, p, toks, cache, pos + i * (pos >= 0))[0]

        logits_k = step().float()
        restore()
        with plain_kernels(llama):
            logits_p = step().float()
        restore()
        by_mode = {"grouped": logits_k}
        for mode in ("pallas", "xla"):
            with attn_mode(mode):
                by_mode[mode] = step().float()
            restore()
        torch.cuda.synchronize()
        live = pos >= 0
        ref_max = logits_p.abs().max().item()
        err = (logits_k - logits_p).abs().max().item()
        agree = (logits_k.argmax(-1) == logits_p.argmax(-1))[live].float().mean().item()
        finite = all(bool(torch.isfinite(t).all()) for t in by_mode.values())
        # bf16 activations through 32 layers, as the slice's full-width step:
        # a rounding step that tips one way carries forward; 5% of the range.
        # The modes also differ in algorithm (the flat kernel requantizes P to
        # int8, grouped rounds it to bf16, xla runs bf16 einsums): same bound
        tol = 0.05 * ref_max
        modes = {}
        for mode in ("pallas", "xla"):
            d = (by_mode[mode] - logits_k).abs().max().item()
            a = (by_mode[mode].argmax(-1) == logits_k.argmax(-1))[live].float().mean().item()
            modes[mode] = dict(max_abs_diff=d, argmax_agreement=a)
        # greedy tokens under grouped and pallas, equal on every live slot
        # whose top two logits are further apart than twice the two modes'
        # difference
        top2 = by_mode["pallas"].topk(2, dim=-1).values
        clear = live & ((top2[:, 0] - top2[:, 1]) > 2 * modes["pallas"]["max_abs_diff"])
        same = by_mode["pallas"].argmax(-1) == logits_k.argmax(-1)
        modes["pallas"].update(clear=int(clear.sum()), clear_equal=bool(same[clear].all()))
        log(f"[{tag}] full-width decode step, kernels vs plain: max|err| {err:.4g} of "
            f"{ref_max:.4g} (tol {tol:.4g}); argmax agreement {agree:.4f}; finite {finite}")
        log(f"[{tag}] the same step under pallas / xla against grouped: max|diff| "
            f"{modes['pallas']['max_abs_diff']:.4g} / {modes['xla']['max_abs_diff']:.4g} (tol "
            f"{tol:.4g}); argmax agreement {modes['pallas']['argmax_agreement']:.4f} / "
            f"{modes['xla']['argmax_agreement']:.4f}")
        log(f"[{tag}] greedy tokens under grouped and pallas equal on all {int(clear.sum())} "
            f"live slots whose top two logits are more than 2x the modes' difference apart: "
            f"{modes['pallas']['clear_equal']}")
        if (not finite or not err <= tol or any(m["max_abs_diff"] > tol for m in modes.values())
                or not modes["pallas"]["clear_equal"]):
            fail(f"[{tag}] full-width decode step: the paths disagree")

        # the step reads the packed window in place: no plain unpack (counted
        # through both modules' names, and no unpack kernel in the profile)
        from tpuserve_torch.ops.decode_attention import unpack_kv_codes

        unpacks = []

        def counted(x):
            unpacks.append(1)
            return unpack_kv_codes(x)

        llama.unpack_kv_codes = decode_attention.unpack_kv_codes = counted
        try:
            step_ms, times = _host_ms(torch, step)
            restore()
            with plain_calls() as plain:
                busy = profile_step(torch, step, tag=tag)
            restore()
        finally:
            llama.unpack_kv_codes = decode_attention.unpack_kv_codes = unpack_kv_codes
        unpack_ops = [k for k in (busy or {}).get("names", [])
                      if "bitwiseand" in k.lower().replace("_", "") or "rshift" in k.lower()]
        log(f"[{tag}] plain unpack calls in the timed and profiled steps: {len(unpacks)}; "
            f"unpack kernels in the profile: {unpack_ops or 'none'}")
        log(f"[{tag}] plain-version calls in the profiled step: {plain or 'none'}")
        if unpacks or unpack_ops or plain:
            fail(f"[{tag}] the decode step unpacks the window or runs a plain version")
        unpack_ms, note = None, ""
        if cache.k.dtype == torch.uint8:
            # the unpack of the packed int4 window to int8 codes, K and V, that
            # the parent's step ran per layer: timed alone, rotated over the layers
            win = cache.max_len
            unpack_ms = timer.ms(lambda i: (unpack_kv_codes(cache.k[i % p.n_layers, :, :win]),
                                            unpack_kv_codes(cache.v[i % p.n_layers, :, :win])),
                                 20)
            note = (f"; the int4 -> int8 unpack the parent's step ran, alone: {unpack_ms:.4f} "
                    f"ms a layer, {p.n_layers * unpack_ms:.3f} ms a step")
        grouped_dev = None
        if busy:
            grouped_dev = sum(ms for key, ms, _ in busy["rows"] if "attn_grouped_kernel" in key)
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] decode step (64 slots, L=256, {p.n_layers} layers): median {step_ms:.2f} "
            f"ms -> {64 / step_ms * 1e3:.1f} tok/s at full batch; the grouped kernel's device "
            f"time in the profiled step "
            f"{'not measured' if grouped_dev is None else f'{grouped_dev:.3f} ms'}{note}; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; card {smi_line}")

        # the same requests under pallas on the same engine (the flat kernel)
        decode_attention.launches = 0
        with attn_mode("pallas"):
            pallas_tokens, pallas_wall = _serve_wave(backend, prompts, 24, f"{tag}-pallas")
        diffs = [_first_diff(a, b) for a, b in zip(tokens, pallas_tokens)]
        log(f"[{tag}] the same requests under pallas: {pallas_wall:.2f} s, flat-kernel launches "
            f"{decode_attention.launches}; first differing token per request, grouped vs "
            f"pallas (None = equal): {diffs}")
        served_gaps = _gate_served(torch, engine, p, prompts, tokens, pallas_tokens,
                                   2 * modes["pallas"]["max_abs_diff"], tag, "grouped and pallas")
        mgr.shutdown()
    return dict(launches=launches, want=want, decode_steps=steps, prefill_calls=prefills,
                wall_s=wall, tok_s=tok_s, tokens=tokens, full_step_err=err, full_step_tol=tol,
                argmax_agreement=agree, modes=modes, step_ms=step_ms, step_times_ms=times,
                profile=busy, plain_unpack_calls=len(unpacks), unpack_kernels=unpack_ops,
                parent_unpack_ms_per_layer=unpack_ms, grouped_device_ms=grouped_dev,
                pallas_tokens=pallas_tokens, pallas_first_diff=diffs, served_gaps=served_gaps,
                max_memory_allocated=peak)


def phase_sweep(torch):
    """The diagnostic ladder with every variant at its defaults, printed as
    the script prints it; the probes' and decode_attention_wide's launches
    are counted over this run."""
    from tpuserve_torch.ops import attention_probes as probes
    from tpuserve_torch.ops import decode_attention
    from tpuserve_torch.scripts import sweep_attention as sweep

    probes.dma_bound_launches = probes.dma_wide_launches = probes.dot_only_launches = 0
    decode_attention.wide_launches = 0
    with attn_mode(None):
        records = sweep.run(list(sweep.VARIANTS), sweep.shapes(), torch.device("cuda"))
    launches = {"probe_dma_bound": probes.dma_bound_launches,
                "probe_dma_wide": probes.dma_wide_launches,
                "probe_dot_only": probes.dot_only_launches,
                "decode_attention_wide": decode_attention.wide_launches}
    failed = [r["variant"] for r in records if "failed" in r]
    log(f"[sweep] {len(records)} variants, launches {launches}")
    if failed:
        fail(f"[sweep] variants failed: {failed}")
    if min(launches.values()) < 1:
        fail(f"[sweep] a kernel of the sweep was never launched: {launches}")
    return dict(records=records, launches=launches)


def _unpack_unit(probe_name):
    """The kernels line's name of an unpack probe variant."""
    return probe_name if probe_name.startswith("unpack") else f"unpack_{probe_name}"


def insitu_cases(torch, p):
    """The three packed-int4 decode-attention kernels at their serving
    shapes, each as (name, call(fn, i) of fn on layer i, the kernel's
    wrapper, its plain version, the bytes a call reads):
    the flat kernel at the slice's step (S=64, L=256, step positions, bf16
    scales), the paged kernel over int4 pages (S=64, two pages of 128,
    shuffled, step positions, f32 scale pools) and the multi kernel at the
    [spec] phase's shape (S=8, C=9, L=512, positions 100-400, f32 scales);
    each over enough layers that the rotated reads exceed the L2."""
    from tpuserve_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    h, hkv, hd = p.n_heads, p.n_kv_heads, p.head_dim
    w2 = hkv * hd // 2

    def packed(*shape):
        return [torch.randint(0, 256, shape, generator=g, device="cuda",
                              dtype=torch.int32).to(torch.uint8) for _ in range(2)]

    def scales(*shape, dtype=torch.float32):
        return [((torch.rand(shape, generator=g, device="cuda") + 0.5) * 0.01).to(dtype)
                for _ in range(2)]

    def layers(live):      # live rows of K and V, packed, with their f32/bf16 scales
        return max(2, math.ceil(L2_FLUSH_BYTES / (2 * live * (w2 + 4 * hkv))))

    cases = []
    s, l = 64, 256
    pos = step_positions(torch, g, s)
    live = int((pos + 1).clamp(min=0).sum().item())
    n_l = layers(live)
    kv, sc = packed(n_l, s, l, w2), scales(n_l, s, hkv, l, dtype=torch.bfloat16)
    q = (torch.randn((s, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
    cases.append(("flat", lambda fn, i: fn(q, *kv, sc[0][i % n_l], sc[1][i % n_l], pos, i % n_l),
                  da.decode_attention_wide_cache, da.decode_attention_wide_cache_plain,
                  2 * live * (w2 + 2 * hkv)))
    ps = 128
    n_pages = s * (l // ps) + 1
    table = (1 + torch.randperm(n_pages - 1, generator=g, device="cuda")).view(s, l // ps).to(
        torch.int32)
    pk, pks = packed(n_l, n_pages, ps, w2), scales(n_l, n_pages, (hkv + 7) // 8 * 8, ps)
    cases.append(("paged", lambda fn, i: fn(q, *pk, *pks, table, pos, i % n_l),
                  da.decode_attention_wide_paged, da.decode_attention_wide_paged_plain,
                  2 * live * (w2 + 4 * hkv)))
    sm, c, lm = 8, 9, 512
    pos_m = torch.randint(100, 401, (sm,), generator=g, device="cuda", dtype=torch.int32)
    live_m = int((pos_m + c).sum().item())
    n_m = layers(live_m)
    mkv, msc = packed(n_m, sm, lm, w2), scales(n_m, sm, hkv, lm)
    qm = (torch.randn((sm, c, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
    cases.append(("multi", lambda fn, i: fn(qm, *mkv, msc[0][i % n_m], msc[1][i % n_m], pos_m,
                                            i % n_m, window=lm),
                  da.decode_attention_wide_cache_multi, da.decode_attention_wide_cache_multi_plain,
                  2 * live_m * (w2 + 4 * hkv)))
    return cases


def phase_unpack(torch, timer, reps, p, smi_line):
    """The unpack microbenchmark at its defaults (its kernels' launches are
    counted over this run), then the unpack in place: each packed-int4
    decode-attention kernel timed under TPUSERVE_INT4_UNPACK=cur and =noop
    in turns (cur, noop, noop, cur), per layer, with noop's output held
    against noop's plain version."""
    from tpuserve_torch.ops import unpack_probes as up
    from tpuserve_torch.scripts import unpack_microbench as ub

    for name in up.launches:
        up.launches[name] = 0
    records = ub.run(list(ub.KERNELS), ub.dims(), torch.device("cuda"))
    launches = {_unpack_unit(n): c for n, c in up.launches.items()}
    failed = [r["variant"] for r in records if "failed" in r]
    log(f"[unpack] microbenchmark: {len(records)} variants, launches {launches}")
    if failed:
        fail(f"[unpack] variants failed: {failed}")
    if min(launches.values()) < 1:
        fail(f"[unpack] a kernel of the microbenchmark was never launched: {launches}")

    insitu = {}
    for name, call, kern, plain, nbytes in insitu_cases(torch, p):
        with unpack_mode("noop"):
            out, ref = call(kern, 1), call(plain, 1)
        with unpack_mode("cur"):
            out_cur = call(kern, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 2e-3 * ref.abs().max().item() + 1e-6  # the decode-attention kernels' tolerance
        moved = (out - out_cur).abs().max().item()
        if not err <= tol:
            fail(f"[unpack] {name} kernel under noop: max|err| {err} against its plain version "
                 f"> {tol}")
        if not moved > 0:
            fail(f"[unpack] {name} kernel: noop gave the unpacked result")
        turns = []
        for mode in ("cur", "noop", "noop", "cur"):
            with unpack_mode(mode):
                turns.append((mode, timer.ms(lambda i: call(kern, i), reps)))
        cur = [t for m, t in turns if m == "cur"]
        noop = [t for m, t in turns if m == "noop"]
        cur_ms, noop_ms = sum(cur) / 2, sum(noop) / 2
        tax = 1 - noop_ms / cur_ms
        cur_gb_s, noop_gb_s = nbytes / cur_ms / 1e6, nbytes / noop_ms / 1e6
        insitu[name] = dict(turns=turns, cur_ms=cur_ms, noop_ms=noop_ms, tax=tax, noop_err=err,
                            noop_tol=tol, cur_gb_s=cur_gb_s, noop_gb_s=noop_gb_s)
        log(f"[unpack] in place, {name} kernel (packed int4) per layer: cur "
            f"{' / '.join(f'{t:.4f}' for t in cur)} ms, noop "
            f"{' / '.join(f'{t:.4f}' for t in noop)} ms; the unpack's share {100 * tax:.1f}% "
            f"({cur_gb_s:.1f} -> {noop_gb_s:.1f} GB/s); noop vs its plain version max|err| "
            f"{err:.3g} (tol {tol:.3g}); card {smi_line}")
    torch.cuda.empty_cache()
    return dict(records=records, launches=launches, insitu=insitu)


def phase_diag_bw(torch):
    """diag_bw with every mode at its defaults (the copy kernel's launches
    are counted over this run), then the copy forms at block_l 64 and 16:
    what the block size does to the stream."""
    from tpuserve_torch.ops import attention_probes as probes
    from tpuserve_torch.scripts import diag_bw

    d = dict(S=64, L=256, N_KV=32, HD=128, G=16, BLOCK_L=256, ITERS=30)
    probes.diag_copy_launches = 0
    records = diag_bw.run(list(diag_bw.MODES), d, torch.device("cuda"))
    launches = probes.diag_copy_launches
    for block_l in (64, 16):
        records += diag_bw.run(list(probes.COPY_MODES), dict(d, BLOCK_L=block_l),
                               torch.device("cuda"))
    failed = [(r["mode"], r.get("block_l")) for r in records if "failed" in r]
    log(f"[diag_bw] {len(records)} runs, diag_copy launches {launches} at the defaults")
    if failed:
        fail(f"[diag_bw] modes failed: {failed}")
    if launches < 1:
        fail("[diag_bw] the copy kernel was never launched")
    return dict(records=records, launches=launches)


def phase_qmm_sweep(torch):
    """The quant-matmul sweep (tpuserve_torch.scripts.qmatmul_sweep) at its
    defaults: 32 chained [64, 4096] x [4096, 4096] matmuls a CUDA graph, the
    kernel at its own split and at block_k 256/512/1024, int8, and the
    dequantize-then-matmul control. Its weights sit in the L2."""
    from tpuserve_torch.scripts import qmatmul_sweep

    records = qmatmul_sweep.run(torch.device("cuda"), 64, 5, 32)
    failed = [r["mode"] for r in records if "failed" in r]
    log(f"[qmm_sweep] {len(records)} modes; " + ", ".join(
        f"{r['mode']} {r['us']:.1f} us" for r in records if "failed" not in r))
    if failed:
        fail(f"[qmm_sweep] modes failed: {failed}")
    return dict(records=records)


def phase_moe_ab(torch):
    """The MoE decode FFN's dense loop against the dispatch
    (tpuserve_torch.scripts.ab_moe_decode) at its defaults, Mixtral-8x7B's
    FFN at batch sizes 8 and 64: f32 h as the JAX script runs it, then bf16
    h, the served activations. A diagnostic: the engine's threshold stays
    the JAX package's."""
    from tpuserve_torch.scripts import ab_moe_decode

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        records[str(dtype).replace("torch.", "")] = ab_moe_decode.run(
            torch.device("cuda"), dict(ab_moe_decode.settings(), dtype=dtype))
    failed = [(d, r["bs"]) for d, rs in records.items() for r in rs if "failed" in r]
    log("[moe_ab] " + "; ".join(f"{d} bs{r['bs']}: dense {r['dense_ms']:.3f} ms, dispatch "
                                f"{r['dispatch_ms']:.3f} ms ({r['ratio']:.3f}x)"
                                for d, rs in records.items() for r in rs if "failed" not in r))
    if failed:
        fail(f"[moe_ab] runs failed: {failed}")
    return records


def main() -> None:
    import torch

    name, count, smi_line = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpuserve_torch.models.llama import LlamaParams

    p = LlamaParams.llama2_7b()
    p_moe = LlamaParams.mixtral_8x7b()
    t0 = time.monotonic()
    build = phase_build()
    timer = Timer(torch)
    results = phase_kernels(torch, timer, 20, p, p_moe)
    slice_res = phase_slice(torch, p, smi_line)
    for name_, launched in slice_res["launches"].items():
        results[{"smoke": "vector_add"}.get(name_, name_)]["launches"] = launched
    # the MoE path: the quant-matmul on expert views and the flat core at
    # GQA rep 4, each counted over the [mixtral] run
    mixtral_res = phase_mixtral(torch, p_moe, smi_line)
    results["quant_matmul_experts"]["launches"] = mixtral_res["launches"]["quant_matmul"]
    results["decode_attention_gqa"]["launches"] = mixtral_res["launches"]["decode_attention"]
    # the slice's path with int8 activations, then with groups a 64-row
    # stage cannot tile: each route's launches are that run's
    w4a8_res = phase_quant_route(torch, p, smi_line, "w4a8", {"activations": "int8"},
                                 {"w4a8_launches": 4 * p.n_layers + 1})
    results["quant_matmul_w4a8"] = dict(results["quant_matmul"]["w4a8"],
                                        launches=w4a8_res["launches"]["w4a8_launches"])
    results["quantize_rows"]["launches"] = w4a8_res["launches"]["quantize_launches"]
    odd_res = phase_quant_route(torch, p, smi_line, "odd", {"group_size": 688},
                                {"odd_group_launches": p.n_layers})
    results["quant_matmul_odd_groups"] = dict(results["quant_matmul"]["odd"],
                                              launches=odd_res["launches"]["odd_group_launches"])
    # w_down in groups of 344 (11008 / 32), the rest per channel: masked
    # k16 steps with bf16 x, masked k32 steps with int8 x
    g344_res = phase_quant_route(torch, p, smi_line, "g344", {"group_size": 344},
                                 {"group_route_launches": p.n_layers})
    results["quant_matmul_group_route"] = dict(
        results["quant_matmul"]["group_route"],
        launches=g344_res["launches"]["group_route_launches"])
    results["stage_x"]["launches"] = g344_res["launches"]["stage_launches"]
    w4a8_g344_res = phase_quant_route(
        torch, p, smi_line, "w4a8-g344", {"group_size": 344, "activations": "int8"},
        {"w4a8_launches": 3 * p.n_layers + 1, "w4a8_route_launches": p.n_layers})
    results["quant_matmul_w4a8_route"] = dict(
        results["quant_matmul"]["w4a8_route"],
        launches=w4a8_g344_res["launches"]["w4a8_route_launches"])
    paged_res = phase_paged_slice(torch, p, smi_line)
    # the paged kernel runs on the paged path only: its count is that run's
    results["decode_attention_paged"]["launches"] = \
        paged_res["launches"]["decode_attention_paged"]
    spec_res = phase_spec(torch, p, smi_line)
    # the multi kernel runs on the speculative path only: its count is that run's
    results["decode_attention_multi"]["launches"] = spec_res["launches"]["decode_attention_multi"]
    # the JAX package's default cache (kv_cache none, bf16): the multi
    # kernel's float route, counted over that run
    spec_bf16_res = phase_spec(torch, p, smi_line, tag="spec-bf16", kv_cache="none")
    results["decode_attention_multi_float"] = dict(
        results["decode_attention_multi"]["float"],
        launches=spec_bf16_res["launches"]["decode_attention_multi"])
    spec_paged_res = phase_spec_paged(torch, p, smi_line)
    grouped_res = phase_grouped(torch, timer, p, smi_line)
    # the grouped kernel runs on the grouped path only: its count is that run's
    results["decode_attention_grouped"]["launches"] = \
        grouped_res["launches"]["decode_attention_grouped"]
    grouped_bf16_res = phase_grouped(torch, timer, p, smi_line, tag="grouped-bf16",
                                     kv_cache="none")
    results["decode_attention_grouped_float"] = dict(
        results["decode_attention_grouped"]["float"],
        launches=grouped_bf16_res["launches"]["decode_attention_grouped"])
    sweep_res = phase_sweep(torch)
    # the probes and the prebuilt-Q_wide entry run in the sweep only
    for kname, launched in sweep_res["launches"].items():
        results[kname]["launches"] = launched
    unpack_res = phase_unpack(torch, timer, 20, p, smi_line)
    # the unpack probes run in the microbenchmark only, the copy kernel in diag_bw
    for kname, launched in unpack_res["launches"].items():
        results[kname]["launches"] = launched
    diag_res = phase_diag_bw(torch)
    results["diag_copy"]["launches"] = diag_res["launches"]
    qmm_sweep_res = phase_qmm_sweep(torch)
    moe_ab_res = phase_moe_ab(torch)
    sources = {"vector_add": ("tpuserve_torch/csrc/vector_add.cu",
                              "tpuserve/device/smoke.py:21"),
               "quant_matmul": ("tpuserve_torch/csrc/quant_matmul.cu",
                                "tpuserve/ops/quant_matmul.py:40"),
               "quant_matmul_experts": ("tpuserve_torch/csrc/quant_matmul.cu",
                                        "tpuserve/ops/quant_matmul.py:40 (_kernel, on "
                                        "QExperts.expert views, tpuserve/quant/core.py:299)"),
               "quant_matmul_w4a8": ("tpuserve_torch/csrc/quant_matmul.cu",
                                     "tpuserve/ops/quant_matmul.py:40 (_kernel, act_int8 "
                                     "branch :65-83)"),
               "quant_matmul_odd_groups": ("tpuserve_torch/csrc/quant_matmul.cu",
                                           "tpuserve/ops/quant_matmul.py:40 (_kernel, int4 and "
                                           "int8 branches :84-110)"),
               "quant_matmul_group_route": ("tpuserve_torch/csrc/quant_matmul.cu",
                                            "tpuserve/ops/quant_matmul.py:40 (_kernel, int4 and "
                                            "int8 branches :84-110)"),
               "quant_matmul_w4a8_route": ("tpuserve_torch/csrc/quant_matmul.cu",
                                           "tpuserve/ops/quant_matmul.py:40 (_kernel, act_int8 "
                                           "branch :65-83)"),
               "stage_x": ("tpuserve_torch/csrc/quant_matmul.cu",
                           "tpuserve/ops/quant_matmul.py:40 (x read through _kernel's BlockSpec; "
                           "no Pallas kernel of its own)"),
               "quantize_rows": ("tpuserve_torch/csrc/quant_matmul.cu",
                                 "tpuserve/quant/core.py:166 (quantize_activation, left to XLA "
                                 "there: no Pallas kernel)"),
               "decode_attention": ("tpuserve_torch/csrc/decode_attention_hopper.cu",
                                    "tpuserve/ops/decode_attention.py:160 (_wide_kernel; "
                                    ":495 _packed_kernel)"),
               "decode_attention_gqa": ("tpuserve_torch/csrc/decode_attention_hopper.cu",
                                        "tpuserve/ops/decode_attention.py:160 (_wide_kernel, "
                                        "GQA rep 4: nq 8 packed int4)"),
               "decode_attention_paged": (
                   "tpuserve_torch/csrc/decode_attention_hopper.cu",
                   "tpuserve/ops/decode_attention.py:160 (_wide_kernel, paged_sc; call :1217)"),
               "decode_attention_multi": (
                   "tpuserve_torch/csrc/decode_attention_hopper.cu",
                   "tpuserve/ops/decode_attention.py:804 (_wide_multi_kernel; call :1052)"),
               "decode_attention_multi_float": (
                   "tpuserve_torch/csrc/decode_attention_hopper.cu",
                   "tpuserve/ops/decode_attention.py:804 (_wide_multi_kernel, float cache; "
                   "call :1052)"),
               "decode_attention_grouped": (
                   "tpuserve_torch/csrc/decode_attention_grouped_hopper.cu",
                   "tpuserve/ops/decode_attention.py:1237 (_kernel; call :1423)"),
               "decode_attention_grouped_float": (
                   "tpuserve_torch/csrc/decode_attention_grouped_hopper.cu",
                   "tpuserve/ops/decode_attention.py:1237 (_kernel, float window; call :1423)"),
               "decode_attention_wide": (
                   "tpuserve_torch/csrc/decode_attention_hopper.cu",
                   "tpuserve/ops/decode_attention.py:160 (_wide_kernel, prebuilt Q_wide; "
                   "call :477)"),
               "probe_dma_bound": ("tpuserve_torch/csrc/attention_probes.cu",
                                   "scripts/sweep_attention.py:99 (dma_bound.kern; call :104)"),
               "probe_dma_wide": ("tpuserve_torch/csrc/attention_probes.cu",
                                  "scripts/sweep_attention.py:137,159 (dma_wide.kern; calls "
                                  ":142, :164)"),
               "probe_dot_only": ("tpuserve_torch/csrc/attention_probes.cu",
                                  "scripts/sweep_attention.py:193 (dot_only.kern; call :218)"),
               "unpack_stream_raw": ("tpuserve_torch/csrc/unpack_probes.cu",
                                     "scripts/unpack_microbench.py:52 (_k_stream_raw; call :153)"),
               "unpack_dot_raw": ("tpuserve_torch/csrc/unpack_probes.cu",
                                  "scripts/unpack_microbench.py:62 (_k_dot_raw; call :153)"),
               "unpack_cur": ("tpuserve_torch/csrc/unpack_probes.cu",
                              "scripts/unpack_microbench.py:75 (_k_unpack_cur; call :153)"),
               "unpack_hi": ("tpuserve_torch/csrc/unpack_probes.cu",
                             "scripts/unpack_microbench.py:95 (_k_unpack_hi; call :153)"),
               "unpack_i8": ("tpuserve_torch/csrc/unpack_probes.cu",
                             "scripts/unpack_microbench.py:119 (_k_unpack_i8; call :153)"),
               "diag_copy": ("tpuserve_torch/csrc/attention_probes.cu",
                             "scripts/diag_bw.py:78 (copy_kernel; calls :137, :165, :201)")}
    line = []
    for kname in sources:
        r = results[kname]
        line.append({"name": kname, "route": "cuda", "source": sources[kname][0],
                     "replaces": sources[kname][1], "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "per": r["per"]})
        if kname == "quant_matmul":   # route launches of the kernel check
            line[-1]["route_launches"] = r["route_launches"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi_line, "build_s": build.seconds,
                   "build_log": build.log, "kernels": results, "slice": slice_res,
                   "paged_slice": paged_res, "spec": spec_res, "spec_bf16": spec_bf16_res,
                   "spec_paged": spec_paged_res, "grouped": grouped_res,
                   "grouped_bf16": grouped_bf16_res, "w4a8": w4a8_res, "odd": odd_res,
                   "g344": g344_res, "w4a8_g344": w4a8_g344_res, "mixtral": mixtral_res,
                   "moe_ab": moe_ab_res,
                   "sweep": sweep_res, "unpack": unpack_res,
                   "diag_bw": diag_res, "qmm_sweep": qmm_sweep_res,
                   "seconds": time.monotonic() - t0}, fh, indent=1,
                  default=str)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
