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
  4a. rest   the same model through the port's front: create_app(device=
              "cuda") on 127.0.0.1 from a background event loop, the model
              (with `input_ids` declared and a WordLevel tokenizer.json)
              loaded over REST, 16 concurrent /generate requests of the
              slice's job mix in fresh launch counters (launches exact, no
              plain version), greedy tokens equal to backend.generate's on
              the same engine (waves A B B A, tokens/s each), streams
              (tokens equal, time to first token), text, /infer, /metrics, a
              profile capture holding the served kernels, auth, gRPC on the
              same manager (where google.protobuf is importable) and an
              unload that returns the card's memory; then `python -m
              tpuserve_torch.server` in a subprocess: /health, load, the
              soak, greedy tokens equal to the in-process server's, SIGINT;
  4b. w4a8  the slice's configuration with activations int8 (random bf16
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
  4f1. tp    the slice's model (full depth, packed int4 KV packed per
              shard) at tensor_parallel 2, served by two `python -m
              tpuserve_torch.server` processes joined by TPUSERVE_COORDINATOR
              / NUM_PROCESSES / PROCESS_ID on the one card (gloo): a load and
              4 concurrent greedy requests over REST; every rank's
              quant-matmul and flat-core launches at the shard shapes
              (wqkv 4096x6144, wo 2048x4096, w_gateup 4096x11008, w_down
              5504x4096, lm_head 4096x16000; the core on 16 kv heads), no
              plain version; each rank's decode step host clock and device
              span; SIGINT ends both; the one-rank engine's greedy tokens on
              the same weights (tokens may part only on a near tie);
  4f2. dp-sp the slice's widths at 8 layers, int8 KV on the 5D cache,
              data_parallel 2 x sequence_parallel 2: four ranks the engine
              starts itself, prompts of 160 and 200 tokens over both sp
              halves, the same checks (no flat core: the sp merge);
  4f3. mixtral-tp  the Mixtral-8x7B-width MoE at 4 layers, tensor_parallel
              2, int8 KV: each rank launches only its 4 experts' views, the
              same checks (the one-rank engine in the dense expert loop);
  4f4. mqa-tp  after the pipeline and speculation phases: Gemma-2B's
              widths (one kv head of 256) at 8 layers and tensor_parallel
              2, which does not divide the kv heads: every rank holds
              every kv head and attends by einsum, no attention kernel;
              contiguous (4 greedy requests) and paged with prefix sharing
              and 4 drafts, the quant-matmul's launches exact at the shard
              shapes, each shard shape against its plain version, tokens
              against the one-rank engine under TPUSERVE_DECODE_ATTN=xla,
              load peaks, a profiled decode step, every rank's cache the
              whole cache and the replicas byte-equal;
  4g. gptq   calibrated quantization: the slice's configuration at
              Llama-2-7B widths cut to 4 layers, init random (bf16 weights
              from a seed), int4 g128 with method gptq and
              lowrank_correction 16 (models/llm_demo's settings), synthetic
              calibration (16 x 128 tokens), loaded through
              InferenceManager: each layer's collection, GPTQ and LoRC
              seconds; the calibration pass's f32-x quant-matmuls (4 a
              layer, counted; held against the plain version at 2048
              rows); on every calibrated weight GPTQ's tr(E^T H E) at most
              RTN's and LoRC's residual at most GPTQ's; layer 0's wo again
              on the CPU (codes equal in >= 99.9%); 4 concurrent greedy
              requests (every route counter exact, no plain version); a
              full-width decode step against the plain versions; profiled
              decode steps with and without the LoRC factors;
  4h. llm_demo  the repository's models/llm_demo (GPTQ + LoRC 16, int4
              KV, speculation 4) loaded from models/ through the port's
              in-process REST front on the card: greedy /generate tokens
              equal backend.generate's, no plain version;
  4i. zoo    the model zoo, the ONNX importer, micro-batching and
              TorchScript: BERT-base (B 8, L 128, rows of the attention
              mask padded), DenseNet-121 and ResNet-50 (224x224, B 8) at
              the JAX package's widths, int8 g128, weights from the port's
              Architecture.init on a seeded generator: one forward through
              the kernels (74, 1 and 1 quant-matmul launches, no plain
              call) against the same forward on the plain versions; BERT's
              host-clock and profiled forward and the quant-matmul's share,
              images/s, the per-call N pad of the N % 16 != 0 heads, and
              row 1b (int8, bf16 x) at BERT's shapes and 1024 rows beside
              torch.matmul and the bound; then through the port's REST
              front in-process: a copy of models/densenet_tpu (params.npz
              written in the phase; top-5 with labels.txt names), the
              repository's models/test_model (safetensors) and the ONNX
              fixture (each within 1e-5 of reference_mlp_forward), a
              TorchScript model.pt (its output computed on the card),
              BERT-base over gRPC's Infer (74 launches); micro-batching: 16
              concurrent one-image requests over gRPC with dynamic_batching
              on (fewer forwards than requests, each response equal to its
              solo result and nearer it than any other image's) and off,
              requests/s of 6 waves a side (A B B A x 3), the same wave over
              REST as a record; the front's launches exactly 74 + one a
              DenseNet forward; eval_accuracy's classifier branch on
              BERT-base (74 f32-x quant-matmuls);
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
Right after the kernel phase, kernel-grid: scripts/kernel_smoke_tpu.py's
grid (tpuserve_torch.scripts.kernel_smoke): the flat, multi (C = 4),
paged, wide and grouped entries x Hkv {1, 2, 4, 8, 32} x rep {1, 4} x hd
{128, 256} over int8 (f32 and bf16 scales), bf16 and packed int4, plus
rep 3, 7 and 8 at Hkv 8 over every cache: a PASS/FAIL line each, every
one held to its plain version. Before the native phase: hd256, Gemma-7B's
attention geometry (16 query and 16 kv heads of head_dim 256) on
Llama-2-7B's other widths at 8 layers, and gqa8, Llama-2-70B's widths (64
heads over 8 kv heads, d_model 8192, ffn 28672) at 4 layers: int4 g128
weights, packed int4 KV, speculation 4 through InferenceManager (the flat
and multi cores' launches exact, no plain call), full-width decode_step
(also under TPUSERVE_DECODE_ATTN=grouped) and verify_step against the
plain versions, then paged (hd256 an int8 pool, gqa8 packed int4 pages:
16 rows a block) with the paged core's launches exact and a full-width
decode_step_paged against the plain versions; each kernel at those head
shapes timed beside its bound, plain version and SDPA; then scripts: the
slice's spec_bench, spec_trace and verify_profile at short settings, and
a 2-layer HF-named checkpoint at Llama-2-7B widths converted by
convert_hf_llama, served and scored by eval_real_ppl --token-ids. The
spec phase also samples at top_k=1 (the greedy tokens, gated as on/off)
and at temperature 0.8 (completes), scripts/spec_tpu_check.py's checks.
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
split kernel bitwise its plain version) beside torch.matmul in f32 (the
route [gptq]'s calibration pass serves), and W8A8 (torch._int_mm on the
codes) beside torch._int_mm, as a record; the multi-candidate and grouped
kernels' int caches with the bf16 scales the engine serves and again
with f32 scales, the multi-candidate kernel also on bf16 and f32 caches
beside SDPA; the flat, multi and grouped (int8 and packed int4) kernels
under TPUSERVE_ATTN_DYNSKIP=0 against =1; and the [mixtral] path's shapes: the
quant-matmul on the expert views of stacked int4 experts (gate|up K 4096
x N 28672, down K 14336 x N 4096, at 8, 16, 32 and 64 rows) and the flat
core at GQA rep 4 (packed int4: 8 query heads a block; int8: 4).
The slice phase also runs one full-width decode step under
TPUSERVE_QMATMUL=xla against the kernel step. Then a `kernels` JSON line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.

    python3 chip_smoke.py                       # every phase; needs one card
    python3 chip_smoke.py --phases mqa_tp,kernel   # device, build and these

Imports torch and tpuserve_torch only (no JAX).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
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
        f"{info.seconds:.1f} s -> {info.path}; each source's nvcc done at "
        f"{info.source_seconds} s")
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
    """Records of two quant-matmul routes that no decode step serves.
    f32 x (served by [gptq]'s calibration pass, the kernels line's
    quant_matmul_f32) on qmm_wgmma_kernel as three bf16 pieces (split_x, then the
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
            fail(f"decode_attention{tag} {kind} S={ss} window={window}: max|err| {err} > {tol}")
        if not torch.all(out[pos < 0] == 0):
            fail(f"decode_attention{tag} {kind}: inactive slots are not zero")
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
                    f"hd={hd}, L=256" + (", every slot live at 100-249" if full_step else ""),
                cases=rows)


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


def check_decode_attention_paged(torch, timer, reps, p, tag="", main_kind="int8"):
    """The paged kernel at the paged slice's shapes (S=64, L=256 as two
    pages of 128, shuffled across the pool) against its plain version and
    against the flat kernel on the same KV laid out contiguously; the
    per-step line is the `main_kind` pool's case at random positions."""
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
            fail(f"decode_attention_paged{tag} {kind}: max|err| {err} > {tol}")
        # the flat kernel with block_l = ps runs the same blocks in the same
        # order over the same bytes: equal up to f32 rounding (expected 0)
        flat_err = (out - out_flat).abs().max().item()
        flat_tol = 1e-6
        if not flat_err <= flat_tol:
            fail(f"decode_attention_paged{tag} {kind}: differs from the flat kernel by {flat_err}")
        if not torch.all(out[pos < 0] == 0):
            fail(f"decode_attention_paged{tag} {kind}: inactive slots are not zero")
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
        if kind == main_kind and not at_step:       # the served pool
            main = row
        rows.append(row)
        log(f"[kernel] decode_attention_paged{tag} {kind} S={s} H={h} Hkv={hkv} ps={ps} L={l}"
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
                per=f"one decode step: {n_l} launches, "
                    f"{'packed int4' if main_kind == 'int4' else main_kind} pool, S=64, H={h}, "
                    f"Hkv={hkv}, hd={hd}, ps=128, L=256", cases=rows)


def check_decode_attention_multi(torch, timer, reps, p, tag="", c=9, main_kind="int8"):
    """The multi-candidate (speculative verify) kernel at the [spec] phase's
    shapes (S=8 slots, C=`c` candidates, L=512, p's heads, positions
    100-400; int8 and packed int4 caches with the bf16 scales the engine
    serves (kv_scale_dtype's default) and again with f32 scales, bf16 and
    f32 caches, each beside SDPA) against its plain version, and each
    candidate c against the flat kernel at positions + c on the same KV.
    The int8 case with bf16 scales is the [spec] phase's route, the bf16
    cache the [spec-bf16] phase's (the float multi entry of the kernels
    line). The per-step line is the `main_kind` cache's with bf16 scales at
    `c` candidates."""
    from tpuserve_torch.ops.decode_attention import (
        core_rows, decode_attention_wide_cache, decode_attention_wide_cache_multi,
        decode_attention_wide_cache_multi_plain)

    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    s, h, hkv, hd, l = 8, p.n_heads, p.n_kv_heads, p.head_dim, 512
    w = hkv * hd
    pos = torch.randint(100, 401, (s,), generator=g, device="cuda", dtype=torch.int32)
    pos_c = [pos + j for j in range(c)]
    live = int((pos + c).sum().item())          # KV rows the kernel reads, once each
    cand_rows = sum(int((pc + 1).sum().item()) for pc in pos_c)  # rows each candidate sees
    rows, main, main_f = [], None, None
    for kind, sdt in (("int8", torch.bfloat16), ("int8", torch.float32),
                      ("int4", torch.bfloat16), ("int4", torch.float32), ("bf16", None),
                      ("f32", None)):
        flt = kind in ("bf16", "f32")
        elem = {"int4": 0.5, "int8": 1, "bf16": 2, "f32": 4}[kind]
        sc_elem = 0 if flt else sdt.itemsize
        kv_live = 2 * live * w * elem + 2 * live * hkv * sc_elem
        n_layers = max(2, math.ceil(L2_FLUSH_BYTES / kv_live))
        # one junk block past the window keeps the flat side on its
        # L-blocked form at any width (a window that is the whole cache
        # takes the TPU's one-block form where win * W * 2 < 1 MiB, with
        # other P requant points), as the multi kernel always is
        shape = (n_layers, s, l + 128, w // 2 if kind == "int4" else w)
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
            sc = [((torch.rand((n_layers, s, hkv, l + 128), generator=g, device="cuda") + 0.5)
                   * 0.01).to(sdt) for _ in range(2)]
        q = (torch.randn((s, c, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
        q_c = [q[:, j].contiguous() for j in range(c)]
        name = kind if flt else f"{kind} {str(sdt)[6:]} scales"

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
            fail(f"decode_attention_multi{tag} {name}: max|err| {err} > {tol}")
        # every cache: candidate j runs the flat kernel's blocks (the same
        # core) over the same bytes with the same arithmetic, and blocks past
        # its horizon add nothing: equal up to f32 rounding (expected 0)
        flat_err = (out - out_flat).abs().max().item()
        flat_tol = 1e-6 * out_flat.abs().max().item() + 1e-7
        if not flat_err <= flat_tol:
            fail(f"decode_attention_multi{tag} {name}: differs from the flat kernel at "
                 f"positions + c by {flat_err} > {flat_tol}")
        # an inactive slot (positions -1): candidate 0 exactly 0
        pos_off = pos.clone()
        pos_off[1] = -1
        out_off = decode_attention_wide_cache_multi(q, kv[0], kv[1], *scales(1), pos_off, 1,
                                                    window=l)
        if not torch.all(out_off[1, 0] == 0):
            fail(f"decode_attention_multi{tag} {name}: an inactive slot's candidate 0 is not zero")
        ms = timer.ms(lambda i: call(decode_attention_wide_cache_multi, i), reps)
        flat_ms = timer.ms(call_flat, reps)
        plain_ms = timer.ms(lambda i: call(decode_attention_wide_cache_multi_plain, i),
                            max(2, reps // 5))
        nbytes = kv_live + q.numel() * 2 + q.numel() * 4 + s * 4
        ops = 2 * 2 * cand_rows * h * hd
        b_ms, b_by = bound(nbytes, ops, PEAK_OPS[kind if flt else "int8"])
        lib_ms = sdpa_ms(torch, timer, reps, q, kv[0][0, :, :l], kv[1][0, :, :l],
                         *(None if t is None else t[:, :, :l] for t in scales(0)), pos, kind)
        row = dict(kind=kind, scales=None if flt else str(sdt)[6:], S=s, C=c, H=h, Hkv=hkv,
                   L=l, live_rows=live, candidate_rows=cand_rows, layers_rotated=n_layers,
                   max_abs_err=err, tol=tol, flat_err=flat_err, flat_tol=flat_tol, ms=ms,
                   flat_ms=flat_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by)
        if kind == main_kind and sdt == torch.bfloat16:   # the served KV
            main = row
        if kind == "bf16":                      # the [spec-bf16] phase's KV
            main_f = row
        rows.append(row)
        log(f"[kernel] decode_attention_multi{tag} {name} S={s} C={c} H={h} Hkv={hkv} L={l}: "
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
        # a junk block past the window, as above
        kv = [torch.randint(*((0, 256) if kind == "int4" else (-127, 128)),
                            (n_layers, s1, l1 + 128, w // 2 if kind == "int4" else w), generator=g,
                            device="cuda", dtype=torch.int32).to(
                                torch.uint8 if kind == "int4" else torch.int8) for _ in range(2)]
        sc = [((torch.rand((n_layers, s1, hkv, l1 + 128), generator=g, device="cuda") + 0.5)
               * 0.01).to(torch.bfloat16) for _ in range(2)]
        q1 = (torch.randn((s1, 1, h, hd), generator=g, device="cuda") / hd ** 0.5).to(
            torch.bfloat16)
        q1_flat = q1[:, 0].contiguous()

        def one(i):
            li = i % n_layers
            return decode_attention_wide_cache_multi(q1, kv[0], kv[1], sc[0][li], sc[1][li],
                                                     pos1, li, window=l1)

        def flat1(i):
            li = i % n_layers
            return decode_attention_wide_cache(q1_flat, kv[0], kv[1], sc[0][li], sc[1][li],
                                               pos1, li, window=l1)

        c1_err = (one(1)[:, 0] - flat1(1)).abs().max().item()
        if not c1_err <= 1e-6:   # the same blocks in the same order: expected 0
            fail(f"decode_attention_multi{tag} C=1 {kind}: differs from the flat kernel by "
                 f"{c1_err}")
        c1_rows.append(dict(kind=kind, S=s1, C=1, L=l1, step_positions=True, flat_err=c1_err,
                            ms=timer.ms(one, reps), flat_ms=timer.ms(flat1, reps)))
        log(f"[kernel] decode_attention_multi{tag} C=1 {kind} S={s1} L={l1} step positions: vs "
            f"flat kernel {c1_err:.3g}; {c1_rows[-1]['ms']:.4f} ms, flat kernel "
            f"{c1_rows[-1]['flat_ms']:.4f} ms; {n_layers} layers rotated")
        del kv, sc, q1, q1_flat
        torch.cuda.empty_cache()
    n_l = p.n_layers
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows if r["kind"] in ("int8", "int4")),
                ms=n_l * main["ms"], plain_ms=n_l * main["plain_ms"],
                bound_ms=n_l * main["bound_ms"], bound_by=main["bound_by"],
                library_ms=n_l * main["library_ms"], flat_ms=n_l * main["flat_ms"],
                per=f"one verify step: {n_l} launches, "
                    f"{'packed int4' if main_kind == 'int4' else main_kind} KV with bf16 scales, "
                    f"S=8, C={c}, H={h}, Hkv={hkv}, hd={hd}, L=512, "
                    f"{core_rows(c, h // hkv * (2 if main_kind == 'int4' else 1))[0]} row groups",
                cases=rows + c1_rows,
                float=dict(max_abs_err=max(r["max_abs_err"] for r in rows
                                           if r["kind"] in ("bf16", "f32")),
                           ms=n_l * main_f["ms"], plain_ms=n_l * main_f["plain_ms"],
                           bound_ms=n_l * main_f["bound_ms"], bound_by=main_f["bound_by"],
                           library_ms=n_l * main_f["library_ms"],
                           flat_ms=n_l * main_f["flat_ms"],
                           per=f"one verify step: {n_l} launches, bf16 KV (kv_cache none), "
                               f"S=8, C={c}, H={h}, Hkv={hkv}, hd={hd}, L=512"))


def check_decode_attention_grouped(torch, timer, reps, p, tag=""):
    """The grouped kernel at the [grouped] phase's shapes (S=64, L=256,
    Llama-2-7B heads, step positions) and at a rep-4 shape (H=32, Hkv=8):
    the packed int4 route (the [grouped] path: the Hopper kernel reads the
    packed window), int8 (both with the bf16 scales the engine serves, and
    at Hkv 32 again with f32 scales), bf16 (the [grouped-bf16] path) and
    f32, with the
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
    h, hk, bf, f32 = p.n_heads, p.n_kv_heads, torch.bfloat16, torch.float32
    for kind, h, hkv, sdt in dict.fromkeys((
            ("int4", h, hk, bf), ("int4", h, hk, f32), ("int8", h, hk, bf), ("int8", h, hk, f32),
            ("bf16", h, hk, None), ("f32", h, hk, None),
            ("int4", h, 8, bf), ("int8", h, 8, bf), ("bf16", h, 8, None))):
        w = hkv * hd
        flt = kind in ("bf16", "f32")
        elem = {"int4": 0.5, "int8": 1, "bf16": 2, "f32": 4}[kind]
        # read-all (TPUSERVE_ATTN_DYNSKIP=0, the default here) reads every row;
        # the bound counts the live ones
        kv_live = 2 * live * w * elem + (0 if flt else 2 * live * hkv * sdt.itemsize)
        name = kind if flt else f"{kind} {str(sdt)[6:]} scales"
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
        if not flt:     # head-major, as the engine's cache
            sc = [((torch.rand((n_layers, s, hkv, l), generator=g, device="cuda") + 0.5)
                   * 0.01).to(sdt) for _ in range(2)]
        q = (torch.randn((s, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
        g_kvs = {"bf16": (None, 16 // (h // hkv), hkv), "f32": (None,)}.get(kind, (None, hkv))
        for g_kv in dict.fromkeys(g_kvs):
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
                fail(f"decode_attention_grouped{tag} {name} H={h} Hkv={hkv} g_kv={g_kv}: "
                     f"max|err| {err} > {tol}")
            if not torch.all(out[pos < 0] == 0):
                fail(f"decode_attention_grouped{tag}: inactive slots are not zero")
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
            row = dict(kind=kind, scales=None if flt else str(sdt)[6:], S=s, H=h, Hkv=hkv,
                       L=l, g_kv=g_kv or 1, live_rows=live, layers_rotated=n_layers,
                       max_abs_err=err, tol=tol, ms=ms, flat_ms=flat_ms,
                       unpack_then_int8_ms=unpack_ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            if hkv == p.n_kv_heads and g_kv is None and kind in ("int4", "bf16") \
                    and sdt in (None, torch.bfloat16):
                if kind == "int4":     # the [grouped] path
                    main = row
                else:                  # the [grouped-bf16] path
                    main_f = row
            rows.append(row)
            extra = "" if unpack_ms is None else f", unpack + int8 kernel {unpack_ms:.4f} ms"
            log(f"[kernel] decode_attention_grouped{tag} {name} S={s} H={h} Hkv={hkv} L={l} "
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
                per=f"one decode step: {n_l} launches, packed int4 window read in place, bf16 "
                    f"scales, S=64, H={p.n_heads}, Hkv={p.n_kv_heads}, hd={hd}, L=256, "
                    "TPUSERVE_ATTN_DYNSKIP=0", cases=rows,
                float=dict(max_abs_err=worst(("bf16", "f32")), ms=n_l * main_f["ms"],
                           plain_ms=n_l * main_f["plain_ms"], bound_ms=n_l * main_f["bound_ms"],
                           bound_by=main_f["bound_by"], library_ms=n_l * main_f["library_ms"],
                           flat_ms=n_l * main_f["flat_ms"],
                           per=f"one decode step: {n_l} launches, bf16 window (kv_cache none), "
                               f"S=64, H={p.n_heads}, Hkv={p.n_kv_heads}, hd={hd}, L=256, g_kv 1, "
                               "TPUSERVE_ATTN_DYNSKIP=0"))


def check_dynskip(torch, timer, reps, p):
    """TPUSERVE_ATTN_DYNSKIP=0 against =1 on the flat (packed int4 KV, the
    slice's step positions), multi-candidate (int8, the spec phase's S=8,
    C=9, L=512) and grouped (int8 window, and the packed int4 window of the
    grouped phase, at its shapes) kernels, with the bf16 scales the engine
    serves (multi and grouped int8 also with f32 scales): "0" reads and masks the blocks
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
    scm = {dt: [t.to(dt) for t in scm] for dt in (torch.bfloat16, torch.float32)}
    qm = (torch.randn((sm, cm, h, hd), generator=g, device="cuda") / hd ** 0.5).to(
        torch.bfloat16)

    def multi(i, dt=torch.bfloat16):
        li = i % nlm
        return decode_attention_wide_cache_multi(qm, kvm[0], kvm[1], scm[dt][0][li],
                                                 scm[dt][1][li], posm, li)

    nlg = layers(2 * s * l * w)
    kvg = [codes((nlg, s, l, w), False) for _ in range(2)]
    scg = [(torch.rand((nlg, s, hkv, l), generator=g, device="cuda") + 0.5) * 0.01
           for _ in range(2)]
    scg = {dt: [t.to(dt) for t in scg] for dt in (torch.bfloat16, torch.float32)}

    def grouped(i, dt=torch.bfloat16):
        li = i % nlg
        k4, v4 = (t[li].view(s, l, hkv, hd) for t in kvg)
        return decode_attention(q, k4, v4, scg[dt][0][li].transpose(1, 2),
                                scg[dt][1][li].transpose(1, 2), pos, block_l=l)

    def grouped4(i):
        li = i % nl
        return decode_attention_packed(q, kv4[0][li], kv4[1][li], sc4[0][li], sc4[1][li], pos,
                                       block_l=l)

    rows = []
    f32 = torch.float32
    for name, fn in (("flat int4 S=64 L=256", flat), ("multi int8 S=8 C=9 L=512", multi),
                     ("multi int8 f32 scales S=8 C=9 L=512", lambda i: multi(i, f32)),
                     ("grouped int8 S=64 L=256", grouped),
                     ("grouped int8 f32 scales S=64 L=256", lambda i: grouped(i, f32)),
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
def plain_kernels(module, names=("qmatmul", "decode_attention_wide_cache",
                                 "decode_attention_wide_paged", "decode_attention_wide_cache_multi",
                                 "decode_attention", "decode_attention_packed")):
    """Route a module's kernel calls (those it names) to their plain PyTorch
    versions for a reference run on the card, and restore them after. The
    served models' weights are int4, with bf16 or (W4A8) int8 activations,
    and the zoo's int8 with bf16 x, for which qmatmul is exactly
    quant_matmul."""
    from tpuserve_torch.ops.decode_attention import (decode_attention_packed_plain,
                                                     decode_attention_plain,
                                                     decode_attention_wide_cache_multi_plain,
                                                     decode_attention_wide_cache_plain,
                                                     decode_attention_wide_paged_plain)
    from tpuserve_torch.ops.quant_matmul import quant_matmul_plain

    plain = {"qmatmul": quant_matmul_plain,
             "decode_attention_wide_cache": decode_attention_wide_cache_plain,
             "decode_attention_wide_paged": decode_attention_wide_paged_plain,
             "decode_attention_wide_cache_multi": decode_attention_wide_cache_multi_plain,
             "decode_attention": decode_attention_plain,
             "decode_attention_packed": decode_attention_packed_plain}
    saved = [getattr(module, n) for n in names]
    for n in names:
        setattr(module, n, plain[n])
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(module, n, fn)


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


# ------------------------------------------------------------- the front
REST_MODEL = "llama2_7b_int4"


def _rest_repo(p) -> str:
    """The slice's configuration as a served model: `input_ids` [1, -1]
    INT32 declared as models/llm_demo declares it, and a tokenizers
    WordLevel tokenizer.json of p.vocab_size words ("w1" is id 1) with a
    Whitespace pre-tokenizer, built here."""
    from tokenizers import Tokenizer, models
    from tokenizers.pre_tokenizers import Whitespace

    cfg = dict(_model_config(p),
               inputs=[{"name": "input_ids", "shape": [1, -1], "data_type": "INT32"}],
               outputs=[{"name": "output_ids", "shape": [1, -1], "data_type": "INT32"}])
    tmp = _write_repo(cfg)
    vocab = {"<unk>": 0, **{f"w{i}": i for i in range(1, p.vocab_size)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(os.path.join(tmp, REST_MODEL, "1", "tokenizer.json"))
    return tmp


def _http(method, url, body=None, headers=None, timeout=600):
    """(status, JSON body) of one request over urllib; an HTTP error code is
    a status, not an exception."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _http_stream(url, body, timeout=600):
    """NDJSON chunks of one streamed /generate and the seconds to its first
    token chunk (host clock)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    t0, first, chunks = time.monotonic(), None, []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            if not line.strip():
                continue
            chunk = json.loads(line)
            if first is None and "token" in chunk:
                first = time.monotonic() - t0
            chunks.append(chunk)
    return chunks, first


@contextlib.contextmanager
def rest_server(app):
    """Serve an aiohttp app on 127.0.0.1, a free port, from a background
    thread's event loop (web.run_app installs signal handlers, so it runs on
    the main thread only); yields its URL. Cleanup runs the app's own
    (manager shutdown) and stops the loop."""
    import asyncio

    from aiohttp import web

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="rest-loop", daemon=True)
    thread.start()
    runner = web.AppRunner(app)

    async def start():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", 0).start()
        return runner.addresses[0][1]

    async def stop():
        await runner.cleanup()
        await loop.shutdown_default_executor()

    try:
        port = asyncio.run_coroutine_threadsafe(start(), loop).result(120)
        yield f"http://127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(stop(), loop).result(300)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()


def _rest_jobs(p):
    """The [slice] job mix twice over (16 requests): greedy and sampled, a
    200-token prompt (chunked at 64), stop ids with logprobs, a repeated
    greedy prompt."""
    import torch

    rng = torch.Generator().manual_seed(13)

    def prompt(n):
        return torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()

    jobs = []
    for _ in range(2):
        repeat = prompt(12)
        jobs += [
            dict(input_ids=prompt(5), max_new_tokens=24),
            dict(input_ids=prompt(200), max_new_tokens=16),
            dict(input_ids=prompt(33), max_new_tokens=20, temperature=0.8, top_p=0.9),
            dict(input_ids=prompt(90), max_new_tokens=12, temperature=0.8, top_p=0.9),
            dict(input_ids=prompt(17), max_new_tokens=32, logprobs=True),   # stop id below
            dict(input_ids=repeat, max_new_tokens=24),
            dict(input_ids=repeat, max_new_tokens=24),
            dict(input_ids=prompt(150), max_new_tokens=10, temperature=0.8, top_p=0.9),
        ]
    return jobs


def _wave(torch, jobs, call, tag):
    """Every job at once, a thread each, through `call(job) -> result dict`;
    fatal unless each returns its tokens. Returns (results, wall seconds)."""
    import concurrent.futures as cf

    t0 = time.monotonic()
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        futures = [ex.submit(call, job) for job in jobs]
        results = []
        for i, fut in enumerate(futures):
            try:
                results.append(fut.result(timeout=600))
            except Exception as e:  # recorded, then fatal
                fail(f"[rest] {tag} request {i}: {e}")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for i, (job, res) in enumerate(zip(jobs, results)):
        want = job["want"]
        if res.get("num_generated") != want:
            fail(f"[rest] {tag} request {i}: {res}, expected {want} tokens")
        stop = job.get("stop_token_ids")
        if stop:
            if res["finish_reason"] != "stop" or res["generated_ids"][-1] != stop[0]:
                fail(f"[rest] {tag} request {i}: stop id not honoured: {res['finish_reason']}")
            if len(res.get("logprobs", [])) != want:
                fail(f"[rest] {tag} request {i}: {len(res.get('logprobs', []))} logprobs")
    return results, wall


def _cli_server(tmp, url_tokens, greedy_job, smi_line):
    """`python -m tpuserve_torch.server --grpc-port` in a subprocess over the
    phase's repository: /health within a deadline, a load, the soak (LLM
    infer and generate), one greedy request equal to the in-process
    server's tokens, the gRPC front on the same manager, and SIGINT: exit 0
    within 30 s."""
    import re
    import signal
    import socket

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    grpc_port = free_port()
    args = [sys.executable, "-m", "tpuserve_torch.server", "--repository", tmp, "--host",
            "127.0.0.1", "--port", str(port), "--grpc-port", str(grpc_port)]
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUSERVE_")}
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "rest_cli_server.log")
    t_start = time.monotonic()
    with open(log_path, "w") as server_log:
        proc = subprocess.Popen(args, env=env, stdout=server_log, stderr=subprocess.STDOUT)
    try:
        deadline = t_start + 180
        while True:
            if proc.poll() is not None:
                fail(f"[rest] CLI server exited {proc.returncode} before answering; "
                     f"see {log_path}")
            try:
                if _http("GET", url + "/health", timeout=10)[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail(f"[rest] CLI server did not answer /health in 180 s; see {log_path}")
            time.sleep(0.5)
        t_up = time.monotonic() - t_start
        t0 = time.monotonic()
        status, body = _http("POST", f"{url}/models/{REST_MODEL}/load")
        load_s = time.monotonic() - t0
        if status != 202:
            fail(f"[rest] CLI load answered {status}: {body}")
        soak = subprocess.run(
            [sys.executable, "-m", "tpuserve_torch.scripts.soak", "--url", url,
             "--infer-model", REST_MODEL, "--llm-model", REST_MODEL, "--threads", "8",
             "--requests", "4"], env=env, capture_output=True, text=True, timeout=600)
        log("[rest] CLI soak: " + " | ".join(soak.stdout.strip().splitlines()[:6]))
        if soak.returncode != 0:
            fail(f"[rest] the soak exited {soak.returncode}: {soak.stdout} {soak.stderr[-2000:]}")
        m = re.search(r"soak: (\d+) ok in (\d+)s .*, (\d+) errors", soak.stdout)
        if not m:
            fail(f"[rest] soak output not understood: {soak.stdout}")
        soak_ok, soak_s, soak_err = (int(x) for x in m.groups())
        status, body = _http("POST", f"{url}/models/{REST_MODEL}/generate", greedy_job)
        if status != 200 or body["generated_ids"] != url_tokens:
            fail(f"[rest] CLI greedy tokens differ from the in-process server's: "
                 f"{body.get('generated_ids')} vs {url_tokens}")
        # the CLI's gRPC front on the manager REST loaded into
        from tpuserve_torch.server import tpuserve_pb2 as pb
        from tpuserve_torch.server.grpc import GrpcClient

        client = GrpcClient(f"127.0.0.1:{grpc_port}")
        try:
            st = client.model_status(pb.ModelRequest(name=REST_MODEL), timeout=60)
        finally:
            client.close()
        if not st.is_loaded:
            fail(f"[rest] the CLI's gRPC front does not see the loaded model: {st}")
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            fail("[rest] CLI server still up 30 s after SIGINT")
        down_s = time.monotonic() - t0
        if rc != 0:
            fail(f"[rest] CLI server exited {rc} on SIGINT; see {log_path}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    log(f"[rest] CLI (python -m tpuserve_torch.server --grpc-port): "
        f"/health after {t_up:.1f} s, load {load_s:.2f} s, soak {soak_ok} ok and {soak_err} "
        f"errors in {soak_s} s (8 threads x 4), greedy tokens equal the in-process server's, "
        f"SIGINT: exit 0 in {down_s:.2f} s; card {smi_line}")
    return dict(up_s=t_up, load_s=load_s, soak_ok=soak_ok, soak_errors=soak_err, soak_s=soak_s,
                sigint_s=down_s)


def phase_rest(torch, p, smi_line):
    """The slice reached through its front: create_app(device="cuda") on
    127.0.0.1 serving the slice's model loaded over REST, 16 concurrent
    /generate requests counted and checked (launches, no plain version,
    greedy tokens equal backend.generate's on the same engine), streams,
    text, /infer, /metrics, a profile capture, auth, gRPC on the same
    manager, unload; then the CLI in a subprocess with the soak."""
    import importlib.util

    from tpuserve_torch.ops import decode_attention, quant_matmul
    from tpuserve_torch.server.http import _MANAGER_KEY, create_app

    log("[rest] importable here: " + ", ".join(
        f"{m} {importlib.util.find_spec(m) is not None}"
        for m in ("aiohttp", "grpc", "google.protobuf", "tokenizers", "requests")))
    tmp = _rest_repo(p)
    app = create_app(tmp, device=DEVICE)
    manager = app[_MANAGER_KEY]
    gen = f"/models/{REST_MODEL}/generate"
    with rest_server(app) as url:
        # 1. health and the device routes describe this card
        if _http("GET", url + "/health")[0] != 200:
            fail("[rest] /health")
        _, cuda = _http("GET", url + "/cuda")
        _, devs = _http("GET", url + "/devices")
        _, mem = _http("GET", url + "/gpu/memory")
        total_mb = round(torch.cuda.mem_get_info(0)[1] / 2 ** 20, 2)
        kind = torch.cuda.get_device_name(0)
        if not (cuda["cuda_available"] is True and cuda["device_count"] == 1
                and cuda["tpu_available"] is False):
            fail(f"[rest] /cuda: {cuda}")
        if devs["device_details"][0]["device_kind"] != kind or len(devs["devices"]) != 1:
            fail(f"[rest] /devices: {devs}")
        if mem["memory_info"][0]["total_mb"] != total_mb or _http(
                "GET", url + "/tpu/memory")[1]["memory_info"][0]["total_mb"] != total_mb:
            fail(f"[rest] /gpu/memory: {mem} (mem_get_info total {total_mb} MiB)")
        log(f"[rest] {url}: /cuda {cuda}; /devices {devs['devices']}; /gpu/memory total "
            f"{total_mb} MiB as mem_get_info")

        # 2. load over REST
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        status, body = _http("POST", f"{url}/models/{REST_MODEL}/load")
        load_s = time.monotonic() - t0
        if status != 202:
            fail(f"[rest] load answered {status}: {body}")
        if _http("POST", f"{url}/models/{REST_MODEL}/load")[0] != 200:
            fail("[rest] a second load did not answer 200")
        listed = _http("GET", url + "/models")[1]["models"]
        if [m["is_loaded"] for m in listed if m["name"] == REST_MODEL] != [True]:
            fail(f"[rest] /models after the load: {listed}")
        log(f"[rest] POST /models/{REST_MODEL}/load: 202 in {load_s:.2f} s (again: 200); "
            f"card {smi_line}")
        backend = manager.get_model(REST_MODEL).backend
        engine = backend.engine

        # 3. 16 concurrent /generate requests, the stop ids from probes
        jobs = _rest_jobs(p)
        phase_tokens = 0
        for job in jobs:
            job["want"] = job["max_new_tokens"]
            if job.get("logprobs"):
                _, probe = _http("POST", url + gen, dict(input_ids=job["input_ids"],
                                                         max_new_tokens=8))
                phase_tokens += probe["num_generated"]
                stop = probe["generated_ids"][3]
                job["stop_token_ids"] = [stop]
                job["want"] = probe["generated_ids"].index(stop) + 1
        bodies = [{k: v for k, v in job.items() if k != "want"} for job in jobs]

        def over_rest(job):
            status, out = _http("POST", url + gen, {k: v for k, v in job.items() if k != "want"})
            if status != 200:
                raise RuntimeError(f"status {status}: {out}")
            return out

        def direct(job):
            kw = {k: v for k, v in job.items() if k not in ("input_ids", "want")}
            return backend.generate(job["input_ids"], **kw)

        rest_jobs = [dict(b, want=j["want"]) for b, j in zip(bodies, jobs)]
        quant_matmul.launches = decode_attention.launches = 0   # the served wave starts here
        stats0 = engine.serving_stats()
        with plain_calls() as plain:
            a1, wall_a1 = _wave(torch, rest_jobs, over_rest, "REST wave 1")
        stats1 = engine.serving_stats()
        launches = {"quant_matmul": quant_matmul.launches,
                    "decode_attention": decode_attention.launches}
        steps = stats1["decode_steps"] - stats0["decode_steps"]
        prefills = stats1["prefill_calls"] - stats0["prefill_calls"]
        want_qmm = (4 * p.n_layers + 1) * (steps + prefills)
        want_attn = p.n_layers * steps
        log(f"[rest] 16 concurrent /generate requests: decode steps {steps}, prefill calls "
            f"{prefills}; launches {launches} (expected quant_matmul {want_qmm}, "
            f"decode_attention {want_attn}); plain versions called: {len(plain)}")
        if plain:
            fail(f"[rest] plain versions ran on the served path: {sorted(set(plain))}")
        if launches != {"quant_matmul": want_qmm, "decode_attention": want_attn} or not steps:
            fail("[rest] kernel launch counts do not match the served wave's calls")
        if stats1["active_slots"] or stats1["queue_depth"]:
            fail(f"[rest] the engine is still busy after the wave: {stats1}")
        # the same wave through backend.generate on the same engine: A B B A
        b1, wall_b1 = _wave(torch, rest_jobs, direct, "direct wave 1")
        b2, wall_b2 = _wave(torch, rest_jobs, direct, "direct wave 2")
        a2, wall_a2 = _wave(torch, rest_jobs, over_rest, "REST wave 2")
        wave_tokens = sum(j["want"] for j in rest_jobs)
        phase_tokens += 4 * wave_tokens
        greedy = [i for i, j in enumerate(jobs) if not j.get("temperature")]
        for i in greedy:
            runs = {r[i]["generated_ids"] == a1[i]["generated_ids"] for r in (a2, b1, b2)}
            if runs != {True}:
                fail(f"[rest] greedy request {i}: REST tokens differ from backend.generate's: "
                     f"{[r[i]['generated_ids'] for r in (a1, a2, b1, b2)]}")
        tok_s = {"rest": [wave_tokens / wall_a1, wave_tokens / wall_a2],
                 "direct": [wave_tokens / wall_b1, wave_tokens / wall_b2]}
        log(f"[rest] wave of 16 ({wave_tokens} tokens), host clock, A B B A: REST "
            f"{tok_s['rest'][0]:.1f}, direct {tok_s['direct'][0]:.1f}, direct "
            f"{tok_s['direct'][1]:.1f}, REST {tok_s['rest'][1]:.1f} tok/s; greedy tokens of "
            f"{len(greedy)} requests equal over REST and backend.generate in all four; card "
            f"{smi_line}")
        # a unary request holds one of the loop's default-executor threads
        # for its whole generation: the same turns with as many requests as
        # that executor has threads say whether the cap is the REST gap
        cap = min(32, (os.cpu_count() or 1) + 4)
        capped = rest_jobs[:cap]
        cap_tokens = sum(j["want"] for j in capped)
        walls = [_wave(torch, capped, call, f"{cap}-request wave")[1]
                 for call in (over_rest, direct, direct, over_rest)]
        tok_s[f"rest_{cap}"] = [cap_tokens / walls[0], cap_tokens / walls[3]]
        tok_s[f"direct_{cap}"] = [cap_tokens / walls[1], cap_tokens / walls[2]]
        phase_tokens += 4 * cap_tokens
        log(f"[rest] wave of {cap} (the front's executor threads; {cap_tokens} tokens), A B B "
            f"A: REST {tok_s[f'rest_{cap}'][0]:.1f}, direct {tok_s[f'direct_{cap}'][0]:.1f}, "
            f"direct {tok_s[f'direct_{cap}'][1]:.1f}, REST {tok_s[f'rest_{cap}'][1]:.1f} tok/s; "
            f"card {smi_line}")

        # 4. streams (the greedy jobs at once; a stream holds a thread of the
        # loop's default executor, min(32, cpus + 4), while it waits), text
        # and /infer
        import concurrent.futures as cf

        if len(greedy) > min(32, (os.cpu_count() or 1) + 4) - 2:
            fail(f"[rest] {len(greedy)} streams would fill the front's executor")
        with cf.ThreadPoolExecutor(len(greedy)) as ex:
            streamed = list(ex.map(lambda i: _http_stream(url + gen, dict(bodies[i], stream=True)),
                                   greedy))
        ttft = []
        for i, (chunks, first) in zip(greedy, streamed):
            toks = [c["token"] for c in chunks if "token" in c]
            last = chunks[-1]
            if toks != a1[i]["generated_ids"] or not last.get("done") or \
                    last.get("num_generated") != len(toks):
                fail(f"[rest] stream of request {i}: {toks} / {last} vs unary "
                     f"{a1[i]['generated_ids']}")
            ttft.append(first)
            phase_tokens += len(toks)
        ttft_ms = sorted(t * 1e3 for t in ttft)
        ttft_median = (ttft_ms[len(ttft_ms) // 2 - 1] + ttft_ms[len(ttft_ms) // 2]) / 2
        log(f"[rest] {len(greedy)} concurrent streams: NDJSON tokens equal the unary tokens, "
            f"last chunk done; time to first streamed token median {ttft_median:.1f} ms "
            f"(min {ttft_ms[0]:.1f}, max {ttft_ms[-1]:.1f}); card {smi_line}")
        text = "w7 w300 w12 w4095"
        status, out = _http("POST", url + gen, {"text": text, "max_new_tokens": 8})
        ids = engine.tokenizer.encode(text).ids
        if status != 200 or out["output_ids"][:len(ids)] != ids or not isinstance(out["text"], str):
            fail(f"[rest] text request: {status} {out} (ids {ids})")
        phase_tokens += out["num_generated"]
        prompt = bodies[0]["input_ids"]
        status, out = _http("POST", f"{url}/models/{REST_MODEL}/infer",
                            {"inputs": {"input_ids": prompt}})
        data = out["outputs"][0] if status == 200 else {}
        if data.get("name") != "output_ids" or data["data"][:len(prompt)] != prompt or \
                data["shape"] != [1, len(prompt) + engine.default_max_new]:
            fail(f"[rest] /infer: {status} {out}")
        phase_tokens += engine.default_max_new
        log(f"[rest] text request: output_ids begin with the tokenizer's {ids}, text returned; "
            f"/infer: output_ids {data['shape']}")

        # 5. /metrics
        _, metrics = _http("GET", url + "/metrics")
        serving = metrics["models"][f"{REST_MODEL}:1"]["serving"]
        if serving["tokens_generated"] < phase_tokens:
            fail(f"[rest] /metrics tokens_generated {serving['tokens_generated']} < "
                 f"{phase_tokens} generated in the phase")
        log(f"[rest] /metrics: serving {serving}; {phase_tokens} generated in the phase")

        # 6. a profile capture around one generate: the scheduler thread's
        # kernels must be in the trace
        trace_dir = tempfile.mkdtemp(prefix="tpuserve_torch_trace_")
        if _http("POST", url + "/profile/start", {"dir": trace_dir})[0] != 200:
            fail("[rest] /profile/start")
        status, out = _http("POST", url + gen, dict(input_ids=prompt, max_new_tokens=8))
        phase_tokens += out.get("num_generated", 0)
        status, stopped = _http("POST", url + "/profile/stop")
        if status != 200 or [f["path"] for f in stopped["files"]] != ["trace.json"]:
            fail(f"[rest] /profile/stop: {status} {stopped}")
        with open(os.path.join(trace_dir, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
        names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        seen = {k: sum(k in n for n in names) for k in ("qmm_wgmma_kernel", "attn_core_kernel")}
        log(f"[rest] profile capture: {stopped['total_bytes']} bytes of Chrome trace, "
            f"{len(names)} device kernels; {seen}")
        if not all(seen.values()):
            fail("[rest] the profile trace lacks the served path's kernels (only the front's "
                 "thread was traced?)")
        subprocess.run(["rm", "-rf", trace_dir], check=False)

        # 7. auth: REST only, / and /health open
        os.environ["TPUSERVE_AUTH_TOKEN"] = "chip-smoke"
        try:
            codes = (_http("GET", url + "/models")[0],
                     _http("GET", url + "/models", headers={
                         "Authorization": "Bearer chip-smoke"})[0],
                     _http("GET", url + "/health")[0])
        finally:
            del os.environ["TPUSERVE_AUTH_TOKEN"]
        if codes != (401, 200, 200):
            fail(f"[rest] auth: {codes}, expected (401, 200, 200)")
        log("[rest] TPUSERVE_AUTH_TOKEN: 401 without the header, 200 with it, /health open")

        # 8. gRPC on the same manager
        from tpuserve_torch.server import tpuserve_pb2 as pb
        from tpuserve_torch.server.grpc import GrpcClient, create_grpc_server

        server = create_grpc_server(manager, port=0, host="127.0.0.1")
        gport = server.add_insecure_port("127.0.0.1:0")
        server.start()
        client = GrpcClient(f"127.0.0.1:{gport}")
        try:
            ok = client.health(pb.HealthRequest(), timeout=60).status == "healthy"
            listed = client.list_models(pb.ListModelsRequest(), timeout=60)
            ok &= [m.is_loaded for m in listed.models if m.name == REST_MODEL] == [True]
            st = client.model_status(pb.ModelRequest(name=REST_MODEL), timeout=60)
            ok &= st.is_loaded and st.state == "LOADED"
            req = pb.GenerateRequest(name=REST_MODEL, input_ids=bodies[0]["input_ids"],
                                     max_new_tokens=bodies[0]["max_new_tokens"])
            unary = list(client.generate(req, timeout=600).generated_ids)
            chunks = list(client.generate_stream(req, timeout=600))
            streamed = [c.token for c in chunks if not c.done]
        finally:
            client.close()
            server.stop(grace=None)
        phase_tokens += 2 * len(unary)
        if not ok or unary != a1[0]["generated_ids"] or streamed != unary or not chunks[-1].done:
            fail(f"[rest] gRPC: health/list/status {ok}; Generate {unary}, GenerateStream "
                 f"{streamed} vs REST {a1[0]['generated_ids']}")
        log("[rest] gRPC (create_grpc_server on the same manager): Health, ListModels, "
            "ModelStatus; Generate and GenerateStream equal the REST greedy tokens")

        # 9. unload: the card's memory comes back
        status, _ = _http("POST", f"{url}/models/{REST_MODEL}/unload")
        del backend, engine
        import gc

        gc.collect()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        log(f"[rest] unload: {status}; memory_allocated {mem_before / 2**30:.3f} GiB before the "
            f"load, {mem_after / 2**30:.3f} GiB after the unload")
        if status != 201 or mem_after - mem_before > 2 ** 30:
            fail("[rest] unload did not answer 201 or return the card's memory to within 1 GB")
    torch.cuda.empty_cache()
    cli = _cli_server(tmp, a1[0]["generated_ids"], bodies[0], smi_line)
    return dict(launches=launches, want=dict(quant_matmul=want_qmm, decode_attention=want_attn),
                decode_steps=steps, prefill_calls=prefills, load_s=load_s, tok_s=tok_s,
                wave_tokens=wave_tokens, ttft_ms=ttft_ms, ttft_median_ms=ttft_median,
                phase_tokens=phase_tokens, mem_before=mem_before,
                mem_after=mem_after, cli=cli, smi=smi_line)


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


def _werr(torch, e, h) -> float:
    """The calibration-weighted error tr(E^T H E) of a residual E [K, N]
    under the Hessian H [K, K], in float64 on the card."""
    return float(torch.einsum("kn,kn->", e, h @ e))


@contextlib.contextmanager
def gptq_capture(gptq):
    """Record every (weight, Hessian, QTensor, options) that the GPTQ load
    quantizes and every LoRC factorization it makes, for the gates after
    the load: the recorder only keeps references, so the load's timings
    are the quantizer's own."""
    real_q, real_l = gptq.gptq_quantize, gptq.lorc_factors
    seen = {"gptq": [], "lorc": []}

    def q(w, h, **kw):
        qt = real_q(w, h, **kw)
        seen["gptq"].append((w, h, qt, kw))
        return qt

    def lf(w, qt, h, r, dtype=None):
        a, b = real_l(w, qt, h, r, dtype)
        seen["lorc"].append((qt, a, b))
        return a, b

    gptq.gptq_quantize, gptq.lorc_factors = q, lf
    try:
        yield seen
    finally:
        gptq.gptq_quantize, gptq.lorc_factors = real_q, real_l


def phase_gptq(torch, timer, reps, p, smi_line, n_layers=4):
    """Calibrated quantization on the card: the slice's configuration at
    Llama-2-7B widths cut to `n_layers` layers (every projection shape and
    lm_head K 4096 x N 32000 calibrated within the run), init random (bf16
    weights from a seed), quantization as models/llm_demo sets it (int4
    g128, method gptq, lowrank_correction 16, packed int4 KV), synthetic
    calibration (16 x 128 tokens, the JAX package's draw), loaded through
    InferenceManager(device="cuda"): each layer's seconds of collection,
    GPTQ and LoRC; the calibration pass's f32-x quant-matmuls counted (4
    a layer) and held against the plain version at their 2048 rows; gates
    on every calibrated weight (GPTQ's tr(E^T H E) at most RTN's, the
    port's quantize on the same grid; LoRC's residual at most GPTQ's), and
    layer 0's wo quantized again on the CPU (codes equal in >= 99.9%).
    Then 4 concurrent greedy requests of 16 new tokens (every route
    counter exact, no plain version), one full-width decode step against
    the plain versions ([w4a8]'s tolerances), and profiled decode steps
    with and without the LoRC factors: device time, the quant-matmul's
    share and LoRC's."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import decode_attention as tda
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.quant import core as qcore
    from tpuserve_torch.quant import gptq

    tag = "gptq"
    pl = dataclasses.replace(p, n_layers=n_layers)
    cfg = _model_config(pl)
    cfg["name"] = f"llama2_7b_gptq_{n_layers}l"
    cfg["model_params"]["init"] = "random"
    cfg["quantization"].update(method="gptq", lowrank_correction=16, calibration="synthetic")
    tmp = _write_repo(cfg)
    mgr = InferenceManager(tmp, num_workers=1, device=DEVICE)
    counters = ("launches", "f32_launches", "split_launches", "group_route_launches",
                "odd_group_launches", "w4a8_launches", "w4a8_route_launches", "stage_launches",
                "quantize_launches")
    for c in counters:          # the load's calibration pass starts here
        setattr(tqm, c, 0)
    with gptq_capture(gptq) as seen, plain_calls() as plain:
        t_load = time.monotonic()
        mgr.load_model(cfg["name"])
        torch.cuda.synchronize()
        load_s = time.monotonic() - t_load
    load_counts = {c: getattr(tqm, c) for c in counters}
    backend = mgr.get_model(cfg["name"]).backend
    engine = backend.engine
    timings = list(engine.gptq_timings)
    for t in timings:
        log(f"[{tag}] load {t['layer']}: collection {t['collect_s']:.2f} s, GPTQ "
            f"{t['gptq_s']:.2f} s, LoRC {t['lorc_s']:.2f} s")
    tot = {k: sum(t[k] for t in timings) for k in ("collect_s", "gptq_s", "lorc_s")}
    log(f"[{tag}] load through InferenceManager {load_s:.1f} s: collection "
        f"{tot['collect_s']:.1f} s, GPTQ {tot['gptq_s']:.1f} s, LoRC {tot['lorc_s']:.1f} s; "
        f"quant-matmul launches in the calibration pass {load_counts}; plain calls {plain}")
    want_load = dict.fromkeys(counters, 0)
    want_load.update(launches=4 * n_layers, f32_launches=4 * n_layers,
                     split_launches=4 * n_layers)
    if load_counts != want_load or plain:
        fail(f"[{tag}] the calibration pass's quant-matmuls: {load_counts} (expected "
             f"{want_load}), plain calls {plain}")

    # gates on every calibrated weight
    gates = []
    if len(seen["gptq"]) != 4 * n_layers + 1 or len(seen["lorc"]) != len(seen["gptq"]):
        fail(f"[{tag}] {len(seen['gptq'])} weights quantized, {len(seen['lorc'])} factorized")
    name_of = {id(v): n for n, v in engine.params.items()}   # the served QTensor objects
    names = [name_of.get(id(qt)) for _, _, qt, _ in seen["gptq"]]
    for name, (w, h, qt, kw), (qt2, a, b) in zip(names, seen["gptq"], seen["lorc"]):
        if name is None or qt2 is not qt or engine.params.get(f"{name}@lorc_a") is not a:
            fail(f"[{tag}] a quantized weight or its LoRC factors are not the served ones")
        wd = w.double()
        e_g = wd - qcore.dequantize(qt).double()
        e_r = wd - qcore.dequantize(qcore.quantize(w, bits=4, group_size=128)).double()
        e_l = e_g - a.double() @ b.double()
        row = dict(name=name, K=w.shape[0], N=w.shape[1], n_samples=kw.get("n_samples"),
                   gptq=_werr(torch, e_g, h), rtn=_werr(torch, e_r, h), lorc=_werr(torch, e_l, h))
        gates.append(row)
        del e_g, e_r, e_l, wd
    for row in gates:
        name = row["name"]
        log(f"[{tag}] {name} K={row['K']} N={row['N']}: tr(E^T H E) GPTQ {row['gptq']:.5g}, "
            f"RTN {row['rtn']:.5g} ({row['gptq'] / row['rtn']:.4f}x), GPTQ+LoRC-16 "
            f"{row['lorc']:.5g} ({row['lorc'] / row['gptq']:.4f}x GPTQ)")
    bad = [r["name"] for r in gates if not (r["gptq"] <= r["rtn"] and r["lorc"] <= r["gptq"])]
    if bad:
        fail(f"[{tag}] GPTQ above RTN or LoRC above GPTQ on {bad}")

    # layer 0's wo again on the CPU: the same function, LAPACK for cuSOLVER
    wo = next(i for i, n in enumerate(names) if n == "layers.0/wo/kernel")
    w, h, qt, kw = seen["gptq"][wo]
    t0 = time.monotonic()
    qt_cpu = gptq.gptq_quantize(w.cpu(), h.cpu(), **kw)
    cpu_s = time.monotonic() - t0
    codes = (qcore.unpack_int4(qt.q, qt.group_size).cpu()
             == qcore.unpack_int4(qt_cpu.q, qt_cpu.group_size))
    cpu_same = codes.float().mean().item()
    scale_rel = ((qt.scale.cpu() - qt_cpu.scale).abs() / qt_cpu.scale.abs()).max().item()
    log(f"[{tag}] layers.0/wo on the card against the CPU ({cpu_s:.1f} s there): codes equal "
        f"in {100 * cpu_same:.4f}%, scales within {scale_rel:.3g} relative")
    if not cpu_same >= 0.999:
        fail(f"[{tag}] layers.0/wo: codes on the card and the CPU agree in {cpu_same:.5f} only")

    # the calibration pass's f32 route at its shape: 2048 rows of f32 x
    xg = torch.Generator(device=DEVICE)
    xg.manual_seed(17)
    x = torch.randn((16 * 128, qt.orig_shape[0]), generator=xg, device=DEVICE)
    f0 = tqm.f32_launches
    out, ref = tqm.quant_matmul(x, qt), tqm.quant_matmul_plain(x, qt)
    torch.cuda.synchronize()
    f32_err = (out - ref).abs().max().item()
    f32_tol = 1e-5 * ref.abs().max().item()
    if tqm.f32_launches != f0 + 1 or not f32_err <= f32_tol:
        fail(f"[{tag}] f32 x at 2048 rows: max|err| {f32_err} > {f32_tol}, or not counted")
    wdq = qcore.dequantize(qt, torch.float32)
    k_, n_ = qt.orig_shape
    f32_row = dict(name="wo", B=x.shape[0], K=k_, N=n_, max_abs_err=f32_err, tol=f32_tol,
                   ms=timer.ms(lambda i: tqm.quant_matmul(x, qt), reps),
                   plain_ms=timer.ms(lambda i: tqm.quant_matmul_plain(x, qt), 2),
                   library_ms=timer.ms(lambda i: torch.matmul(x, wdq), reps))
    f32_row["bound_ms"], f32_row["bound_by"] = bound(
        x.numel() * 4 + qt.nbytes + x.shape[0] * n_ * 4, tqm.PIECES * 2.0 * x.shape[0] * k_ * n_,
        PEAK_OPS["bf16"])
    log(f"[{tag}] quant_matmul f32 x at the calibration pass's 2048 rows (wo, int4 g128): "
        f"max|err| {f32_err:.3g} (tol {f32_tol:.3g}); {f32_row['ms']:.4f} ms, bound "
        f"{f32_row['bound_ms']:.4f} ms ({f32_row['bound_by']}), plain "
        f"{f32_row['plain_ms']:.4f} ms, torch.matmul f32 (TF32 off) "
        f"{f32_row['library_ms']:.4f} ms")
    del x, out, ref, wdq, seen, qt_cpu
    torch.cuda.empty_cache()

    # serving
    rng = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()
               for n in (9, 40, 100, 23)]
    results, errors = [None] * len(prompts), []

    def run(i):
        try:
            results[i] = backend.generate(prompts[i], max_new_tokens=16)
        except Exception as e:  # recorded, then fatal below
            errors.append(f"request {i}: {e}")

    for c in counters:          # the served run starts here
        setattr(tqm, c, 0)
    tda.launches = 0
    steps0, prefills0 = engine.steps, engine.prefill_calls
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    with plain_calls() as plain:
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    counts = {c: getattr(tqm, c) for c in counters}
    attn = tda.launches
    if errors or any(r is None for r in results):
        fail(f"[{tag}] requests failed: {errors}")
    if any(r["num_generated"] != 16 for r in results):
        fail(f"[{tag}] a request did not generate 16 tokens")
    steps = engine.steps - steps0
    calls = steps + engine.prefill_calls - prefills0
    want = dict.fromkeys(counters, 0)
    want["launches"] = (4 * n_layers + 1) * calls
    log(f"[{tag}] {len(prompts)} concurrent greedy requests, 16 new tokens each, in "
        f"{wall:.2f} s ({64 / wall:.1f} tok/s); decode steps {steps}, prefill calls "
        f"{calls - steps}; quant_matmul launches {counts} (expected {want}); flat attention "
        f"{attn} (expected {n_layers * steps}); plain calls {plain}")
    if counts != want or attn != n_layers * steps or plain:
        fail(f"[{tag}] served launches do not match the path's calls, or a plain version ran")

    cache = engine.cache
    g = torch.Generator(device=DEVICE)
    g.manual_seed(3)
    toks = torch.randint(0, p.vocab_size, (64,), generator=g, device=DEVICE)
    pos = torch.randint(100, 250, (64,), generator=g, device=DEVICE, dtype=torch.int32)
    pos[7] = -1
    snapshot = [t.clone() for t in cache_tensors(cache)]

    def restore():
        for dst, src in zip(cache_tensors(cache), snapshot):
            dst.copy_(src)

    depths = {}
    for depth in (1, n_layers):
        pd = dataclasses.replace(pl, n_layers=depth)
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

    no_lorc = {k: v for k, v in engine.params.items() if "@lorc_" not in k}
    with plain_calls() as plain:
        busy = profile_step(torch, lambda: llama.decode_step(engine.params, pl, toks, cache, pos),
                            tag=tag)
        restore()
        bare = profile_step(torch, lambda: llama.decode_step(no_lorc, pl, toks, cache, pos),
                            tag=f"{tag} without LoRC")
        restore()
    if plain:
        fail(f"[{tag}] the profiled steps ran plain versions: {sorted(set(plain))}")
    share = None
    if busy and bare:
        qmm_ms = sum(ms for key, ms, _ in busy["rows"] if "qmm_" in key)
        gemm = [(k, ms, c) for k, ms, c in busy["rows"]
                if "gemm" in k.lower() and "qmm_" not in k]
        share = dict(busy_ms=busy["busy_ms"], bare_busy_ms=bare["busy_ms"], qmm_ms=qmm_ms,
                     lorc_ms=busy["busy_ms"] - bare["busy_ms"],
                     lorc_ops=busy["device_ops"] - bare["device_ops"],
                     lorc_gemm_ms=sum(ms for _, ms, _ in gemm),
                     lorc_gemm_launches=sum(c for _, _, c in gemm), lorc_gemm_kernels=gemm)
        log(f"[{tag}] profiled decode step: {busy['busy_ms']:.3f} ms device time, quant-matmul "
            f"{qmm_ms:.3f} ms ({100 * qmm_ms / busy['busy_ms']:.1f}%); without the LoRC factors "
            f"{bare['busy_ms']:.3f} ms: LoRC {share['lorc_ms']:.3f} ms "
            f"({100 * share['lorc_ms'] / busy['busy_ms']:.1f}%) and {share['lorc_ops']} device "
            f"ops, of which GEMM kernels {share['lorc_gemm_ms']:.3f} ms in "
            f"{share['lorc_gemm_launches']} launches (two matmuls a corrected projection: "
            f"{2 * (4 * n_layers + 1)}); card {smi_line}")
    mgr.shutdown()
    return dict(n_layers=n_layers, load_s=load_s, timings=timings, load_totals=tot,
                load_launches=load_counts, gates=gates, cpu_codes_equal=cpu_same,
                cpu_scale_rel=scale_rel, cpu_s=cpu_s, f32_calibration=f32_row,
                launches=counts, want=want, attention_launches=attn, wall_s=wall,
                full_step=depths, profile=busy, profile_without_lorc=bare, lorc=share)


def phase_llm_demo(torch, smi_line):
    """The repository's own models/llm_demo (GPTQ with LoRC 16 on random
    weights from a seed, int4 weights and KV, speculation 4), loaded from
    the repository directory through the port's in-process REST front on
    the card: greedy /generate over REST, its tokens equal
    backend.generate's, every quant-matmul launch and no plain version."""
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.server.http import _MANAGER_KEY, create_app

    tag = "llm_demo"
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")
    app = create_app(repo, device=DEVICE)
    prompt = [5, 17, 100, 42, 7, 5, 17, 100, 42, 7]
    with rest_server(app) as url, plain_calls() as plain:
        t0 = time.monotonic()
        status, body = _http("POST", f"{url}/models/llm_demo/load")
        load_s = time.monotonic() - t0
        if status not in (200, 202):
            fail(f"[{tag}] load over REST: {status} {body}")
        backend = app[_MANAGER_KEY].get_model("llm_demo").backend
        engine = backend.engine
        tqm.launches = 0
        status, rest = _http("POST", f"{url}/models/llm_demo/generate",
                             {"input_ids": prompt, "max_new_tokens": 24})
        rest_launches = tqm.launches
        direct = backend.generate(prompt, max_new_tokens=24)
        torch.cuda.synchronize()
        stats = engine.serving_stats()
        status_u, _ = _http("POST", f"{url}/models/llm_demo/unload")
    log(f"[{tag}] models/llm_demo over REST on the card: load {load_s:.2f} s "
        f"(GPTQ+LoRC-16, {len(engine.gptq_timings)} timed parts), /generate {status}, 24 tokens "
        f"{rest.get('generated_ids')}; backend.generate equal: "
        f"{rest.get('generated_ids') == direct['generated_ids']}; quant-matmul launches "
        f"{rest_launches}; speculation {dict((k, stats.get(k)) for k in ('spec_drafted', 'spec_accepted'))}; "
        f"plain calls {plain}; unload {status_u}")
    if status != 200 or rest.get("generated_ids") != direct["generated_ids"] \
            or rest.get("num_generated") != 24:
        fail(f"[{tag}] greedy tokens over REST differ from backend.generate's: {rest}")
    if plain or rest_launches < 1 or status_u != 201:
        fail(f"[{tag}] plain versions {plain}, {rest_launches} launches, unload {status_u}")
    return dict(load_s=load_s, tokens=rest["generated_ids"], launches=rest_launches,
                stats={k: v for k, v in stats.items() if isinstance(v, (int, float))})


# ------------------------------------------------------------------------ zoo
ZOO_REL = 5e-2  # kernel vs plain forward, bf16 through every layer: of the logits' range
ZOO_BATCH_REL = 2e-2  # a batched image against its solo forward (other batch, other conv plan)


def _zoo_configs():
    """The zoo's full-width configurations at the JAX package's defaults:
    BERT-base (vocab 30522, dim 768, 12 layers, 12 heads, ffn 3072) at B 8,
    L 128; DenseNet-121 and ResNet-50 at 224x224x3, 1000 classes; all int8
    g128 (the config's quantization)."""
    img = [{"name": "data_0", "shape": [-1, 224, 224, 3], "data_type": "FLOAT32"}]
    logits = [{"name": "logits", "shape": [-1, 1000], "data_type": "FLOAT32"}]
    q8 = {"weights": "int8", "group_size": 128}
    return {
        "bert": dict(name="bert_base", platform="jax", architecture="bert", quantization=q8,
                     inputs=[{"name": "input_ids", "shape": [-1, 128], "data_type": "INT32"},
                             {"name": "attention_mask", "shape": [-1, 128],
                              "data_type": "INT32"}],
                     outputs=[{"name": "logits", "shape": [-1, 2], "data_type": "FLOAT32"}]),
        "densenet121": dict(name="densenet121", platform="jax", architecture="densenet121",
                            quantization=q8, inputs=img, outputs=logits),
        "resnet50": dict(name="resnet50", platform="jax", architecture="resnet50",
                         quantization=q8, inputs=[dict(img[0], name="input")], outputs=logits),
    }


def _zoo_inputs(torch, arch, b=8):
    g = torch.Generator(device=DEVICE).manual_seed(5)
    if arch == "bert":
        ids = torch.randint(0, 30522, (b, 128), generator=g, device=DEVICE, dtype=torch.int32)
        mask = torch.ones((b, 128), dtype=torch.int32, device=DEVICE)
        for i in range(1, b):          # rows padded to 128 - 16 i real tokens
            mask[i, 128 - 16 * i:] = 0
        return {"input_ids": ids, "attention_mask": mask}
    name = "data_0" if arch == "densenet121" else "input"
    return {name: torch.randn((b, 224, 224, 3), generator=g, device=DEVICE)}


def _host_forward_ms(torch, fn, n=6):
    """Median host-clock ms of n synchronized calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        times.append((time.monotonic() - t) * 1e3)
    return sorted(times)[len(times) // 2]


def _zoo_forwards(torch, timer, smi_line):
    """Each full-width model: one int8 forward through the kernels (the
    quant-matmul launches it grew, no plain call) against the same forward
    on the plain versions; BERT's host-clock and profiled forward and the
    quant-matmul's share; DenseNet's images/s; ResNet's host clock; the
    per-call N pad of the N % 16 != 0 heads. Returns (results, the BERT
    params kept for the front)."""
    from tpuserve_torch.models import layers
    from tpuserve_torch.models.registry import get_architecture
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.quant.core import QTensor, quantize_param_tree
    from tpuserve_torch.repository.config import ModelConfig

    res, keep = {}, {}
    want = {"bert": 12 * 6 + 2, "densenet121": 1, "resnet50": 1}
    for arch, cfg in _zoo_configs().items():
        model = get_architecture(ModelConfig.from_dict(cfg), DEVICE)
        t = time.monotonic()
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
        qparams = quantize_param_tree(params, bits=8, group_size=128,
                                      predicate=model.quant_predicate)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t
        x = _zoo_inputs(torch, arch)
        out_name = cfg["outputs"][0]["name"]
        with torch.inference_mode():
            with plain_calls() as plain:
                tqm.launches = 0
                out = model.apply(qparams, x)[out_name]
                torch.cuda.synchronize()
                launched = tqm.launches
            with plain_kernels(layers, ("qmatmul",)):
                ref = model.apply(qparams, x)[out_name]
            torch.cuda.synchronize()
        span = (ref.max() - ref.min()).item()
        err = (out - ref).abs().max().item()
        top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
        heads = {k: v for k, v in qparams.items() if isinstance(v, QTensor)}
        log(f"[zoo] {arch} full width, int8 g128 ({len(heads)} quantized weights, "
            f"{sum(v.group_size == 0 for v in heads.values())} per channel; init + quantize "
            f"{init_s:.1f} s): kernels vs plain versions max|err| {err:.4g} of a logit range "
            f"{span:.4g} (tol {ZOO_REL} x range), top-1 equal on {top1:.3f} of rows; "
            f"quant-matmul launches {launched} (want {want[arch]}), plain calls {plain}")
        if not torch.isfinite(out).all() or not err <= ZOO_REL * span:
            fail(f"[zoo] {arch}: kernels vs plain max|err| {err} > {ZOO_REL} x {span}")
        if launched != want[arch] or plain:
            fail(f"[zoo] {arch}: {launched} quant-matmul launches (want {want[arch]}), "
                 f"plain calls {plain}")
        r = dict(max_abs_err=err, logit_range=span, top1_equal=top1, launches=launched,
                 init_quantize_s=init_s)

        def fwd():
            with torch.inference_mode():
                model.apply(qparams, x)

        r["host_ms"] = _host_forward_ms(torch, fwd)
        if arch == "bert":
            prof = profile_step(torch, fwd, tag="zoo", what="BERT-base forward (B 8, L 128)")
            if prof:
                qmm = sum(d for k, d, _ in prof["rows"] if "qmm_wgmma_kernel" in k)
                prof.update(qmm_ms=qmm, qmm_share=qmm / prof["busy_ms"])
                log(f"[zoo] BERT-base forward: host clock {r['host_ms']:.3f} ms (median of 6), "
                    f"device busy {prof['busy_ms']:.3f} ms in {prof['device_ops']} ops; "
                    f"quant-matmul {qmm:.3f} ms ({100 * qmm / prof['busy_ms']:.1f}%); "
                    f"{smi_line}")
            r["profile"] = prof
            keep = dict(model=model, params=params, qparams=qparams, x=x)
        else:
            r["images_per_s"] = 8 / (r["host_ms"] / 1e3)
            log(f"[zoo] {arch} forward at B=8: host clock {r['host_ms']:.3f} ms (median of 6), "
                f"{r['images_per_s']:.1f} images/s; {smi_line}")
        # the wrapper pads q and scale of an N % 16 != 0 head to 16 columns
        # on every call: that copy alone
        for name in ("classifier/kernel", "head/kernel"):
            qt = qparams.get(name)
            if isinstance(qt, QTensor) and qt.orig_shape[1] % 16:
                k, n = qt.orig_shape
                n_pad = -(-n // 16) * 16
                ms = timer.ms(lambda i: (torch.nn.functional.pad(qt.q, (0, n_pad - n)),
                                         torch.nn.functional.pad(qt.scale, (0, n_pad - n))), 20)
                r["n_pad"] = dict(weight=name, K=k, N=n, n_pad=n_pad, ms=ms)
                log(f"[zoo] {arch} {name} (K {k}, N {n}): the per-call pad of q and scale to "
                    f"N {n_pad}: {ms:.4f} ms a call; {smi_line}")
        res[arch] = r
        del params, qparams, x, out, ref
        if arch != "bert":
            del model
        torch.cuda.empty_cache()
    return res, keep


def _zoo_row_1b(torch, timer, smi_line):
    """Row 1b (int8 g128, bf16 x) at BERT-base's shapes and B*L = 1024
    rows: each call against its plain version, beside torch.matmul on the
    dequantized bf16 weights and the bound; the per-forward sum (12 x (4
    x 768^2 + 768x3072 + 3072x768))."""
    from tpuserve_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain
    from tpuserve_torch.quant.core import dequantize

    rows, total = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    for name, (k, n), per in (("qkvo", (768, 768), 48), ("ffn_in", (768, 3072), 12),
                              ("ffn_out", (3072, 768), 12)):
        qt = _qt_random(torch, 8, k, n, 128)
        b = 1024
        xs = [torch.randn((b, k), device=DEVICE).to(torch.bfloat16)
              for _ in range(max(1, math.ceil(L2_FLUSH_BYTES / (b * k * 2 + qt.nbytes))))]
        out, ref = quant_matmul(xs[0], qt), quant_matmul_plain(xs[0], qt)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2 ** -7 * ref.float().abs().max().item()
        if not err <= tol:
            fail(f"[zoo] row 1b {name} K {k} N {n} B {b}: max|err| {err} > {tol}")
        ms = timer.ms(lambda i: quant_matmul(xs[i % len(xs)], qt), 20)
        plain_ms = timer.ms(lambda i: quant_matmul_plain(xs[i % len(xs)], qt), 4)
        wd = dequantize(qt, torch.bfloat16)
        lib_ms = timer.ms(lambda i: torch.matmul(xs[i % len(xs)], wd), 20)
        nbytes, ops = b * k * 2 + qt.nbytes + b * n * 2, 2.0 * b * k * n
        bms, by = bound(nbytes, ops, PEAK_OPS["bf16"])
        rows.append(dict(name=name, K=k, N=n, B=b, max_abs_err=err, tol=tol, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                         per_forward=per))
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                       ("bytes", nbytes), ("ops", ops)):
            total[key] += per * v
        log(f"[zoo] row 1b int8 g128 bf16 x, BERT {name} K {k} N {n} at {b} rows: max|err| "
            f"{err:.3g} (tol {tol:.3g}); {ms:.4f} ms, bound {bms:.4f} ms ({by}), plain "
            f"{plain_ms:.4f} ms, torch.matmul bf16 {lib_ms:.4f} ms ({ms / lib_ms:.2f}x); "
            f"{smi_line}")
        del xs, wd, qt
    total["bound_ms"], total["bound_by"] = bound(total["bytes"], total["ops"], PEAK_OPS["bf16"])
    log(f"[zoo] row 1b per BERT-base forward (72 encoder calls at 1024 rows): "
        f"{total['ms']:.3f} ms, bound {total['bound_ms']:.3f} ms ({total['bound_by']}), "
        f"torch.matmul {total['library_ms']:.3f} ms ({total['ms'] / total['library_ms']:.2f}x); "
        f"{smi_line}")
    torch.cuda.empty_cache()
    return rows, total


def _zoo_repo(torch, keep):
    """A temporary repository: a copy of models/densenet_tpu (its config and
    labels.txt; weights from DenseNet-121's init written there as
    params.npz, never into models/), the same with dynamic_batching on,
    the repository's models/test_model, the ONNX fixture, a TorchScript
    model scripted here and BERT-base (its bf16 init as
    model.safetensors)."""
    import numpy as np

    from tpuserve_torch import fixtures
    from tpuserve_torch.models.registry import get_architecture
    from tpuserve_torch.repository.config import ModelConfig
    from tpuserve_torch.utils.checkpoint import write_safetensors

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")
    tmp = tempfile.mkdtemp(prefix="tpuserve_torch_zoo_")
    src = os.path.join(here, "densenet_tpu", "1")
    with open(os.path.join(src, "config.json")) as fh:
        dn_cfg = json.load(fh)
    model = get_architecture(ModelConfig.from_dict(dn_cfg), DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(1))
    npz = {k: v.float().cpu().numpy() for k, v in params.items()}
    for name, batching in (("densenet_tpu", False), ("densenet_batched", True)):
        vdir = os.path.join(tmp, name, "1")
        os.makedirs(vdir)
        shutil.copy(os.path.join(src, "labels.txt"), vdir)
        with open(os.path.join(vdir, "config.json"), "w") as fh:
            json.dump(dict(dn_cfg, name=name, dynamic_batching=batching), fh)
        np.savez(os.path.join(vdir, "params.npz"), **npz)
    shutil.copytree(os.path.join(here, "test_model"), os.path.join(tmp, "test_model"))
    fixtures.create_onnx_test_model(tmp)

    class OnCard(torch.nn.Module):
        """y = 2x + b, and 1.0 where x lay on the card."""

        def __init__(self):
            super().__init__()
            self.b = torch.nn.Parameter(torch.arange(3, dtype=torch.float32))

        def forward(self, x):
            return x * 2.0 + self.b, torch.full((1,), float(x.is_cuda), device=x.device)

    vdir = os.path.join(tmp, "torchscript_oncard", "1")
    os.makedirs(vdir)
    torch.jit.script(OnCard().eval()).save(os.path.join(vdir, "model.pt"))
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump({"name": "torchscript_oncard", "platform": "pytorch",
                   "inputs": [{"name": "x", "shape": [-1, 3], "data_type": "FLOAT32"}],
                   "outputs": [{"name": "y", "shape": [-1, 3], "data_type": "FLOAT32"},
                               {"name": "on_card", "shape": [1], "data_type": "FLOAT32"}]}, fh)
    bert_cfg = _zoo_configs()["bert"]
    vdir = os.path.join(tmp, bert_cfg["name"], "1")
    os.makedirs(vdir)
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(bert_cfg, fh)
    write_safetensors(os.path.join(vdir, "model.safetensors"), keep["params"])
    return tmp


def phase_zoo(torch, timer, smi_line):
    """[zoo]: the model zoo, the ONNX importer, micro-batching and
    TorchScript on the card (module docstring, phase 4i)."""
    forwards, keep = _zoo_forwards(torch, timer, smi_line)
    row_1b, row_1b_total = _zoo_row_1b(torch, timer, smi_line)
    tmp = _zoo_repo(torch, keep)
    try:
        out = _zoo_front(torch, tmp, keep, dict(forwards=forwards, row_1b=row_1b,
                                                 row_1b_total=row_1b_total, smi=smi_line))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del keep
    torch.cuda.empty_cache()
    ffn_in = next(r for r in row_1b if r["name"] == "ffn_in")
    out["entry"] = dict(max_abs_err=max(r["max_abs_err"] for r in row_1b), ms=ffn_in["ms"],
                        plain_ms=ffn_in["plain_ms"], bound_ms=ffn_in["bound_ms"],
                        bound_by=ffn_in["bound_by"], library_ms=ffn_in["library_ms"],
                        per="one call: BERT-base ffn_in (K 768, N 3072), 1024 rows, int8 g128, "
                            "bf16 x")
    return out


def _zoo_front(torch, tmp, keep, out):
    """The zoo through the port's REST and gRPC front from the temporary
    repository tmp (phase_zoo): each model served, the front's quant-matmul
    launches counted exactly, micro-batching, eval_accuracy's classifier
    branch; out gains the results."""
    import concurrent.futures as cf

    import numpy as np

    from tpuserve_torch import fixtures
    from tpuserve_torch.ops import quant_matmul as tqm
    from tpuserve_torch.server.http import _MANAGER_KEY, create_app

    tag, smi_line = "zoo", out["smi"]
    app = create_app(tmp, device=DEVICE)
    manager = app[_MANAGER_KEY]
    # noise at 16 scales: a random-init network maps plain noise images to
    # logits within ~0.01 of each other, too close to tell a batch's rows
    # apart; scaled, the closest two differ by far more than the batching
    # error
    g = np.random.default_rng(3)
    scales = np.linspace(0.5, 2.0, 16, dtype=np.float32)[:, None, None, None]
    images = (g.normal(size=(16, 224, 224, 3)) * scales).astype(np.float32)
    with open(os.path.join(tmp, "densenet_tpu", "1", "labels.txt")) as fh:
        labels = [line.strip() for line in fh if line.strip()]
    with rest_server(app) as url, plain_calls() as plain:
        for name in ("densenet_tpu", "densenet_batched", "test_model", "test_model_onnx",
                     "torchscript_oncard", "bert_base"):
            t = time.monotonic()
            status, body = _http("POST", f"{url}/models/{name}/load")
            if status not in (200, 201, 202):
                fail(f"[{tag}] load {name} over REST: {status} {body}")
            out.setdefault("load_s", {})[name] = time.monotonic() - t
        for mod in (tqm,):        # the front's run starts here
            mod.launches = 0
        f32_0 = tqm.f32_launches

        def infer(name, inputs):
            status, body = _http("POST", f"{url}/models/{name}/infer", {"inputs": inputs})
            if status != 200:
                fail(f"[{tag}] /models/{name}/infer: {status} {body}")
            return {o["name"]: o for o in body["outputs"]}

        # 1. densenet_tpu: top-5 with labels.txt names
        o = infer("densenet_tpu", {"data_0": images[:1].tolist()})["logits"]
        top = o.get("classifications", [])
        if len(top) != 5 or any(c.get("label") != labels[c["index"]] for c in top):
            fail(f"[{tag}] densenet_tpu top-5 does not carry labels.txt names: {top}")
        log(f"[{tag}] densenet_tpu (models/densenet_tpu's config and labels.txt, params.npz "
            f"written in the phase) over REST on the card: logits {o['shape']}, top-5 "
            f"{[(c['index'], c['label']) for c in top]}")
        # 2. models/test_model from its safetensors, and 3. the ONNX fixture
        w = fixtures.make_test_model_weights()
        x = np.array([[1.0, 2.0, 3.0]], np.float32)
        want = fixtures.reference_mlp_forward(w, x)
        for name in ("test_model", "test_model_onnx"):
            got = np.asarray(infer(name, {"input": x.tolist()})["output"]["data"],
                             np.float32).reshape(want.shape)
            err = float(np.abs(got - want).max())
            log(f"[{tag}] {name} over REST on the card: {got.tolist()} against "
                f"reference_mlp_forward {want.tolist()}: max|err| {err:.3g} (tol 1e-5)")
            if not err <= 1e-5:
                fail(f"[{tag}] {name}: max|err| {err} > 1e-5")
            out[f"{name}_err"] = err
        # 4. TorchScript: the output tensor came from the card
        o = infer("torchscript_oncard", {"x": x.tolist()})
        module = manager.get_model("torchscript_oncard").backend._module
        on_card = o["on_card"]["data"] == [1.0] and next(module.parameters()).is_cuda
        if not on_card or o["y"]["data"] != (2 * x[0] + np.arange(3)).tolist():
            fail(f"[{tag}] TorchScript: {o}, module on the card {on_card}")
        log(f"[{tag}] TorchScript model.pt (scripted in the phase) over REST: y {o['y']['data']}, "
            f"computed on the card (x.is_cuda in the module: {o['on_card']['data']})")
        # 5. BERT-base over gRPC's Infer, and 6. micro-batching over gRPC
        from tpuserve_torch.server import tpuserve_pb2 as pb
        from tpuserve_torch.server.grpc import GrpcClient, create_grpc_server

        ids = keep["x"]["input_ids"][:2].cpu().numpy()
        mask = keep["x"]["attention_mask"][:2].cpu().numpy()
        server = create_grpc_server(manager, port=0, host="127.0.0.1")
        gport = server.add_insecure_port("127.0.0.1:0")
        server.start()
        client = GrpcClient(f"127.0.0.1:{gport}")

        def grpc_image(name, i):
            """One image as raw float32 bytes; its logits."""
            resp = client.infer(pb.InferRequest(name=name, inputs=[pb.Tensor(
                name="data_0", data_type="FP32", shape=[1, 224, 224, 3],
                raw_data=images[i:i + 1].tobytes())]), timeout=600)
            return np.asarray(resp.outputs[0].tensor.float_data, np.float32)

        def batch_stats():
            st = _http("GET", f"{url}/models/densenet_batched/stats")[1]["stats"]
            return st.get("dynamic_batches", 0), st.get("dynamic_batched_requests", 0)

        def wave(call, name):
            """16 concurrent one-image requests: (requests/s, each one's
            logits, forwards of more than one request, requests in them)."""
            b0 = batch_stats()
            with cf.ThreadPoolExecutor(16) as pool:
                t = time.monotonic()
                futs = [pool.submit(call, name, i) for i in range(16)]
                res = [f.result() for f in futs]
                rate = 16 / (time.monotonic() - t)
            b1 = batch_stats()
            return rate, res, b1[0] - b0[0], b1[1] - b0[1]

        def check_batched(got, what):
            """Each batched response against its own solo result: within
            ZOO_BATCH_REL x its range and within half the smallest distance
            between two images' solo results, so it lies nearer its own than
            any other's and a split or order fault shows."""
            errs = [float(np.abs(got[i] - solo[i]).max()) for i in range(16)]
            spans = [float(solo[i].max() - solo[i].min()) for i in range(16)]
            if any(e > ZOO_BATCH_REL * sp or not e < solo_gap / 2 for e, sp in zip(errs, spans)):
                fail(f"[{tag}] micro-batching, {what}: |batched - own solo| {errs}, ranges "
                     f"{spans}, half the smallest solo distance {solo_gap / 2}")
            return errs

        try:
            before = tqm.launches
            resp = client.infer(pb.InferRequest(name="bert_base", inputs=[
                pb.Tensor(name="input_ids", data_type="INT32", shape=[2, 128],
                          int_data=ids.reshape(-1).tolist()),
                pb.Tensor(name="attention_mask", data_type="INT32", shape=[2, 128],
                          int_data=mask.reshape(-1).tolist())]), timeout=600)
            bert_launches = tqm.launches - before
            got = {o.tensor.name: np.asarray(o.tensor.float_data, np.float32).reshape(
                list(o.tensor.shape)) for o in resp.outputs}
            if bert_launches != 74:
                fail(f"[{tag}] gRPC Infer on bert_base launched {bert_launches} quant-matmuls "
                     f"(want 74)")

            # micro-batching: each image alone first (batching on, one at a
            # time), a warm wave each, then 16 concurrent one-image requests
            # with batching off and on, A B B A three times; over REST the
            # same wave once, as a record
            b_start = batch_stats()
            solo = [grpc_image("densenet_batched", i) for i in range(16)]
            solo_gap = min(float(np.abs(solo[i] - solo[j]).max())
                           for i in range(16) for j in range(i + 1, 16))
            for name in ("densenet_tpu", "densenet_batched"):   # untimed: first batch shapes
                check_batched(wave(grpc_image, name)[1], f"{name}, the warm wave")
            waves = {}
            for name in ("densenet_tpu", "densenet_batched", "densenet_batched",
                         "densenet_tpu") * 3:
                waves.setdefault(name, []).append(wave(grpc_image, name))
            rest_wave = wave(lambda name, i: np.asarray(
                infer(name, {"data_0": images[i:i + 1].tolist()})["logits"]["data"],
                np.float32), "densenet_batched")
            b_end = batch_stats()
        finally:
            client.close()
            server.stop(grace=None)
        served = tqm.launches
        # every request since the count was set to 0 ran one forward, but
        # the batched model's requests that shared one: each forward of
        # BERT launches 74 quant-matmuls, of DenseNet 1
        requests = 1 + 16 + 16 * (2 + len(waves["densenet_tpu"]) +
                                  len(waves["densenet_batched"]) + 1)
        dn_forwards = requests - (b_end[1] - b_start[1]) + (b_end[0] - b_start[0])
        errs = []
        for i, w in enumerate(waves["densenet_batched"]):
            errs += check_batched(w[1], f"timed wave {i}")
        errs += check_batched(rest_wave[1], "the REST wave")
        per_wave = [w[2] + 16 - w[3] for w in waves["densenet_batched"]]
        rates = {k: sorted(w[0] for w in v) for k, v in waves.items()}
        med = {k: v[len(v) // 2] for k, v in rates.items()}
        apart = rates["densenet_batched"][0] > rates["densenet_tpu"][-1] or \
            rates["densenet_tpu"][0] > rates["densenet_batched"][-1]
        log(f"[{tag}] bert_base (BERT-base int8, safetensors written in the phase) over gRPC "
            f"Infer: logits {list(got['logits'].shape)}, pooled {list(got['pooled'].shape)}; "
            f"{bert_launches} quant-matmul launches (want 74)")
        log(f"[{tag}] micro-batching over gRPC (densenet_batched: dynamic_batching true, the "
            f"batcher's max_queue_delay_us 2000): 16 concurrent one-image requests ran in "
            f"{per_wave} forwards in the 6 timed waves; worst |batched - own solo| "
            f"{max(errs):.4g} (tol {ZOO_BATCH_REL} x range and half the smallest distance "
            f"between two images' solo logits, {solo_gap:.4g}); "
            f"requests/s of 6 waves a side (A B B A x 3), on median {med['densenet_batched']:.1f} "
            f"(range {rates['densenet_batched'][0]:.1f}-{rates['densenet_batched'][-1]:.1f}), "
            f"off median {med['densenet_tpu']:.1f} (range {rates['densenet_tpu'][0]:.1f}-"
            f"{rates['densenet_tpu'][-1]:.1f}); the ranges "
            f"{'do not overlap' if apart else 'overlap'}; {smi_line}")
        log(f"[{tag}] the same wave over REST (JSON, 150,528 floats a request): "
            f"{rest_wave[2] + 16 - rest_wave[3]} forwards ({rest_wave[2]} of more than one "
            f"request), {rest_wave[0]:.1f} requests/s (one wave)")
        log(f"[{tag}] the front's quant-matmul launches: {served} = 74 (the gRPC BERT request) "
            f"+ {dn_forwards} DenseNet forwards of {requests} requests; plain calls {plain}")
        if not max(per_wave) < 16:
            fail(f"[{tag}] micro-batching: {per_wave} forwards for 16 requests")
        if plain or served != 74 + dn_forwards:
            fail(f"[{tag}] the front ran plain versions {plain}, {served} launches "
                 f"(want 74 + {dn_forwards})")
        out.update(launches=served, bert_launches=bert_launches, densenet_forwards=dn_forwards,
                   forwards=per_wave, batch_errs=errs, solo_gap=solo_gap,
                   requests_per_s=rates, requests_per_s_median=med, rates_apart=apart,
                   rest_wave=dict(requests_per_s=rest_wave[0], dynamic_batches=rest_wave[2],
                                  batched_requests=rest_wave[3]))
        # the BERT reply against the backend's params through apply (on the
        # kernel, after the front's count was read)
        be = manager.get_model("bert_base").backend
        with torch.inference_mode():
            direct = be._arch.apply(be.params, {
                "input_ids": torch.from_numpy(ids).to(DEVICE),
                "attention_mask": torch.from_numpy(mask).to(DEVICE)})
        ref = direct["logits"].float().cpu().numpy()
        err = float(np.abs(got["logits"] - ref).max())
        span = float(ref.max() - ref.min())
        log(f"[{tag}] bert_base over gRPC against the backend's params through apply: max|err| "
            f"{err:.3g} of a range {span:.4g} (tol 1e-3 x range)")
        if set(got) != {"logits", "pooled"} or not err <= 1e-3 * span:
            fail(f"[{tag}] gRPC Infer on bert_base: {sorted(got)}, max|err| {err}")
        out["bert_grpc_err"] = err
        # 7. eval_accuracy's classifier branch on bert_base: f32 x on int8 (row 1g)
        from tpuserve_torch.scripts import eval_accuracy

        f32_before = tqm.f32_launches
        acc = eval_accuracy.evaluate(tmp, "bert_base", "", samples=16, seed=0, device=DEVICE)
        out["eval_accuracy"] = dict(acc, f32_launches=tqm.f32_launches - f32_before)
        log(f"[{tag}] eval_accuracy --model bert_base (classifier branch, f32 params vs int8 "
            f"g128): top-1 agreement {acc['top1_agreement']}, logit correlation "
            f"{acc['logit_correlation']}, gate {acc['gate_pass']}; f32-x quant-matmuls "
            f"{out['eval_accuracy']['f32_launches']}; plain calls {plain}")
        if plain or out["eval_accuracy"]["f32_launches"] != 74:
            fail(f"[{tag}] eval_accuracy: plain calls {plain}, "
                 f"{out['eval_accuracy']['f32_launches']} f32-x launches (want 74)")
        out["f32_launches"] = tqm.f32_launches - f32_0
        for name in ("densenet_tpu", "densenet_batched", "test_model", "test_model_onnx",
                     "torchscript_oncard", "bert_base"):
            _http("POST", f"{url}/models/{name}/unload")
    return out


def _mixtral_config(p):
    """Mixtral-8x7B-v0.1's published widths (its config.json) at init
    random_quantized (seeded int4 g128 codes, a seeded bf16 router), served
    as the slice is: packed int4 KV with bf16 scales (kv_scale_dtype's
    default), 64 slots, L=256, prefill_chunk 64, decode_horizon 8."""
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


# ------------------------------------------------------------- sharded serving
# [tp], [dp-sp] and [mixtral-tp]: a sharded model served across ranks that
# share the one card over gloo (their collectives cross the host; no number
# here is a multi-GPU speed). Each rank counts its own launches; the
# controller gathers every rank's counts over the event bus.


def _qmm_shard_shapes(p, tp):
    """The quant-matmul's local K x N on a tp rank: wqkv and lm_head column
    shards, wo row shards, and for a dense model w_gateup (column) and
    w_down (row); at 7B tp=2: 4096x6144, 2048x4096, 4096x11008, 5504x4096,
    4096x16000."""
    qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim
    shapes = [(p.dim, (qd + 2 * kvd) // tp), (qd // tp, p.dim), (p.dim, p.vocab_size // tp)]
    if not p.n_experts:
        shapes += [(p.dim, 2 * p.ffn_dim // tp), (p.ffn_dim // tp, p.dim)]
    return tuple(f"{k}x{n}" for k, n in shapes)


def _mesh_prompts(torch, p, lengths, seed):
    rng = torch.Generator().manual_seed(seed)
    return [torch.randint(0, p.vocab_size, (n,), generator=rng).tolist() for n in lengths]


def _rank_deltas(before, after):
    """Per rank: the change of every count between two rank_stats reads,
    the rank's memory and weight-block checksum, and its cache's checksum
    where the later read asked for it (rank_stats(cache=True))."""
    out = []
    for b, a in zip(before, after):
        d = {k: a[k] - b[k] for k in ("quant_matmul_launches", "decode_attention_launches",
                                      "decode_attention_paged_launches", "plain_calls",
                                      "plain_row_shards", "verify_calls", "verify_rows_written")}
        for counts in ("shard_launches", "shard_launch_rows"):
            keys = set(a[counts]) | set(b[counts])
            d[counts] = {k: a[counts].get(k, 0) - b[counts].get(k, 0) for k in sorted(keys)
                         if a[counts].get(k, 0) != b[counts].get(k, 0)}
        d.update({k: a[k] for k in ("rank", "coords", "device", "backend", "param_bytes",
                                    "cache_bytes", "param_fingerprint", "spec_disabled",
                                    "load_max_memory_allocated", "max_memory_allocated")},
                 cache_fingerprint=a.get("cache_fingerprint"),
                 step_host_ms=a["step_host_ms_median"])
        out.append(d)
    return out


def _check_ranks(tag, deltas, world, per_call, n_layers, steps, prefills, dp=1, attn=True,
                 qmm_shapes=(), smi_line=""):
    """Every rank launched the quant-matmul per_call times a call it ran
    (all decode steps; the prefills of its dp group's slots) and the flat
    core n_layers times a decode step (0 under sp), at the shard shapes, on
    the card, and called no plain version."""
    if len(deltas) != world:
        fail(f"[{tag}] {len(deltas)} ranks answered, expected {world}")
    owned = [0] * dp
    for r, d in enumerate(deltas):
        calls, rest = divmod(d["quant_matmul_launches"], per_call)
        if rest or calls < steps:
            fail(f"[{tag}] rank {r}: {d['quant_matmul_launches']} quant-matmuls, not "
                 f"{per_call} a call over {steps} decode steps and its prefills")
        owned[r * dp // world] = calls - steps
        want_attn = n_layers * steps if attn else 0
        if d["decode_attention_launches"] != want_attn:
            fail(f"[{tag}] rank {r}: {d['decode_attention_launches']} flat decode attentions, "
                 f"expected {want_attn}")
        if d["plain_calls"] or d["plain_row_shards"]:
            fail(f"[{tag}] rank {r} ran a plain version: {d}")
        if not d["device"].startswith("cuda") or d["backend"] != "gloo":
            fail(f"[{tag}] rank {r} ran on {d['device']} over {d['backend']}")
        for shape in qmm_shapes:
            if d["shard_launches"].get(f"quant_matmul {shape}", 0) < 1:
                fail(f"[{tag}] rank {r}: no quant-matmul launch at the shard shape {shape}: "
                     f"{d['shard_launches']}")
        log(f"[{tag}] rank {r} ({d['device']}, {d['backend']}): quant-matmul "
            f"{d['quant_matmul_launches']}, flat core {d['decode_attention_launches']}, plain "
            f"versions 0; at shard shapes {d['shard_launches']}; decode step host clock median "
            f"{d['step_host_ms']:.2f} ms; card {smi_line} (ranks share the card over gloo: "
            "not a multi-GPU speed)")
    if sum(owned) != prefills:
        fail(f"[{tag}] the dp groups ran {owned} prefills, the controller {prefills}")


def _check_rank_memory(tag, deltas, full_bytes, tp, base=()):
    """Each rank's peak allocation over its load (torch.cuda's
    max_memory_allocated in the rank's process, less `base`, what this
    process held before, for the rank that lives here): its weight blocks,
    its cache, and what a load holds on top (one whole parameter at most,
    then freed). Under tp no rank may ever have held the whole model, i.e.
    the part on top stays below the weights of the other ranks' blocks."""
    out = []
    for r, d in enumerate(deltas):
        peak = d["load_max_memory_allocated"] - (base[r] if r < len(base) else 0)
        extra = peak - d["param_bytes"] - d["cache_bytes"]
        out.append(dict(rank=r, load_peak=peak, blocks=d["param_bytes"], cache=d["cache_bytes"],
                        extra=extra))
        log(f"[{tag}] rank {r} memory: load peak {peak / 2**30:.3f} GiB = its weight blocks "
            f"{d['param_bytes'] / 2**30:.3f} + its cache {d['cache_bytes'] / 2**30:.3f} + "
            f"{extra / 2**30:.3f} on top; the whole model's weights "
            f"{full_bytes / 2**30:.3f} GiB; peak over the run "
            f"{(d['max_memory_allocated'] - (base[r] if r < len(base) else 0)) / 2**30:.3f} GiB")
        if tp > 1 and not extra < full_bytes - d["param_bytes"]:
            fail(f"[{tag}] rank {r} held {extra} bytes on top of its blocks and cache at load: "
                 f"the rest of the model is {full_bytes - d['param_bytes']}")
    return out


def _profile_summary(prof):
    """A profiled decode step's device busy time and its shares: the
    quant-matmul, the flat core, copies (gloo's host round trips) and the
    rest."""
    share = dict(quant_matmul=0.0, core=0.0, copies=0.0, other=0.0)
    for key, ms, _ in prof["rows"]:
        kind = "quant_matmul" if "qmm_" in key else "core" if "attn_core" in key \
            else "copies" if "memcpy" in key.lower() else "other"
        share[kind] += ms
    return dict(host_ms=prof["host_ms"], busy_ms=prof["busy_ms"], device_ops=prof["device_ops"],
                **{f"{k}_ms": v for k, v in share.items()})


def _log_profiles(tag, profiles, deltas, smi_line):
    """Each rank's profiled decode step beside its unprofiled steps' median
    host clock (the profiled step's own clock carries the profiler's start)."""
    for r, (pr, d) in enumerate(zip(profiles, deltas)):
        if pr is None or not pr["busy_ms"]:
            log(f"[{tag}] rank {r}: the profiler recorded no device time (not measured)")
            continue
        log(f"[{tag}] rank {r}, one profiled decode step: device busy {pr['busy_ms']:.3f} ms "
            f"({100 * pr['busy_ms'] / d['step_host_ms']:.2f}% of the {d['step_host_ms']:.2f} ms "
            f"median host clock of its unprofiled steps; the profiled step's own "
            f"{pr['host_ms']:.1f} ms carries the profiler's start), {pr['device_ops']} device "
            f"ops: quant-matmul {pr['quant_matmul_ms']:.3f}, flat core {pr['core_ms']:.3f}, "
            f"copies {pr['copies_ms']:.3f}, other {pr['other_ms']:.3f} ms; card {smi_line} "
            "(ranks share the card over gloo)")


def _shard_kernel_checks(torch, tag, weights, cache_engine, sizes, deltas, pos_max,
                         qmm_rows=None):
    """Each kernel of a rank's path held against its plain version at the
    rank's shard shapes, on the rank's blocks: its weight blocks cut from the
    one-rank engine `weights` (the same draws; their block checksum must
    equal the rank's own) and its block of `cache_engine`'s cache after
    that one-rank engine served the same requests (packed int4 repacked per
    tp shard, as a rank packs it), at slot positions up to `pos_max`, the
    last one served. The quant-matmul on layer 0's weights and the lm_head
    (an MoE model: each of the rank's experts' views) at the rank's decode
    rows, x ~ N(0, 1) in bf16; the flat core on layer 0 with a random q
    (not under sp: its merge is plain torch), or for a paged pool the paged
    core on the rank's block of layer 0's pages (_paged_shard_check). With
    `qmm_rows` the quant-matmul runs at that many rows instead (a verify's
    S/dp * C). Where tp does not divide the kv heads (`kv_replicated`) the
    attention is einsums on every rank, no kernel: the quant-matmul alone.
    Tolerances as in [kernel]: one bf16 step at the largest output; 2e-3
    of the output range."""
    from tpuserve_torch.models.llama import KVCache, _expert_slice, pack_kv_codes
    from tpuserve_torch.ops.decode_attention import (decode_attention_wide_cache_plain,
                                                     unpack_kv_codes)
    from tpuserve_torch.ops.quant_matmul import quant_matmul_plain
    from tpuserve_torch.parallel.mesh import Mesh
    from tpuserve_torch.parallel.sharding import (block_fingerprint, decode_attention_sharded,
                                                  kernel_operand, kv_replicated,
                                                  local_llama_params, qmatmul_local,
                                                  shard_cache, shard_llama_params)
    from tpuserve_torch.quant.core import qmatmul
    from tpuserve_torch.serving.paged_kv import PagedKVCache

    tp, dp, sp = sizes
    p, full = weights.p, cache_engine.cache
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(17)
    out = []
    for r in range(tp * dp * sp):
        mesh = Mesh(tp, dp, sp, r)
        ti = mesh.coords["tp"]
        blocks = shard_llama_params(weights.params, mesh)
        if deltas is not None and block_fingerprint(blocks) != deltas[r]["param_fingerprint"]:
            fail(f"[{tag}] rank {r}: its weight blocks' checksum differs from the cut of the "
                 "one-rank engine's weights")
        rows = weights.n_slots // dp
        checks = {}

        def hold(key, got, ref, tol):
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= tol:
                fail(f"[{tag}] rank {r}: {key}: max|kernel - plain| {err} > {tol}")
            worst = checks.get(key, (0.0, tol))
            checks[key] = (max(err, worst[0]), min(tol, worst[1]))

        def x_for(k):
            return torch.randn((qmm_rows or rows, k), generator=gen,
                               device=DEVICE).to(torch.bfloat16)

        for name in ("layers.0/wqkv/kernel", "layers.0/wo/kernel", "layers.0/w_gateup/kernel",
                     "layers.0/w_down/kernel", "lm_head/kernel"):
            if name not in blocks:
                continue
            qt = blocks[name]
            k, n = qt.orig_shape
            x = x_for(k)
            ref = quant_matmul_plain(x, kernel_operand(qt, name, ti, tp))
            hold(f"quant_matmul {x.shape[0]}x{k}x{n}", qmatmul_local(x, qt, name, ti, tp), ref,
                 2 ** -7 * ref.float().abs().max().item())
        for name in ("layers.0/moe_gateup/kernel", "layers.0/moe_down/kernel"):
            if name not in blocks:
                continue
            stack = blocks[name]
            for e in range(stack.n_experts):
                view = _expert_slice(stack, e)
                k, n = view.orig_shape
                x = x_for(k)
                ref = quant_matmul_plain(x, view)
                hold(f"quant_matmul experts {stack.n_experts} {k}x{n}", qmatmul(x, view), ref,
                     2 ** -7 * ref.float().abs().max().item())
        if kv_replicated(p, mesh):   # every rank attends by einsum: no core on its path
            pass
        elif isinstance(full, PagedKVCache):
            _paged_shard_check(torch, gen, hold, p, full, mesh, rows, pos_max)
        elif sp == 1:
            kv = [full.k[:1], full.v[:1]]
            if full.k.dtype == torch.uint8:   # a rank packs its own W/tp positions
                kv = [pack_kv_codes(unpack_kv_codes(t), tp) for t in kv]
            one = KVCache(k=kv[0], v=kv[1],
                          k_scale=None if full.k_scale is None else full.k_scale[:1],
                          v_scale=None if full.v_scale is None else full.v_scale[:1])
            blk = shard_cache(one, mesh)
            s_loc = blk.k.shape[1]
            pos = torch.randint(0, pos_max + 1, (s_loc,), generator=gen, device=DEVICE,
                                dtype=torch.int32)
            pos[0] = pos_max
            if s_loc > 1:
                pos[-1] = -1
            win = cache_engine._window(pos_max)
            q = (torch.randn((s_loc, local_llama_params(p, mesh).n_heads, p.head_dim),
                             generator=gen, device=DEVICE) / p.head_dim ** 0.5).to(torch.bfloat16)
            ks, vs = (None, None) if blk.k_scale is None else (blk.k_scale[0], blk.v_scale[0])
            ref = decode_attention_wide_cache_plain(q, blk.k, blk.v, ks, vs, pos, 0, window=win)
            got = decode_attention_sharded(q, blk.k, blk.v, ks, vs, pos, 0, window=win)
            hold(f"decode_attention {'x'.join(str(d) for d in blk.k.shape[1:])}", got, ref,
                 2e-3 * ref.abs().max().item() + 1e-6)
        out.append(dict(rank=r, checks=checks))
        log(f"[{tag}] rank {r}: kernels against their plain versions on its blocks at its "
            f"shard shapes (max|err|, tol): "
            + "; ".join(f"{k} {e:.3g} ({t:.3g})" for k, (e, t) in checks.items()))
    return out


def _paged_shard_check(torch, gen, hold, p, full, mesh, rows, pos_max):
    """The paged core (row 5) on a rank's shard of a served flat pool,
    against its plain version: layer 0's pages cut to the rank's kv heads
    (`shard_paged_cache`), its rows of the replicated scale pool, a random
    q at its heads, every slot's table a random chain of served pages, slot
    positions up to pos_max (one inactive)."""
    from tpuserve_torch.ops.decode_attention import decode_attention_wide_paged_plain
    from tpuserve_torch.parallel.sharding import (decode_attention_paged_sharded,
                                                  local_llama_params, paged_scale_rows,
                                                  shard_paged_cache)
    from tpuserve_torch.serving.paged_kv import PagedKVCache

    one = PagedKVCache(k=full.k[:1], v=full.v[:1],
                       k_scale=None if full.k_scale is None else full.k_scale[:1],
                       v_scale=None if full.v_scale is None else full.v_scale[:1])
    blk = shard_paged_cache(one, mesh)
    pl = local_llama_params(p, mesh)
    ps = blk.page_size
    n_cols = -(-(pos_max + 1) // ps)
    table = torch.randint(1, blk.n_pages, (rows, n_cols), generator=gen, device=DEVICE,
                          dtype=torch.int32)
    pos = torch.randint(0, pos_max + 1, (rows,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    pos[0] = pos_max
    pos[-1] = -1
    ksr, vsr = paged_scale_rows(blk, pl.n_kv_heads, mesh)
    q = (torch.randn((rows, pl.n_heads, p.head_dim), generator=gen, device=DEVICE)
         / p.head_dim ** 0.5).to(torch.bfloat16)
    args = (q, blk.k, blk.v, ksr, vsr, table, pos, 0)
    ref = decode_attention_wide_paged_plain(*args, window=n_cols * ps)
    got = decode_attention_paged_sharded(*args, mesh, window=n_cols * ps)
    hold(f"decode_attention_paged {'x'.join(str(d) for d in blk.k.shape[1:])}", got, ref,
         2e-3 * ref.abs().max().item() + 1e-6)


def _mesh_reference(torch, cfg, prompts, new, tag, env=(), sharding=None, warm=()):
    """The one-rank engine on the same weights (sharding off, or the
    `sharding` given; the knobs `env` set while it serves): its greedy
    tokens and logprobs for the same concurrent requests, after the `warm`
    prompts served one at a time; returns them with the manager, kept for
    the gate."""
    from tpuserve_torch.engine.manager import InferenceManager

    one = dict(cfg, name=cfg["name"] + ("_one" if not sharding else "_twin"),
               sharding=sharding or {})
    with contextlib.ExitStack() as stack:
        for key, val in env:   # set before the load: ranks it starts inherit them
            stack.enter_context(env_set(key, val))
        mgr = InferenceManager(_write_repo(one), num_workers=1, device=DEVICE)
        mgr.load_model(one["name"])
        backend = mgr.get_model(one["name"]).backend
        for w in warm:
            backend.generate(w, max_new_tokens=2)
        res = _mesh_wave(lambda i: backend.generate(prompts[i], max_new_tokens=new,
                                                    logprobs=True), len(prompts),
                         tag + " one-rank")[0]
    return mgr, backend.engine, res


def _mesh_wave(call, n, tag):
    results, errors = [None] * n, []

    def run(i):
        try:
            results[i] = call(i)
        except Exception as e:  # recorded, then fatal below
            errors.append(f"request {i}: {e}")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(r is None for r in results):
        fail(f"[{tag}] requests failed: {errors}")
    return results, time.monotonic() - t0


def _step_margins(torch, engine, p, prompt, shared, info=None, sp=1):
    """The one-rank engine's own step where a request parts
    (`sp_parting.slot_steps`: its prompt admitted as the engine admits it,
    then a decode step a shared token; with sp > 1 through the sp merge on
    threads). Returns the top-two gap of that
    step's logits and, for a MoE model, the smallest gap over the layers
    between the token's k-th and (k+1)-th router logits (a routing near
    tie). With `info` (a dict) also the step's top token, as info["top"],
    its logits, as info["logits"], and every step's, as info["steps"]."""
    from tpuserve_torch.models import llama
    from tpuserve_torch.scripts.sp_parting import slot_steps

    routes, real = [], llama.moe_combine_weights

    def rec(logits, n_experts, k):
        top = logits.reshape(-1, n_experts)[-1].float().sort(descending=True).values
        routes.append((top[k - 1] - top[k]).item())
        return real(logits, n_experts, k)

    llama.moe_combine_weights = rec
    try:
        steps = slot_steps(engine, p, prompt, shared, sp=sp, before_step=routes.clear)
    finally:
        llama.moe_combine_weights = real
    top2 = steps[-1].topk(2)
    if info is not None:
        info.update(top=int(top2.indices[0]), logits=steps[-1].cpu(), steps=steps)
    return (top2.values[0] - top2.values[1]).item(), min(routes, default=None)


# The level the mesh gates hold the shared tokens' logprob differences to,
# and from which their near-tie margin (4 dl + 1/32) is computed: the margin
# never grows past 4 * DL_LEVEL + 1/32, whatever a phase's logprobs do.
DL_LEVEL = 0.05


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (an 8-bit significand)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _shared_dl(torch, engine, p, prompts, a_runs, b_runs, tag, what, ulp_rule):
    """Two runs' greedy tokens and logprobs: per request the first token
    that differs (or None) and the largest |logprob diff| over the tokens
    both drew. The logits are bf16 values (the lm head's output), so where
    one run rounds a token's logit to a neighbouring bf16 value its logprob
    moves by that value's spacing. Fatal above DL_LEVEL, but with
    `ulp_rule` a token above it passes where it is one bf16 step of its
    logit at that step of the one-rank engine `engine` (its prefill and a
    decode step a shared token) plus 1/64: each such token is reported with
    its logit. Returns (per-request list, max dl, the tokens above
    DL_LEVEL)."""
    dl, per, over = 0.0, [], []
    for i, (prompt, a, b) in enumerate(zip(prompts, a_runs, b_runs)):
        d = _first_diff(a["generated_ids"], b["generated_ids"])
        n = len(a["generated_ids"]) if d is None else d    # the tokens both drew
        diffs = [abs(x - y) for x, y in zip(a["logprobs"][:n], b["logprobs"][:n])]
        per.append((d, max(diffs, default=0.0)))
        dl = max(dl, per[-1][1])
        for t, diff in enumerate(diffs):
            if diff <= DL_LEVEL:
                continue
            info = {}
            _step_margins(torch, engine, p, list(prompt), a["generated_ids"][:t], info)
            logit = float(info["logits"][a["generated_ids"][t]])
            over.append(dict(request=i, token=t, diff=diff, logit=logit,
                             bf16_step=_bf16_ulp(logit)))
    log(f"[{tag}] per request (first differing token, max |logprob diff| up to it): {per}")
    for o in over:
        limit = o["bf16_step"] + 1 / 64 if ulp_rule else DL_LEVEL
        if not o["diff"] <= max(DL_LEVEL, limit):
            fail(f"[{tag}] logprobs of the shared tokens differ {what} by {o['diff']} "
                 f"(request {o['request']}, token {o['token']}: the one-rank step's logit "
                 f"{o['logit']:.6g}, bf16 step {o['bf16_step']:.6g})")
    if over:
        log(f"[{tag}] shared tokens above {DL_LEVEL} {what}, each with the one-rank step's "
            f"logit and its bf16 step: {over}")
    return per, dl, over


def _mesh_gate(torch, engine, p, prompts, ref, got, tag, ulp_rule=False):
    """The sharded run's greedy tokens against the one-rank engine's. Along
    the tokens both drew, their logprobs differ by dl at most (held under
    DL_LEVEL; with `ulp_rule` a token may differ by one bf16 step of its
    logit, _shared_dl). A request whose tokens part is fatal unless they
    part on a near tie (the wide-margin rule: random weights put near ties
    on some steps): the one-rank engine's top two logits at that decode
    step (its int8 or int4 KV included: a fresh prefill of the same tokens
    can rank them otherwise) within 4 min(dl, DL_LEVEL) + 1/32, or, in a
    MoE model, two router logits at the edge of the top-k within 1/32.
    Each parting is reported with that step's top token (`step_top`) and
    its logits of the two runs' tokens (`step_logits`)."""
    per, dl, over = _shared_dl(torch, engine, p, prompts, ref, got, tag,
                               "from the one-rank engine's", ulp_rule)
    margin, route_tol = 4 * min(dl, DL_LEVEL) + 1 / 32, 1 / 32
    ties = []
    for i, (prompt, r, g, (d, _)) in enumerate(zip(prompts, ref, got, per)):
        if d is None:
            continue
        info = {}
        gap, route = _step_margins(torch, engine, p, list(prompt), r["generated_ids"][:d], info)
        a_tok, b_tok = r["generated_ids"][d], g["generated_ids"][d]
        ties.append(dict(request=i, token=d, top2_gap=gap, route_gap=route, one_rank=a_tok,
                         sharded=b_tok, step_top=info["top"],
                         step_logits=(float(info["logits"][a_tok]),
                                      float(info["logits"][b_tok]))))
        if gap > margin and (route is None or route > route_tol):
            fail(f"[{tag}] request {i}: sharded vs one-rank tokens differ at token {d}, a "
                 f"clear step (top-two gap {gap:.4g} > {margin:.4g}; router top-k edge gap "
                 f"{route}; {ties[-1]})")
    equal = sum(r["generated_ids"] == g["generated_ids"] for r, g in zip(ref, got))
    log(f"[{tag}] {equal} of {len(ref)} requests token-equal to the one-rank engine; shared "
        f"tokens' logprobs within {dl:.3g}; where they part (a near tie of the head, above "
        f"{margin:.4g} fatal, or of the router, above {route_tol:.4g}): {ties}")
    return dict(equal=equal, requests=len(ref), logprob_diff=dl, near_ties=ties,
                margin=margin, above_level=over)


def _arith_gate(torch, engine, p, prompts, on, off, tag, sp=1):
    """Speculation on against off on one sharded engine. The two runs
    decode in different attention arithmetic: a verify attends by einsum
    (bf16 dots, as GSPMD does in the JAX package), a decode step through
    the core (q and P requantized to int8), or under sp through the
    flash-decoding merge (q scaled before its bf16 dot, unnormalized
    probabilities rounded to bf16, as the JAX island), so on a random
    model a step can flip between them. Along the tokens both drew the
    logprobs differ by dl at most (_shared_dl with its bf16-step rule). A
    request whose tokens part is fatal unless, at that step of the
    one-rank engine `engine` (its prefill and a decode step a shared
    token), either mode's top two lie within 4 min(dl, DL_LEVEL) + 1/32 (a
    near tie), or the two modes themselves part there the same way: `xla`
    (the verify's einsum) picks the speculating run's token and the decode
    step's mode, `pallas` (the core) or with sp > 1 `merge` (the engine's
    weights over an sp mesh of threads), the other's. Under sp each parting
    also reports the largest |logit| difference between `xla` and `merge`
    after the prefill and after each shared token (`xla_vs_merge`)."""
    per, dl, over = _shared_dl(torch, engine, p, prompts, on, off, tag + " off vs on",
                               "between speculation on and off", True)
    margin, parts = 4 * min(dl, DL_LEVEL) + 1 / 32, []
    modes = ("xla", "pallas") if sp == 1 else ("xla", "merge")
    for i, (prompt, a, b, (d, _)) in enumerate(zip(prompts, on, off, per)):
        if d is None:
            continue
        step, steps = dict(request=i, token=d, on=a["generated_ids"][d],
                           off=b["generated_ids"][d]), {}
        for mode in modes:
            info = {}
            with env_set("TPUSERVE_DECODE_ATTN", "xla" if mode == "merge" else mode):
                gap, _ = _step_margins(torch, engine, p, list(prompt), a["generated_ids"][:d],
                                       info, sp=sp if mode == "merge" else 1)
            step[mode] = dict(top=info["top"], top2_gap=gap)
            steps[mode] = info["steps"]
        if sp > 1:
            step["xla_vs_merge"] = [round((x - y).abs().max().item(), 4)
                                    for x, y in zip(steps["xla"], steps["merge"])]
        near = min(step[m]["top2_gap"] for m in modes) <= margin
        split = step["xla"]["top"] == step["on"] and step[modes[1]]["top"] == step["off"]
        parts.append(dict(step, near_tie=near, modes_part=split))
        if not (near or split):
            fail(f"[{tag}] request {i}: speculation on and off part at token {d}, where neither "
                 f"mode of the one-rank engine ties and the modes do not part so: {step}")
    equal = sum(a["generated_ids"] == b["generated_ids"] for a, b in zip(on, off))
    log(f"[{tag}] speculation off against on, the same sharded engine: {equal} of {len(on)} "
        f"requests token-equal, shared tokens' logprobs within {dl:.3g}; where they part (the "
        f"one-rank engine's step under each mode; a near tie is within {margin:.4g}): {parts}")
    return dict(equal=equal, requests=len(on), logprob_diff=dl, parts=parts, margin=margin,
                above_level=over)


def phase_tp(torch, p, smi_line, n_layers=8):
    """[tp]: the slice's model (Llama-2-7B widths cut to 8 layers to keep the
    script within its time limit, [spec-tp] running the tp path at full
    depth; int4 g128 from seed 0, packed int4 KV packed per tp shard) at
    tensor_parallel 2, served
    by two `python -m tpuserve_torch.server` processes joined by the
    TPUSERVE_* variables (process 0 the REST front, process 1 its follower;
    both on the card, gloo): a load and 4 concurrent greedy /generate
    requests over REST, every rank's launches at the shard shapes and its
    memory at load, rank 0's device time over one more request (the front's
    /profile), then SIGINT; the one-rank engine's tokens on the same weights
    after, and each kernel against its plain version on each rank's blocks
    at its shard shapes."""
    import dataclasses as dc
    import signal

    from tpuserve_torch.parallel.distributed import free_port

    p = dc.replace(p, n_layers=n_layers)
    cfg = dict(_model_config(p), name="llama2_7b_int4_tp2", sharding={"tensor_parallel": 2})
    prompts = _mesh_prompts(torch, p, (5, 90, 33, 150), 23)
    new = 16
    tmp = _write_repo(cfg)
    port, rest = free_port(), free_port()
    url = f"http://127.0.0.1:{rest}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUSERVE_")}
    env.update(TPUSERVE_COORDINATOR=f"127.0.0.1:{port}", TPUSERVE_NUM_PROCESSES="2",
               TPUSERVE_DIST_TIMEOUT="300")
    os.makedirs(OUT_DIR, exist_ok=True)
    logs = [os.path.join(OUT_DIR, f"tp_rank{r}.log") for r in range(2)]
    procs = []
    t_start = time.monotonic()
    for r in range(2):
        with open(logs[r], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpuserve_torch.server", "--repository", tmp, "--host",
                 "127.0.0.1", "--port", str(rest)], env=dict(env, TPUSERVE_PROCESS_ID=str(r)),
                stdout=fh, stderr=subprocess.STDOUT))
    name = cfg["name"]
    try:
        while True:
            if any(pr.poll() is not None for pr in procs):
                fail(f"[tp] a rank exited before the front answered; see {logs}")
            try:
                if _http("GET", url + "/health", timeout=10)[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > t_start + 180:
                fail(f"[tp] the front did not answer /health in 180 s; see {logs}")
            time.sleep(0.5)
        t0 = time.monotonic()
        status, body = _http("POST", f"{url}/models/{name}/load")
        load_s = time.monotonic() - t0
        if status != 202:
            fail(f"[tp] load answered {status}: {body}")

        def serving():
            status, body = _http("GET", url + "/metrics")
            if status != 200:
                fail(f"[tp] /metrics answered {status}: {body}")
            return body["models"][f"{name}:1"]["serving"]

        before = serving()
        got, wall = _mesh_wave(lambda i: _http("POST", f"{url}/models/{name}/generate",
                                              {"input_ids": prompts[i], "max_new_tokens": new,
                                               "logprobs": True})[1], len(prompts), "tp")
        after = serving()
        if any("generated_ids" not in g or len(g["generated_ids"]) != new for g in got):
            fail(f"[tp] a request did not return {new} tokens: {got}")
        steps = after["decode_steps"] - before["decode_steps"]
        prefills = after["prefill_calls"] - before["prefill_calls"]
        deltas = _rank_deltas(before["ranks"], after["ranks"])
        log(f"[tp] 2 CLI ranks ({after['mesh']}): load over REST {load_s:.1f} s; "
            f"{len(prompts)} concurrent greedy requests of {new} tokens in {wall:.2f} s "
            f"({len(prompts) * new / wall:.1f} tok/s); decode steps {steps}, prefill calls "
            f"{prefills}")
        _check_ranks("tp", deltas, 2, 4 * p.n_layers + 1, p.n_layers, steps, prefills,
                     qmm_shapes=_qmm_shard_shapes(p, 2), smi_line=smi_line)
        core = f"decode_attention 64x256x{p.n_kv_heads * p.head_dim // 4}"  # packed bytes
        for d in deltas:
            if d["shard_launches"].get(core, 0) != p.n_layers * steps:
                fail(f"[tp] rank {d['rank']}: the core did not run on its {p.n_kv_heads // 2} "
                     f"kv heads ({core}): {d['shard_launches']}")
        profile = _tp_front_profile(url, name, prompts[0], p.n_layers, smi_line)
        t0 = time.monotonic()
        procs[0].send_signal(signal.SIGINT)
        codes = [pr.wait(timeout=120) for pr in procs]
        down_s = time.monotonic() - t0
        if codes != [0, 0]:
            fail(f"[tp] ranks exited {codes} on SIGINT; see {logs}")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait(timeout=60)
    mgr, engine, ref = _mesh_reference(torch, cfg, prompts, new, "tp")
    gate = _mesh_gate(torch, engine, p, prompts, ref, got, "tp")
    checks = _shard_kernel_checks(torch, "tp", engine, engine, (2, 1, 1), deltas,
                                  max(map(len, prompts)) + new - 2)
    memory = _check_rank_memory("tp", deltas, engine._param_bytes, 2)
    mgr.shutdown()
    log(f"[tp] SIGINT: both ranks exit 0 in {down_s:.2f} s; card {smi_line}")
    launches = dict(quant_matmul=sum(d["quant_matmul_launches"] for d in deltas),
                    decode_attention=sum(d["decode_attention_launches"] for d in deltas))
    return dict(launches=launches, ranks=deltas, decode_steps=steps, prefill_calls=prefills,
                wall_s=wall, load_s=load_s, sigint_s=down_s, gate=gate, mesh=after["mesh"],
                memory=memory, kernel_checks=checks, profile_rank0=profile)


def _tp_front_profile(url, name, prompt, n_layers, smi_line):
    """Rank 0's device time over one request through the front's
    /profile/start and /profile/stop (torch.profiler in the front's process:
    the follower rank's process is not traced): a prompt of its tokens and
    8 new ones, one prefill and 7 decode steps. The Chrome trace's device
    rows (kernels, copies, sets) summed, by kind, and the decode steps in it
    counted by the flat core's launches."""
    trace_dir = os.path.join(OUT_DIR, "tp_trace")
    if _http("POST", url + "/profile/start", {"dir": trace_dir})[0] != 200:
        fail("[tp] /profile/start")
    t0 = time.monotonic()
    status, body = _http("POST", f"{url}/models/{name}/generate",
                         {"input_ids": prompt, "max_new_tokens": 8})
    wall_ms = (time.monotonic() - t0) * 1e3
    status, stopped = _http("POST", url + "/profile/stop")
    if status != 200:
        fail(f"[tp] /profile/stop: {status} {stopped}")
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    share = dict(quant_matmul=0.0, core=0.0, copies=0.0, other=0.0)
    cores = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        key = e.get("name", "")
        kind = "quant_matmul" if "qmm_" in key else "core" if "attn_core" in key \
            else "copies" if e["cat"] == "gpu_memcpy" else "other"
        share[kind] += e.get("dur", 0) / 1e3
        cores += kind == "core"
    subprocess.run(["rm", "-rf", trace_dir], check=False)
    busy = sum(share.values())
    steps = cores / n_layers
    log(f"[tp] rank 0 profiled over one request (front's /profile; {steps:g} decode steps and "
        f"its prefill): host clock {wall_ms:.1f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.2f}%): quant-matmul {share['quant_matmul']:.3f}, flat core "
        f"{share['core']:.3f}, copies {share['copies']:.3f}, other {share['other']:.3f} ms; "
        f"card {smi_line} (ranks share the card over gloo; rank 1 not traced)")
    if not busy:
        log("[tp] the profiler recorded no device time (not measured)")
    return dict(host_ms=wall_ms, busy_ms=busy, decode_steps=steps,
                **{f"{k}_ms": v for k, v in share.items()})


def _twin_gate(tag, twin, ref, got):
    """The sharded run against its arithmetic twin (an engine of the same
    sharding arithmetic, `twin`): every request's tokens equal and the
    logprobs within 0.05."""
    dl = max([abs(a - b) for r, g in zip(ref, got) for a, b in zip(r["logprobs"], g["logprobs"])],
             default=0.0)
    equal = sum(r["generated_ids"] == g["generated_ids"] for r, g in zip(ref, got))
    log(f"[{tag}] against its arithmetic twin (sharding {twin}, the same knobs): {equal} of "
        f"{len(ref)} requests token-equal, logprobs within {dl:.3g}")
    if equal != len(ref) or not dl <= 0.05:
        fail(f"[{tag}] the sharded run parts from its twin {twin}: {equal} of {len(ref)} equal, "
             f"logprobs within {dl}")
    return dict(twin=twin, equal=equal, requests=len(ref), logprob_diff=dl)


def _parting_record(torch, tag, engine, p, prompts, ref, got):
    """A record (not a gate) of the sharded run against the one-rank
    engine: requests token-equal, shared tokens' logprobs, and where a
    request parts the one-rank engine's own top-two gap at that step."""
    parts, dl = [], 0.0
    for i, (r, g) in enumerate(zip(ref, got)):
        d = _first_diff(r["generated_ids"], g["generated_ids"])
        n = len(r["generated_ids"]) if d is None else d
        dl = max([dl] + [abs(a - b) for a, b in zip(r["logprobs"][:n], g["logprobs"][:n])])
        if d is not None:
            gap, route = _step_margins(torch, engine, p, list(prompts[i]), r["generated_ids"][:d])
            parts.append(dict(request=i, token=d, top2_gap=gap, route_gap=route))
    equal = len(ref) - len(parts)
    log(f"[{tag}] record: against the one-rank engine, {equal} of {len(ref)} requests "
        f"token-equal, shared tokens' logprobs within {dl:.3g}; where they part: {parts}")
    return dict(equal=equal, logprob_diff=dl, parts=parts)


def _engine_ranks_phase(torch, p, smi_line, tag, cfg, prompts, new, per_call, attn, shapes,
                        ref_env=(), record=False, twin=None):
    """An engine-started mesh: InferenceManager loads cfg, whose engine
    starts its follower ranks (logs in chiprun_out/<tag>_ranks/); a wave of
    concurrent greedy requests with every rank's launches checked; unload
    (the ranks exit); then the one-rank engine's tokens on the same weights
    under the knobs ref_env (the sharded path's arithmetic), and with
    `record` also on its defaults, as a record. Under pipeline_parallel the
    launches are checked a decode step and a prefill (_check_pp_ranks) and
    the kernels on each rank's stage block (_stage_kernel_checks). With
    `twin` (a sharding) the tokens are held to an engine of that sharding
    instead, the sharded run's arithmetic twin, and the one-rank engine is
    a record (_parting_record)."""
    from tpuserve_torch.engine.manager import InferenceManager

    log_dir = os.path.join(OUT_DIR, f"{tag}_ranks")
    with env_set("TPUSERVE_FOLLOWER_LOG_DIR", log_dir), env_set("TPUSERVE_DIST_TIMEOUT", "300"):
        mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()   # rank 0 lives in this process
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        mgr.load_model(cfg["name"])
        load_s = time.monotonic() - t0
        engine = mgr.get_model(cfg["name"]).backend.engine
        world = engine.mesh.size
        before = engine.rank_stats()
        s0, f0 = engine.steps, engine.prefill_calls
        got, wall = _mesh_wave(lambda i: engine.generate(prompts[i], max_new_tokens=new,
                                                         logprobs=True), len(prompts), tag)
        steps, prefills = engine.steps - s0, engine.prefill_calls - f0
        deltas = _rank_deltas(before, engine.rank_stats(cache=True))
        stats = engine.serving_stats()
        log(f"[{tag}] {world} engine-started ranks ({stats['mesh']}): load {load_s:.1f} s; "
            f"{len(prompts)} concurrent greedy requests of {new} tokens in {wall:.2f} s; decode "
            f"steps {steps}, prefill calls {prefills}")
        pp = engine.mesh.shape["pp"]
        if pp > 1:
            _check_pp_ranks(tag, deltas, world, p, pp, steps, prefills, shapes, smi_line)
        else:
            _check_ranks(tag, deltas, world, per_call, p.n_layers, steps, prefills,
                         dp=engine.mesh.shape["dp"], attn=attn, qmm_shapes=shapes,
                         smi_line=smi_line)
        sizes = (engine.mesh.shape["tp"], engine.mesh.shape["dp"], engine.mesh.shape["sp"])
        # every rank profiles the same decode dispatch of one more request
        engine.profile_next_decode()
        engine.generate(prompts[0], max_new_tokens=4)
        profiles = [r["decode_profile"] and _profile_summary(r["decode_profile"])
                    for r in engine.rank_stats()]
        _log_profiles(tag, profiles, deltas, smi_line)
        followers = list(engine._followers)
        mgr.shutdown()
        if any(f.poll() is None for f in followers) or any(f.returncode for f in followers):
            fail(f"[{tag}] follower ranks did not exit cleanly: "
                 f"{[f.returncode for f in followers]}; see {log_dir}")
    if twin is not None:
        with env_set("TPUSERVE_FOLLOWER_LOG_DIR", log_dir + "_twin"), \
                env_set("TPUSERVE_DIST_TIMEOUT", "300"):
            twin_mgr, _, twin_ref = _mesh_reference(torch, cfg, prompts, new, tag + " twin",
                                                    ref_env, sharding=twin)
            twin_mgr.shutdown()
        gate = _twin_gate(tag, twin, twin_ref, got)
    ref_mgr, ref_engine, ref = _mesh_reference(torch, cfg, prompts, new, tag, ref_env)
    with contextlib.ExitStack() as stack:
        for key, val in ref_env:
            stack.enter_context(env_set(key, val))
        if twin is None:
            gate = _mesh_gate(torch, ref_engine, p, prompts, ref, got, tag)
        else:
            gate["one_rank"] = _parting_record(torch, tag, ref_engine, p, prompts, ref, got)
    if pp > 1:
        checks = _stage_kernel_checks(torch, tag, ref_engine, (pp, sizes[0]), deltas)
    else:
        checks = _shard_kernel_checks(torch, tag, ref_engine, ref_engine, sizes, deltas,
                                      max(map(len, prompts)) + new - 2)
    memory = _check_rank_memory(tag, deltas, ref_engine._param_bytes, sizes[0] * pp,
                                base=(base,))
    ref_mgr.shutdown()
    if record:   # the one-rank engine on its defaults
        ref_mgr, ref_engine, ref = _mesh_reference(torch, cfg, prompts, new, tag)
        dl = max([abs(a - b) for r, g in zip(ref, got)
                  for a, b in list(zip(r["logprobs"], g["logprobs"]))[
                      :_first_diff(r["generated_ids"] + [-1], g["generated_ids"] + [-2])]],
                 default=0.0)
        equal = sum(r["generated_ids"] == g["generated_ids"] for r, g in zip(ref, got))
        log(f"[{tag}] record: against the one-rank engine on its defaults, "
            f"{equal} of {len(got)} requests token-equal, shared tokens' logprobs within "
            f"{dl:.3g}")
        gate["vs_defaults"] = dict(equal=equal, logprob_diff=dl)
        ref_mgr.shutdown()
    return dict(ranks=deltas, decode_steps=steps, prefill_calls=prefills, wall_s=wall,
                load_s=load_s, gate=gate, mesh=stats["mesh"], memory=memory,
                prefix_hits=stats.get("prefix_hits"),
                kernel_checks=checks, profiles=profiles,
                launches=dict(quant_matmul=sum(d["quant_matmul_launches"] for d in deltas),
                              decode_attention=sum(d["decode_attention_launches"]
                                                   for d in deltas)))


def _stage_qmm_shapes(p, tp):
    """The quant-matmul's local K x N in a pipeline stage: wqkv and w_gateup
    column shards (after _tp_shuffle_cols), wo and w_down row shards, the
    lm_head whole on every stage; at 7B tp 1: 4096x12288, 4096x4096,
    4096x22016, 11008x4096, 4096x32000; tp 2: 4096x6144, 2048x4096,
    4096x11008, 5504x4096, 4096x32000."""
    qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim
    ffn = () if p.n_experts else (f"{p.dim}x{2 * p.ffn_dim // tp}", f"{p.ffn_dim // tp}x{p.dim}")
    return (f"{p.dim}x{(qd + 2 * kvd) // tp}", f"{qd // tp}x{p.dim}") + ffn \
        + (f"{p.dim}x{p.vocab_size}",)


def _check_pp_ranks(tag, deltas, world, p, pp, steps, prefills, shapes, smi_line):
    """Every rank of a pipeline mesh (dp 1) launched the quant-matmul 4 *
    n_layers + 1 times a decode step (its n_layers/pp layers over each of
    the pp microbatches, and the lm_head) and 4 * n_layers/pp + 1 times a
    prefill (a MoE model, in the dense loop: 2 + 2E a layer, 2E of them on
    its own layers' expert views), each layer shape n_layers times a step
    and n_layers/pp a prefill and the lm_head once a call, on the card; no
    decode-attention kernel (the stage attends by einsum) and no plain
    version."""
    lp = p.n_layers // pp
    if len(deltas) != world:
        fail(f"[{tag}] {len(deltas)} ranks answered, expected {world}")
    # a MoE layer: wqkv, wo and each expert's gate|up and down (the dense loop)
    per_layer = 2 + 2 * p.n_experts if p.n_experts else 4
    want = steps * (per_layer * p.n_layers + 1) + prefills * (per_layer * lp + 1)
    layer_want = steps * p.n_layers + prefills * lp
    for r, d in enumerate(deltas):
        if d["quant_matmul_launches"] != want:
            fail(f"[{tag}] rank {r}: {d['quant_matmul_launches']} quant-matmuls, not {want} "
                 f"({per_layer * p.n_layers + 1} a decode step over {steps}, "
                 f"{per_layer * lp + 1} a prefill over {prefills})")
        experts = d["shard_launches"].get(f"quant_matmul experts {p.n_experts}", 0)
        if p.n_experts and experts != 2 * p.n_experts * layer_want:
            fail(f"[{tag}] rank {r}: {experts} expert-view launches, not "
                 f"{2 * p.n_experts * layer_want} (its {lp} layers' {p.n_experts} experts, "
                 f"gate|up and down, over {steps} decode steps and {prefills} prefills)")
        if d["decode_attention_launches"] or d["decode_attention_paged_launches"]:
            fail(f"[{tag}] rank {r}: a decode-attention kernel ran in the stage: {d}")
        if d["plain_calls"] or d["plain_row_shards"]:
            fail(f"[{tag}] rank {r} ran a plain version: {d}")
        if not d["device"].startswith("cuda") or d["backend"] != "gloo":
            fail(f"[{tag}] rank {r} ran on {d['device']} over {d['backend']}")
        for i, shape in enumerate(shapes):
            got = d["shard_launches"].get(f"quant_matmul {shape}", 0)
            if got != (steps + prefills if i == len(shapes) - 1 else layer_want):
                fail(f"[{tag}] rank {r}: {got} quant-matmuls at the stage shape {shape}: "
                     f"{d['shard_launches']}")
        log(f"[{tag}] rank {r} ({d['device']}, {d['backend']}): quant-matmul "
            f"{d['quant_matmul_launches']} = {per_layer * p.n_layers + 1} a decode step x "
            f"{steps} + {per_layer * lp + 1} a prefill x {prefills}"
            f"{f', expert views {experts}' if p.n_experts else ''}; plain versions 0; "
            f"at stage shapes "
            f"{d['shard_launches']}; decode step host clock median {d['step_host_ms']:.2f} ms; "
            f"card {smi_line} (ranks share the card over gloo: not a multi-GPU speed)")


def _stage_kernel_checks(torch, tag, weights, cut, deltas):
    """Each rank's stage block cut from the one-rank engine's weights
    (stack_layer_params, then place_pipeline_params: its checksum must equal
    the rank's own, and its bytes are its n_layers/pp layers and the shared
    params), and row 1 on it against its plain version: its first layer's
    wqkv, wo, w_gateup and w_down (a MoE stage: each of its first layer's
    experts' gate|up and down views) at one microbatch's rows (S / pp) and
    the lm_head at the rank's slots, x ~ N(0, 1) in bf16, within one bf16
    step at the largest output."""
    from tpuserve_torch.models.llama_bench import param_bytes
    from tpuserve_torch.ops.quant_matmul import quant_matmul_plain
    from tpuserve_torch.parallel.mesh import Mesh
    from tpuserve_torch.parallel.pipeline import (_layer_view, place_pipeline_params,
                                                  stack_layer_params)
    from tpuserve_torch.parallel.sharding import block_fingerprint, qmatmul_local
    from tpuserve_torch.quant.core import qmatmul

    pp, tp = cut
    p = weights.p
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(19)
    stacked = stack_layer_params(weights.params, p, tp=tp)
    shared = sum(param_bytes({k: v}) for k, v in stacked.items()
                 if not k.startswith("stacked_layers/"))
    out = []
    for r in range(pp * tp):
        blk = place_pipeline_params(stacked, Mesh(tp, 1, 1, r, pp=pp))
        if block_fingerprint(blk) != deltas[r]["param_fingerprint"]:
            fail(f"[{tag}] rank {r}: its stage block's checksum differs from the stage cut of "
                 "the one-rank engine's weights")
        nbytes = param_bytes(blk)
        if nbytes != deltas[r]["param_bytes"]:
            fail(f"[{tag}] rank {r}: {deltas[r]['param_bytes']} bytes of blocks, the stage "
                 f"cut holds {nbytes}")
        view = _layer_view(blk, 0)
        checks = {}
        calls = [(name, rows, view[name] if name.startswith("L/") else blk[name], None)
                 for name, rows in (("L/wqkv/kernel", weights.n_slots // pp),
                                    ("L/wo/kernel", weights.n_slots // pp),
                                    ("L/w_gateup/kernel", weights.n_slots // pp),
                                    ("L/w_down/kernel", weights.n_slots // pp),
                                    ("lm_head/kernel", weights.n_slots))
                 if name in view or name in blk]
        for name in ("L/moe_gateup/kernel", "L/moe_down/kernel"):   # the stage's expert views
            if name in view:
                calls += [(name, weights.n_slots // pp, view[name].expert(e), e)
                          for e in range(view[name].n_experts)]
        for name, rows, qt, e in calls:
            k, n = qt.orig_shape
            x = torch.randn((rows, k), generator=gen, device=DEVICE).to(torch.bfloat16)
            ref = quant_matmul_plain(x, qt)
            got = qmatmul_local(x, qt, name, 0, 1) if e is None else qmatmul(x, qt)
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2 ** -7 * ref.float().abs().max().item()
            key = f"quant_matmul {k}x{n}" if e is None else f"quant_matmul expert {e} {k}x{n}"
            if not err <= tol:
                fail(f"[{tag}] rank {r}: {key}: max|kernel - plain| {err} > {tol}")
            checks[f"{key} (B {rows})"] = (err, tol)
        out.append(dict(rank=r, checks=checks, block_bytes=nbytes, shared_bytes=shared))
        log(f"[{tag}] rank {r}: stage block {nbytes / 2**30:.3f} GiB = its {p.n_layers // pp} "
            f"of {p.n_layers} layers{' cut over tp ' + str(tp) if tp > 1 else ''} + the shared "
            f"params {shared / 2**30:.3f} GiB (whole model {weights._param_bytes / 2**30:.3f} "
            "GiB); row 1 against its plain version at its stage shapes (max|err|, tol): "
            + "; ".join(f"{k_} {e:.3g} ({t:.3g})" for k_, (e, t) in checks.items()))
        del blk
    del stacked
    return out


def _pp_config(p, name, sharding, n_layers=None, **gen):
    """The slice's model (7B widths, int4 g128 from seed 0, 64 slots of 256)
    with int8 KV and no prefill chunks (the pipeline composes with none)."""
    import dataclasses as dc

    pc = p if n_layers is None else dc.replace(p, n_layers=n_layers)
    cfg = dict(_model_config(pc), name=name, sharding=sharding)
    cfg["quantization"] = dict(cfg["quantization"], kv_cache="int8")
    cfg["generation"] = dict(cfg["generation"], prefill_chunk=0, **gen)
    return pc, cfg


def phase_pp(torch, p, smi_line):
    """[pp]: the slice's model at full depth (32 layers, 16 a stage) at
    pipeline_parallel 2, int8 KV on the 5D stage caches, two engine-started
    ranks: 4 concurrent greedy requests of 16 tokens; each rank's
    launches at its stage shapes (129 a decode step, 65 a prefill), its
    load peak (half the layers and the shared params), its block checksum
    against the one-rank engine's stage cut, row 1 against its plain
    version, one profiled decode step. The stage attends by einsum (the JAX
    island's XLA path), so the tokens are held to the one-rank engine under
    TPUSERVE_DECODE_ATTN=xla, with the flat core's engine recorded beside."""
    pc, cfg = _pp_config(p, "llama2_7b_pp2", {"pipeline_parallel": 2})
    prompts = _mesh_prompts(torch, p, (5, 90, 33, 150), 23)
    return _engine_ranks_phase(torch, pc, smi_line, "pp", cfg, prompts, 16, None, attn=False,
                               shapes=_stage_qmm_shapes(pc, 1),
                               ref_env=(("TPUSERVE_DECODE_ATTN", "xla"),), record=True)


def phase_pp_tp(torch, p, smi_line, n_layers=8):
    """[pp-tp]: pipeline_parallel 2 x tensor_parallel 2 (four ranks), the
    slice's widths cut to 8 layers, int8 KV: each stage's layers cut over tp
    after the column regroup (row 1 at 4096x6144, 2048x4096, 4096x11008,
    5504x4096), one psum over tp after wo and w_down; the [pp] checks. A tp
    rank's row shards round their partial sums to bf16 before the psum, and
    this random model's residual stream carries outliers of ~10^3 that such
    rounding can flip at a step (measured on four H100s: one step's logits
    18.25 off the one-rank engine's, the hidden states parting at layer 1-2),
    so the tokens are held to the arithmetic twin, the tensor_parallel 2 engine
    without the pipeline (itself held to the one-rank engine by [tp]), under
    the same knobs, and the one-rank engine is recorded beside it."""
    pc, cfg = _pp_config(p, "llama2_7b_l8_pp2tp2", {"pipeline_parallel": 2,
                                                    "tensor_parallel": 2}, n_layers)
    prompts = _mesh_prompts(torch, p, (5, 90, 33, 150), 23)
    return _engine_ranks_phase(torch, pc, smi_line, "pp-tp", cfg, prompts, 16, None,
                               attn=False, shapes=_stage_qmm_shapes(pc, 2),
                               ref_env=(("TPUSERVE_DECODE_ATTN", "xla"),),
                               twin={"tensor_parallel": 2})


def phase_pp_paged(torch, p, smi_line, n_layers=8):
    """[pp-paged]: pipeline_parallel 2 over the 5D paged pool (int8, pages
    of 128, no prefix sharing: the JAX v1 scope), 8 layers: the stage
    writes its layers' pages and attends over the gathered window; the
    [pp] checks, the one-rank paged engine under TPUSERVE_DECODE_ATTN=xla
    as the reference."""
    pc, cfg = _pp_config(p, "llama2_7b_l8_pp2_paged", {"pipeline_parallel": 2}, n_layers,
                         paged=True, page_size=128, num_pages=0)
    prompts = _mesh_prompts(torch, p, (5, 90, 33, 150), 23)
    return _engine_ranks_phase(torch, pc, smi_line, "pp-paged", cfg, prompts, 16, None,
                               attn=False, shapes=_stage_qmm_shapes(pc, 1),
                               ref_env=(("TPUSERVE_DECODE_ATTN", "xla"),))


def phase_paged_tp(torch, p, smi_line, n_layers=8):
    """[paged-tp]: paged int8 flat pool (pages of 128, prefix sharing,
    chunks of one page) under tensor_parallel 2, the slice's widths cut to
    8 layers to keep the script within its time limit (the paged core's
    shard is the same at any depth), two
    engine-started ranks, the pool cut over tp on head boundaries (16 kv
    heads a rank) and its scales replicated: its own prompts, two of which
    share a 128-token first page (the second admitted in chunks, its first
    chunk a prefix hit); every rank's launches (129 quant-matmuls a call,
    the paged core 32 a decode step on its 16 kv heads), the paged core
    against its plain version on each rank's shard of the one-rank
    engine's served pool, and the tokens against the one-rank paged engine
    under the [tp] gate."""
    import dataclasses as dc

    p = dc.replace(p, n_layers=n_layers)
    cfg = dict(_paged_model_config(p), name="llama2_7b_int4_paged_tp2",
               sharding={"tensor_parallel": 2})
    a, b, c, d = _mesh_prompts(torch, p, (200, 72, 5, 33), 37)
    prompts = [a, a[:128] + b, c, d]
    res = _engine_ranks_phase(torch, p, smi_line, "paged-tp", cfg, prompts, 16,
                              4 * p.n_layers + 1, attn=False, shapes=_qmm_shard_shapes(p, 2))
    want = p.n_layers * res["decode_steps"]
    paged = 0
    for d_ in res["ranks"]:
        got = sum(v for k, v in d_["shard_launches"].items()
                  if k.startswith("decode_attention_paged ")
                  and k.endswith(f"x{p.n_kv_heads // 2 * p.head_dim}"))
        if d_["decode_attention_paged_launches"] != want or got != want:
            fail(f"[paged-tp] rank {d_['rank']}: {d_['decode_attention_paged_launches']} paged "
                 f"cores ({got} at its shard), not {want} ({p.n_layers} a decode step on its "
                 f"{p.n_kv_heads // 2} kv heads): {d_['shard_launches']}")
        paged += got
    if not res["prefix_hits"]:
        fail("[paged-tp] no prefix hit: the second prompt did not reuse the first one's page")
    log(f"[paged-tp] each rank launched the paged core {want} times ({p.n_layers} a decode "
        f"step over {res['decode_steps']}) on its {p.n_kv_heads // 2} kv heads; prefix hits "
        f"{res['prefix_hits']}")
    res["launches"] = dict(quant_matmul=res["launches"]["quant_matmul"],
                           decode_attention_paged=paged)
    return res


def phase_dp_sp(torch, p, smi_line, n_layers=8):
    """[dp-sp]: the slice's widths cut to 8 layers with int8 KV on the 5D
    cache, data_parallel 2 x sequence_parallel 2 (four engine-started ranks:
    slots over dp, the L window of 256 over sp, the flash-decoding merge in
    plain torch as the JAX island is XLA), prompts of 160 and 200 tokens
    spanning both sp halves (admitted in chunks of 64). The merge's
    arithmetic is the einsum path's (bf16 dots, no int8 q or P), so the
    one-rank engine it is held to decodes under TPUSERVE_DECODE_ATTN=xla;
    its distance from the engine on the flat core is recorded beside it."""
    import dataclasses as dc

    pc = dc.replace(p, n_layers=n_layers)
    cfg = _model_config(pc)
    cfg.update(name="llama2_7b_l8_dp2sp2", sharding={"data_parallel": 2, "sequence_parallel": 2})
    cfg["quantization"] = dict(cfg["quantization"], kv_cache="int8")
    prompts = _mesh_prompts(torch, p, (5, 160, 40, 200), 29)
    return _engine_ranks_phase(torch, pc, smi_line, "dp-sp", cfg, prompts, 16,
                               4 * pc.n_layers + 1, attn=False, shapes=_qmm_shard_shapes(pc, 1),
                               ref_env=(("TPUSERVE_DECODE_ATTN", "xla"),), record=True)


def phase_mixtral_tp(torch, p_moe, smi_line, n_layers=4):
    """[mixtral-tp]: the Mixtral-8x7B-width MoE at 4 layers, tensor_parallel
    2 (two engine-started ranks): each rank holds 4 of the 8 experts (E over
    tp) and launches only their views, the attention on its 4 kv heads (GQA
    rep 4) over int8 KV. Over packed int4 KV a request parted from the
    one-rank engine at a step whose top two lie 0.14 apart (an H100), so
    packed int4 at a rank's width is held kernel against plain on a served
    int4 cache instead (_mixtral_int4_record), beside a record of how far
    int4 KV parts two roundings of the one-rank engine. Under a mesh every
    expert runs over every row (the JAX package's mesh branch), so the
    one-rank engine it is held to runs the dense loop too (TPUSERVE_MOE_CF=0:
    its capacity dispatch drops the pairs past an expert's capacity)."""
    import dataclasses as dc

    pc = dc.replace(p_moe, n_layers=n_layers)
    cfg = dict(_mixtral_config(pc), name="mixtral_l4_tp2", sharding={"tensor_parallel": 2})
    cfg["quantization"] = dict(cfg["quantization"], kv_cache="int8")
    prompts = _mesh_prompts(torch, p_moe, (5, 90, 33, 150), 31)
    e_loc = pc.n_experts // 2
    res = _engine_ranks_phase(torch, pc, smi_line, "mixtral-tp", cfg, prompts, 16,
                              (2 + 2 * e_loc) * pc.n_layers + 1, attn=True,
                              shapes=_qmm_shard_shapes(pc, 2),
                              ref_env=(("TPUSERVE_MOE_CF", "0"),), record=True)
    want = 2 * e_loc * pc.n_layers * (res["decode_steps"] + res["prefill_calls"])
    experts = 0
    for d in res["ranks"]:
        own = d["shard_launches"].get(f"quant_matmul experts {e_loc}", 0)
        if own != want:
            fail(f"[mixtral-tp] rank {d['rank']}: {own} expert-view launches, not {want} "
                 f"(its {e_loc} experts' gate|up and down, a layer a call): "
                 f"{d['shard_launches']}")
        experts += own
    res["launches"] = dict(quant_matmul=res["launches"]["quant_matmul"] - experts,
                           quant_matmul_experts=experts,
                           decode_attention_gqa=res["launches"]["decode_attention"])
    log(f"[mixtral-tp] each rank launched only its {e_loc} experts' views: {want} a rank")
    res["int4"] = _mixtral_int4_record(torch, pc, cfg, prompts, 16, res["ranks"])
    return res


def phase_pp_mixtral(torch, p_moe, smi_line, n_layers=4):
    """[pp-mixtral]: the Mixtral-8x7B-width MoE (published widths) cut to 4
    layers at pipeline_parallel 2 (2 layers a stage), int8 KV on the 5D
    stage caches (the JAX package refuses int4 KV under pp), two
    engine-started ranks: each rank's launches a decode step and a prefill
    exact, its expert views those of its own two layers only
    (_check_pp_ranks), row 1 on each stage block's expert views against the
    plain version (_stage_kernel_checks). The stage runs the MoE's dense loop
    (TPUSERVE_MOE_CF=0 for every rank: no capacity drops) and attends by
    einsum, so the tokens are held to the one-rank engine under the same
    knobs and TPUSERVE_DECODE_ATTN=xla, as tests/test_torch_pipeline.py's
    pp x MoE case holds the JAX island."""
    import dataclasses as dc

    pc = dc.replace(p_moe, n_layers=n_layers)
    cfg = dict(_mixtral_config(pc), name="mixtral_l4_pp2", sharding={"pipeline_parallel": 2})
    cfg["quantization"] = dict(cfg["quantization"], kv_cache="int8")
    cfg["generation"] = dict(cfg["generation"], prefill_chunk=0)
    prompts = _mesh_prompts(torch, p_moe, (5, 90, 33, 150), 31)
    with env_set("TPUSERVE_MOE_CF", "0"):   # set before the load: the ranks inherit it
        res = _engine_ranks_phase(
            torch, pc, smi_line, "pp-mixtral", cfg, prompts, 16, None, attn=False,
            shapes=_stage_qmm_shapes(pc, 1),
            ref_env=(("TPUSERVE_MOE_CF", "0"), ("TPUSERVE_DECODE_ATTN", "xla")))
    key = f"quant_matmul experts {pc.n_experts}"
    experts = sum(d["shard_launches"].get(key, 0) for d in res["ranks"])
    res["launches"] = dict(quant_matmul=res["launches"]["quant_matmul"] - experts,
                           quant_matmul_experts=experts)
    log(f"[pp-mixtral] expert-view launches over both stages: {experts}; card {smi_line}")
    return res


# ---------------------------------------------------------- speculation across ranks
def _periodic(vocab_size, n, seed):
    """A repetitive prompt of n tokens: a 12-token period drawn from numpy's
    default_rng(seed), repeated (seed 0, n 96: _periodic_prompt)."""
    import numpy as np

    period = np.random.default_rng(seed).integers(100, vocab_size - 1, 12).tolist()
    return (period * (n // 12 + 1))[:n]


def _verify_rows_expected(vlog, n_slots, max_len, dp, sp):
    """The candidate rows each (dp, sp) block takes over the verifies of
    `vlog` (the controller's (positions, lengths) of each): slot i's
    lengths[i] rows at positions[i] + j, in the dp group owning the slot and
    the sp window holding the position."""
    want = {}
    for positions, lens in vlog:
        for i, (pos, n) in enumerate(zip(positions, lens)):
            for j in range(int(n) if pos >= 0 else 0):
                key = (i * dp // n_slots, (int(pos) + j) * sp // max_len)
                want[key] = want.get(key, 0) + 1
    return want


def _check_spec_ranks(tag, deltas, world, p, mesh, gen, steps, prefills, vlog, shapes, paged,
                      smi_line):
    """Every rank of a speculating mesh ran each verify the controller
    published (verify_calls equal, none failed), launched the quant-matmul
    4 * n_layers + 1 times a call it ran (verifies, decode steps, its dp
    group's prefills) and exactly that many at a verify's S/dp * C rows at
    each shard shape, the flat core (a paged pool: the paged core) n_layers
    times a decode step between verifies (0 under sp, where the merge is
    plain torch, and where tp does not divide the kv heads, where every
    rank attends by einsum: `kv_replicated`), no plain version; and it wrote each verify's candidate rows of
    its own slots and L window and no others (its verify_rows_written
    against the count the controller's log gives its block)."""
    from tpuserve_torch.parallel.sharding import kv_replicated

    dp, sp, tp = mesh.shape["dp"], mesh.shape["sp"], mesh.shape["tp"]
    per_call = 4 * p.n_layers + 1
    c = int(gen["speculation_tokens"]) + 1
    s_loc = int(gen["max_slots"]) // dp
    verifies = len(vlog)
    decode_steps = steps - verifies
    rows = _verify_rows_expected(vlog, int(gen["max_slots"]), int(gen["max_seq_len"]), dp, sp)
    lm_head = f"{p.dim}x{p.vocab_size // tp}"
    if len(deltas) != world:
        fail(f"[{tag}] {len(deltas)} ranks answered, expected {world}")
    owned = [0] * dp
    for r, d in enumerate(deltas):
        if d["verify_calls"] != verifies or d["spec_disabled"]:
            fail(f"[{tag}] rank {r}: {d['verify_calls']} verify calls (the controller published "
                 f"{verifies}), speculation disabled {d['spec_disabled']}")
        if d["plain_calls"] or d["plain_row_shards"]:
            fail(f"[{tag}] rank {r} ran a plain version: {d}")
        calls, rest = divmod(d["quant_matmul_launches"], per_call)
        if rest or calls < steps:
            fail(f"[{tag}] rank {r}: {d['quant_matmul_launches']} quant-matmuls, not {per_call} "
                 f"a call over {steps} steps ({verifies} verifies) and its prefills")
        owned[d["coords"]["dp"]] = calls - steps
        core, other = ("decode_attention_paged_launches", "decode_attention_launches") if paged \
            else ("decode_attention_launches", "decode_attention_paged_launches")
        want_core = p.n_layers * decode_steps if sp == 1 and not kv_replicated(p, mesh) else 0
        if d[core] != want_core or d[other]:
            fail(f"[{tag}] rank {r}: {d[core]} {core}, expected {want_core} ({p.n_layers} a "
                 f"decode step over {decode_steps}); {d[other]} {other}")
        at_rows = {}
        for shape in shapes:
            key = f"quant_matmul {s_loc * c}x{shape}"
            want = verifies * (1 if shape == lm_head else p.n_layers)
            at_rows[key] = d["shard_launch_rows"].get(key, 0)
            if at_rows[key] != want:
                fail(f"[{tag}] rank {r}: {at_rows[key]} quant-matmuls at {key}, not {want} "
                     f"({verifies} verifies): {d['shard_launch_rows']}")
        block = (d["coords"]["dp"], d["coords"]["sp"])
        if d["verify_rows_written"] != rows.get(block, 0):
            fail(f"[{tag}] rank {r}: wrote {d['verify_rows_written']} candidate rows, its block "
                 f"{block} holds {rows.get(block, 0)} of the verifies' valid rows ({rows})")
        log(f"[{tag}] rank {r} ({d['device']}, {d['backend']}): verify calls {verifies}, "
            f"candidate rows written {d['verify_rows_written']} (its dp group's slots"
            f"{', its L window' if sp > 1 else ''}: {rows.get(block, 0)}); quant-matmul "
            f"{d['quant_matmul_launches']}, at a verify's {s_loc * c} rows {at_rows}; "
            f"{core} {d[core]}; plain versions 0; card {smi_line} (ranks share the card over "
            "gloo)")
    if sum(owned) != prefills:
        fail(f"[{tag}] the dp groups ran {owned} prefills, the controller {prefills}")
    return rows


def _spec_mesh_phase(torch, p, smi_line, tag, cfg, prompts, new, shapes, paged=False,
                     ref_env=(("TPUSERVE_DECODE_ATTN", "xla"),), warm=()):
    """A speculating engine-started mesh: InferenceManager loads cfg (logs in
    chiprun_out/<tag>_ranks/); a wave of concurrent greedy requests with
    speculation on, every rank's verifies, launches and candidate rows
    checked (_check_spec_ranks), drafts made and accepted; the same wave on
    the same engine with speculation off (no verify on any rank); unload.
    Then the one-rank speculative engine on the same weights under the
    knobs `ref_env` (the sharded path's arithmetic: TPUSERVE_DECODE_ATTN=xla
    where the mesh verifies by einsum and the one-rank engine would run the
    multi-candidate kernel) serves the wave: the speculating run's tokens
    are held to it by _mesh_gate's near-tie rule, and the run with
    speculation off to the speculating one by _arith_gate;
    each kernel of the rank's path against its plain version at its shard
    shapes, the quant-matmul at a verify's rows (_shard_kernel_checks).
    Both engines serve the `warm` prompts one at a time before their waves
    (a paged engine's shared prefix then registered before any wave, so
    that which request hits it does not hang on the order of admission).
    Each wave's host-clock tokens/s is printed as a record of a gloo run.
    Each rank's load peak is held to its blocks and cache
    (_check_rank_memory) and every rank profiles one decode step after the
    waves (_log_profiles)."""
    from tpuserve_torch.engine.manager import InferenceManager

    gen = cfg["generation"]
    c = int(gen["speculation_tokens"]) + 1
    log_dir = os.path.join(OUT_DIR, f"{tag}_ranks")
    waves = {}
    with env_set("TPUSERVE_FOLLOWER_LOG_DIR", log_dir), env_set("TPUSERVE_DIST_TIMEOUT", "300"):
        mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()   # rank 0 lives in this process
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        mgr.load_model(cfg["name"])
        load_s = time.monotonic() - t0
        engine = mgr.get_model(cfg["name"]).backend.engine
        mesh, world = dict(engine.mesh.shape), engine.mesh.size
        for w in warm:
            engine.generate(w, max_new_tokens=2)
        for mode in ("on", "off"):
            if mode == "off":   # the controller's knob: the same engine, speculation off
                engine.config.generation.speculation_tokens = 0
            before = engine.rank_stats()
            base = dict(steps=engine.steps, prefills=engine.prefill_calls,
                        log=len(engine.verify_log), drafted=engine.spec_drafted,
                        accepted=engine.spec_accepted)
            got, wall = _mesh_wave(lambda i: engine.generate(prompts[i], max_new_tokens=new,
                                                             logprobs=True),
                                   len(prompts), f"{tag} spec {mode}")
            deltas = _rank_deltas(before, engine.rank_stats(cache=True))
            w = dict(got=got, wall_s=wall, deltas=deltas, steps=engine.steps - base["steps"],
                     prefills=engine.prefill_calls - base["prefills"],
                     vlog=list(engine.verify_log)[base["log"]:],
                     drafted=engine.spec_drafted - base["drafted"],
                     accepted=engine.spec_accepted - base["accepted"],
                     tok_s=len(prompts) * new / wall)
            waves[mode] = w
            log(f"[{tag}] speculation {mode}: {len(prompts)} concurrent greedy requests of {new} "
                f"tokens in {wall:.2f} s, {w['tok_s']:.2f} tok/s on the host clock (a record of "
                f"{world} gloo ranks sharing one card, not a speed; card {smi_line}); steps "
                f"{w['steps']} ({len(w['vlog'])} verifies), prefill calls {w['prefills']}, "
                f"drafted {w['drafted']}, accepted {w['accepted']}")
        on, off = waves["on"], waves["off"]
        if not on["drafted"] or not on["accepted"] or not on["vlog"]:
            fail(f"[{tag}] speculation on: drafted {on['drafted']}, accepted {on['accepted']}, "
                 f"verifies {len(on['vlog'])}")
        rows = _check_spec_ranks(tag, on["deltas"], world, p, engine.mesh, gen, on["steps"],
                                 on["prefills"], on["vlog"], shapes, paged, smi_line)
        if off["vlog"] or any(d["verify_calls"] for d in off["deltas"]):
            fail(f"[{tag}] speculation off still verified: "
                 f"{[d['verify_calls'] for d in off['deltas']]}")
        half = int(gen["max_seq_len"]) // mesh["sp"]
        crossed = sum(1 for pos, lens in on["vlog"] for a, n in zip(pos, lens)
                      if a >= 0 and n > 1 and a // half != (a + n - 1) // half) \
            if mesh["sp"] > 1 else None
        stats = engine.serving_stats()
        # speculation is off: the next dispatch is a decode step
        engine.profile_next_decode()
        engine.generate(prompts[0], max_new_tokens=4)
        profiles = [r["decode_profile"] and _profile_summary(r["decode_profile"])
                    for r in engine.rank_stats()]
        _log_profiles(tag, profiles, off["deltas"], smi_line)
        followers = list(engine._followers)
        mgr.shutdown()
        if any(f.poll() is None for f in followers) or any(f.returncode for f in followers):
            fail(f"[{tag}] follower ranks did not exit cleanly: "
                 f"{[f.returncode for f in followers]}; see {log_dir}")
    if paged and not stats.get("prefix_hits"):
        fail(f"[{tag}] no prefix hit")
    ref_mgr, ref_engine, ref = _mesh_reference(torch, cfg, prompts, new, tag, ref_env,
                                               warm=warm)
    with contextlib.ExitStack() as stack:
        for key, val in ref_env:
            stack.enter_context(env_set(key, val))
        gate = _mesh_gate(torch, ref_engine, p, prompts, ref, on["got"], tag, ulp_rule=True)
    gate_off = _arith_gate(torch, ref_engine, p, prompts, on["got"], off["got"], tag,
                           sp=mesh["sp"])
    sizes = (mesh["tp"], mesh["dp"], mesh["sp"])
    checks = _shard_kernel_checks(torch, tag, ref_engine, ref_engine, sizes, on["deltas"],
                                  max(map(len, prompts)) + new - 2,
                                  qmm_rows=int(gen["max_slots"]) // mesh["dp"] * c)
    mem = _check_rank_memory(tag, on["deltas"], ref_engine._param_bytes, mesh["tp"],
                             base=(held,))
    ref_mgr.shutdown()
    log(f"[{tag}] verify rows by (dp, sp) block: {rows}; verifies whose candidates straddle "
        f"two sp windows: {crossed}; prefix hits {stats.get('prefix_hits')}; load {load_s:.1f} s")
    d_on = on["deltas"]
    return dict(mesh=mesh, load_s=load_s, gate=gate, gate_off=gate_off, kernel_checks=checks,
                memory=mem, profiles=profiles,
                verify_rows={f"dp{d} sp{s_}": n for (d, s_), n in rows.items()},
                straddling_verifies=crossed, prefix_hits=stats.get("prefix_hits"),
                waves={m: {k: v for k, v in w.items() if k not in ("got", "vlog")}
                       for m, w in waves.items()},
                verifies=len(on["vlog"]),
                launches=dict(quant_matmul=sum(d["quant_matmul_launches"] for d in d_on),
                              decode_attention=sum(d["decode_attention_launches"] for d in d_on),
                              decode_attention_paged=sum(d["decode_attention_paged_launches"]
                                                         for d in d_on)))


def phase_spec_tp(torch, p, smi_line, n_layers=16):
    """[spec-tp]: the [spec] phase's model and settings (Llama-2-7B widths,
    int4 g128, int8 KV, 8 slots of 512, 8 drafts) cut to 16 of its 32
    layers (the deepest sharded phase; its gloo ranks' host-bound steps
    made it the script's most variable phase at 32) at tensor_parallel 2
    on engine-started ranks: 8 concurrent greedy requests of the periodic
    prompt, 64 tokens each; a verify runs 72 rows (8 slots x C 9) through
    each rank's shard shapes."""
    import dataclasses as dc

    pc = dc.replace(p, n_layers=n_layers)
    cfg = dict(_spec_model_config(pc), name="llama2_7b_l16_spec_tp2",
               sharding={"tensor_parallel": 2})
    prompts = [_periodic_prompt(p.vocab_size)] * 8
    return _spec_mesh_phase(torch, pc, smi_line, "spec-tp", cfg, prompts, 64,
                            _qmm_shard_shapes(pc, 2))


def phase_spec_dp_sp(torch, p, smi_line, n_layers=8):
    """[spec-dp-sp]: the [dp-sp] mesh with speculation: the [spec] setting
    (8 slots of 512, 8 drafts, int8 KV on the 5D cache) cut to 8 layers at
    data_parallel 2 x sequence_parallel 2 (four ranks: 4 slots a dp group,
    L windows of 256), periodic prompts admitted in chunks of 64, 64 tokens
    each: of 160 and 200 tokens (as [dp-sp]'s), and of 240 to 250, whose
    verifies reach the second window and straddle the two. The one-rank
    engine it is held to runs under TPUSERVE_DECODE_ATTN=xla (the verify's
    einsum, which the sharded verify's softmax over sp matches; its decode
    steps against the merge, as [dp-sp])."""
    import dataclasses as dc

    pc = dc.replace(p, n_layers=n_layers)
    cfg = dict(_spec_model_config(pc), name="llama2_7b_l8_spec_dp2sp2",
               sharding={"data_parallel": 2, "sequence_parallel": 2})
    cfg["generation"] = dict(cfg["generation"], prefill_chunk=64)
    prompts = [_periodic(p.vocab_size, n, 5 + i)
               for i, n in enumerate((160, 240, 200, 248, 244, 5, 250, 40))]
    return _spec_mesh_phase(torch, pc, smi_line, "spec-dp-sp", cfg, prompts, 64,
                            _qmm_shard_shapes(pc, 1))


def phase_spec_paged_tp(torch, p, smi_line, n_layers=8):
    """[spec-paged-tp]: the [paged-tp] setting (int8 pool of 128-token pages
    cut over tp, prefix sharing, chunks of one page, 64 slots of 256) cut to
    8 layers with 8 drafts, at tensor_parallel 2: 8 concurrent greedy
    requests of periodic prompts, two of which share their first 128-token
    page with a third (a prefix hit), 32 tokens each; a verify runs 576
    rows (64 slots x C 9). The one-rank paged engine verifies by einsum and
    decodes on the paged core too, so it is the reference on its defaults.
    The first prompt is served alone before the waves (in both engines), so
    that every request of its first page hits it: a hit attends over the
    int8 prefix page where a fresh prefill attends over its own K/V (one
    bf16 step of a first token's logits, ROADMAP), and a wave's order of
    admission would otherwise decide which request takes which path."""
    import dataclasses as dc

    pc = dc.replace(p, n_layers=n_layers)
    cfg = dict(_paged_model_config(pc), name="llama2_7b_l8_spec_paged_tp2",
               sharding={"tensor_parallel": 2})
    cfg["generation"] = dict(cfg["generation"], speculation_tokens=8, speculation_min_gain=0)
    a = _periodic(p.vocab_size, 200, 11)
    prompts = [a, a[:128] + _periodic(p.vocab_size, 60, 12), _periodic(p.vocab_size, 40, 13),
               _periodic(p.vocab_size, 96, 14), a[:128] + _periodic(p.vocab_size, 30, 15),
               _periodic(p.vocab_size, 150, 16), _periodic(p.vocab_size, 5, 17),
               _periodic(p.vocab_size, 72, 18)]
    return _spec_mesh_phase(torch, pc, smi_line, "spec-paged-tp", cfg, prompts, 32,
                            _qmm_shard_shapes(pc, 2), paged=True, ref_env=(), warm=[a])


def gemma_2b_params(n_layers=18):
    """Gemma-2B's published widths and attention (google/gemma-2b
    config.json: hidden 2048, 8 query heads over 1 kv head of head_dim 256,
    intermediate 16384, vocab 256000, rms_norm_eps 1e-6, 18 layers) on the
    repo's Llama block (SwiGLU, an untied lm_head), cut to `n_layers`."""
    from tpuserve_torch.models.llama import LlamaParams

    return LlamaParams(vocab_size=256000, dim=2048, n_layers=n_layers, n_heads=8, n_kv_heads=1,
                       head_dim=256, ffn_dim=16384, rms_eps=1e-6)


def _whole_kv_bytes(p, cfg):
    """The bytes of the whole int8 cache of a one-rank engine on `cfg`:
    contiguous [n_layers, S, L, Hkv, hd] codes twice and [n_layers, S, Hkv,
    L] scales twice (kv_scale_dtype, bf16 by default), or the pool's
    (num_pages = S * pages a slot + 1; f32 scale pools of pad8(Hkv) rows a
    page)."""
    gen = cfg["generation"]
    hkv, hd, s, l = p.n_kv_heads, p.head_dim, int(gen["max_slots"]), int(gen["max_seq_len"])
    if not gen.get("paged"):
        scale = 4 if cfg["quantization"].get("kv_scale_dtype") == "float32" else 2
        return 2 * p.n_layers * s * l * hkv * (hd + scale)
    ps = int(gen["page_size"])
    pages = s * -(-l // ps) + 1
    return 2 * p.n_layers * pages * ps * (hkv * hd + 4 * ((hkv + 7) // 8 * 8))


def _check_replicas(tag, deltas, whole):
    """Every tp rank holds the whole cache (its bytes those of the one-rank
    engine's) and the replicas are byte-equal (the ranks' cache checksums)."""
    sizes = [d["cache_bytes"] for d in deltas]
    sums = {d["cache_fingerprint"] for d in deltas}
    if any(n != whole for n in sizes) or len(sums) != 1:
        fail(f"[{tag}] the ranks' caches are not the whole cache of {whole} bytes on every "
             f"rank, byte-equal: bytes {sizes}, checksums {sums}")
    log(f"[{tag}] every rank holds the whole cache ({whole} bytes) and the replicas are "
        f"byte-equal (checksum {sums.pop()})")


def phase_mqa_tp(torch, smi_line, n_layers=8):
    """[mqa-tp]: a tensor_parallel 2 mesh that does not divide the kv heads,
    at Gemma-2B's widths (`gemma_2b_params`: one kv head of 256, 8 query
    heads) cut to 8 of its 18 layers to keep the phase within its share of
    the script's time: int4 g128 drawn from seed 0, int8 KV (the JAX engine
    refuses int4 KV here), 8 slots of 512, two engine-started ranks sharing
    the card over gloo. Every rank keeps every kv head (the 5D cache or
    pool replicated over tp, as the JAX package's GSPMD path) and attends by
    einsum: no attention kernel; the quant-matmul at the rank's shard
    shapes (wqkv 2048x1280, wo 1024x2048, w_gateup 2048x16384, w_down
    8192x2048, lm_head 2048x128000). (a) contiguous, 4 greedy requests of
    16 tokens (the [tp] checks: exact launches, no plain call, each shard
    shape against its plain version, tokens against the one-rank engine
    under TPUSERVE_DECODE_ATTN=xla by the near-tie gate, load peak, a
    profiled decode step on every rank); (b) a paged int8 pool of 128-token
    pages with prefix sharing and 4 drafts on periodic prompts, 32 tokens
    each (the [spec-paged-tp] checks, a verify's rows at each shard shape,
    the same gate, load peak and profile). Both: every rank's cache is the
    whole cache, the replicas byte-equal."""
    pc = gemma_2b_params(n_layers)
    shapes = _qmm_shard_shapes(pc, 2)
    cfg = _model_config(pc)
    cfg.update(name="gemma_2b_l8_mqa_tp2", sharding={"tensor_parallel": 2})
    cfg["model_params"]["rms_eps"] = pc.rms_eps
    cfg["quantization"] = dict(cfg["quantization"], kv_cache="int8")
    cfg["generation"] = {"max_seq_len": 512, "max_slots": 8, "eos_token_id": -1,
                         "max_new_tokens": 32, "prefill_chunk": 64, "decode_horizon": 8}
    xla = (("TPUSERVE_DECODE_ATTN", "xla"),)
    prompts = _mesh_prompts(torch, pc, (5, 90, 33, 150), 41)
    contiguous = _engine_ranks_phase(torch, pc, smi_line, "mqa-tp", cfg, prompts, 16,
                                     4 * pc.n_layers + 1, attn=False, shapes=shapes,
                                     ref_env=xla)
    _check_replicas("mqa-tp", contiguous["ranks"], _whole_kv_bytes(pc, cfg))
    pcfg = dict(cfg, name="gemma_2b_l8_mqa_tp2_paged")
    pcfg["generation"] = dict(cfg["generation"], paged=True, page_size=128, num_pages=0,
                              prefix_sharing=True, prefill_chunk=128, speculation_tokens=4,
                              speculation_min_gain=0)
    a = _periodic(pc.vocab_size, 200, 11)
    pprompts = [a, a[:128] + _periodic(pc.vocab_size, 60, 12),
                _periodic(pc.vocab_size, 40, 13), _periodic(pc.vocab_size, 96, 14)]
    paged = _spec_mesh_phase(torch, pc, smi_line, "mqa-tp-paged", pcfg, pprompts, 32, shapes,
                             paged=True, ref_env=xla, warm=[a])
    _check_replicas("mqa-tp-paged", paged["waves"]["off"]["deltas"], _whole_kv_bytes(pc, pcfg))
    launched = contiguous["launches"]["quant_matmul"] + paged["launches"]["quant_matmul"]
    log(f"[mqa-tp] quant-matmul launches at the shard shapes {shapes}: {launched} "
        f"(contiguous {contiguous['launches']['quant_matmul']}, paged with speculation "
        f"{paged['launches']['quant_matmul']}); card {smi_line}")
    return dict(contiguous=contiguous, paged=paged, shapes=shapes,
                launches=dict(quant_matmul=launched))


def phase_native(torch, p, smi_line, n_layers=4):
    """[native]: libtpuserve.so built from native/src/*.cpp and native/include
    into native/build/ (CMake where it is installed, else the host
    compiler), found where the binding looks by default; then the [paged]
    configuration cut to 4 layers loaded through InferenceManager(device=
    "cuda"): the repository scan and the engine's page allocator must be
    the native ones; its greedy tokens (one request, then one that hits its
    first page, then two more) must equal the same engine's on
    `_PyKvAllocator`, swapped in by the phase, with the same prefix hit and
    every page back."""
    import dataclasses as dc
    import glob
    import shutil
    import subprocess

    from tpuserve_torch.bindings import native
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.serving import paged_kv

    out = os.path.join("native", "build")
    os.makedirs(out, exist_ok=True)
    if shutil.which("cmake"):
        gen_args = ["-G", "Ninja"] if shutil.which("ninja") else []
        cmds = [["cmake", "-S", "native", "-B", out] + gen_args,
                ["cmake", "--build", out, "--target", "tpuserve"]]
    else:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            fail("[native] no cmake and no C++ compiler to build native/")
        cmds = [[cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Inative/include"]
                + sorted(glob.glob("native/src/*.cpp"))
                + ["-o", os.path.join(out, "libtpuserve.so")]]
    t0 = time.monotonic()
    for cmd in cmds:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode:
            fail(f"[native] build failed: {' '.join(cmd)}: {res.stdout[-2000:]} "
                 f"{res.stderr[-2000:]}")
    build_s = time.monotonic() - t0
    lib = os.path.abspath(os.path.join(out, "libtpuserve.so"))
    pc = dc.replace(p, n_layers=n_layers)
    cfg = dict(_paged_model_config(pc), name="llama2_7b_l4_paged_native")
    a, b, c, d = _mesh_prompts(torch, p, (200, 72, 5, 33), 41)
    prompts = [a, a[:128] + b, c, d]

    def serve(what):
        mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
        try:
            mgr.load_model(cfg["name"])
            backend = mgr.get_model(cfg["name"]).backend
            engine = backend.engine
            tokens = [backend.generate(pr, max_new_tokens=16)["generated_ids"] for pr in prompts]
            st, back = _pages_back(engine, engine.cache.n_pages - 1)
            return dict(scan_native=mgr.repository.uses_native, allocator=engine.kv_allocator,
                        tokens=tokens, prefix_hits=st["prefix_hits"], pages_back=back,
                        pages=engine.cache.n_pages - 1, what=what)
        finally:
            mgr.shutdown()

    native.reset()
    try:
        with env_set("TPUSERVE_NATIVE_LIB", None), env_set("TPUSERVE_NATIVE", None):
            if not native.available():
                fail(f"[native] the binding did not load {lib}")
            version = native.version()
            nat = serve("native")
            saved = paged_kv.make_allocator
            paged_kv.make_allocator = paged_kv._PyKvAllocator
            try:
                py = serve("python")
            finally:
                paged_kv.make_allocator = saved
    finally:
        native.reset()
    log(f"[native] libtpuserve.so {version} built in {build_s:.1f} s "
        f"({' && '.join(c[0] for c in cmds)}); "
        f"native run: scan native {nat['scan_native']}, allocator {nat['allocator']}, prefix hits "
        f"{nat['prefix_hits']}, pages back {nat['pages_back']}/{nat['pages']}; the same engine "
        f"on {py['allocator']}: prefix hits {py['prefix_hits']}, pages back "
        f"{py['pages_back']}/{py['pages']}; tokens equal {nat['tokens'] == py['tokens']}; card "
        f"{smi_line}")
    if not nat["scan_native"] or nat["allocator"] != "NativeKvAllocator":
        fail(f"[native] the repository scan (native {nat['scan_native']}) or the allocator "
             f"({nat['allocator']}) is not the native runtime's")
    if py["allocator"] != "_PyKvAllocator":
        fail(f"[native] the swapped-in allocator is {py['allocator']}")
    if nat["tokens"] != py["tokens"]:
        fail(f"[native] greedy tokens differ between the native and Python allocators: "
             f"{nat['tokens']} vs {py['tokens']}")
    for run in (nat, py):
        if run["prefix_hits"] < 1 or run["pages_back"] != run["pages"]:
            fail(f"[native] {run['what']}: prefix hits {run['prefix_hits']}, pages back "
                 f"{run['pages_back']} of {run['pages']}")
    return dict(version=version, build_s=build_s, build=[c[0] for c in cmds],
                native={k: v for k, v in nat.items() if k != "tokens"},
                python={k: v for k, v in py.items() if k != "tokens"},
                tokens_equal=True)


def _mixtral_int4_record(torch, pc, cfg, prompts, new, deltas):
    """Packed int4 KV, as [mixtral] serves it: the one-rank engine (dense
    MoE loop) serves the requests; the flat core at a rank's 4 kv heads
    (64x256x256 packed bytes) is held against its plain version on each
    rank's block of that served cache, packed as a rank packs it. As a
    record, with no shard at all: the same engine under TPUSERVE_QMATMUL=xla
    (dequantize to bf16, then torch.matmul: the same model at another
    rounding), where its tokens part from the kernel route's, and the
    kernel route's top-two gap at that step beside the gate's margin."""
    cfg4 = dict(cfg, name=cfg["name"] + "_int4")
    cfg4["quantization"] = dict(cfg["quantization"], kv_cache="int4")
    dense = (("TPUSERVE_MOE_CF", "0"),)
    mgr, engine, ref = _mesh_reference(torch, cfg4, prompts, new, "mixtral-tp int4", dense)
    checks = _shard_kernel_checks(torch, "mixtral-tp int4", engine, engine, (2, 1, 1), deltas,
                                  max(map(len, prompts)) + new - 2)
    with env_set("TPUSERVE_MOE_CF", "0"):
        with env_set("TPUSERVE_QMATMUL", "xla"):
            other = _mesh_wave(lambda i: engine.generate(prompts[i], max_new_tokens=new,
                                                         logprobs=True),
                               len(prompts), "mixtral-tp int4 xla")[0]
        parts, dl = [], 0.0
        for i, (a, b) in enumerate(zip(ref, other)):
            d = _first_diff(a["generated_ids"], b["generated_ids"])
            n = len(a["generated_ids"]) if d is None else d
            dl = max([dl] + [abs(x - y) for x, y in zip(a["logprobs"][:n], b["logprobs"][:n])])
            if d is not None:
                gap, route = _step_margins(torch, engine, pc, list(prompts[i]),
                                           a["generated_ids"][:d])
                parts.append(dict(request=i, token=d, top2_gap=gap, route_gap=route))
    margin = 4 * dl + 1 / 32
    log(f"[mixtral-tp int4] record, one rank, packed int4 KV: the quant-matmul kernel route "
        f"against TPUSERVE_QMATMUL=xla: {len(prompts) - len(parts)} of {len(prompts)} requests "
        f"token-equal, shared tokens' logprobs within {dl:.3g}; where they part: {parts}; "
        f"the gate's margin would be {margin:.4g} (a part at a top-two gap above it, with no "
        "router near tie, fails the sharded gate)")
    mgr.shutdown()
    return dict(kernel_checks=checks, xla_parts=parts, xla_logprob_diff=dl, margin=margin)


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


def _serve_wave(backend, prompts, new, tag, **sampling):
    """One concurrent request per prompt (greedy unless `sampling` says
    otherwise), a thread each; fatal unless every one returns `new` tokens.
    Returns (token lists, wall seconds)."""
    import torch

    results, errors = [None] * len(prompts), []

    def run(i):
        try:
            results[i] = backend.generate(prompts[i], max_new_tokens=new, **sampling)
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
    # scripts/spec_tpu_check.py's other two checks, speculation on: sampling
    # at top_k=1 is a point mass, so the rejection-sampled path emits the
    # greedy tokens; free sampling completes
    topk1_tokens, _ = _serve_wave(backend, prompts, new, f"{tag}-top_k1", temperature=0.9,
                                  top_k=1, seed=7)
    topk1_diffs = [_first_diff(a, b) for a, b in zip(topk1_tokens, on_tokens)]
    free_tokens, _ = _serve_wave(backend, prompts, new, f"{tag}-sampled", temperature=0.8,
                                 seed=3)
    log(f"[{tag}] speculation on, temperature 0.9 with top_k=1: first token differing from "
        f"greedy per request (None = equal): {topk1_diffs}; free sampling at temperature 0.8: "
        f"{len(free_tokens)} requests of {new} tokens completed")

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
    topk1_gaps = _gate_served(torch, engine, p, prompts, on_tokens, topk1_tokens, 2 * seq_err,
                              tag, "greedy and top_k=1 sampling")

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
                topk1_first_diff=topk1_diffs, topk1_gaps=topk1_gaps,
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
    [spec] phase's shape (S=8, C=9, L=512, positions 100-400, bf16 scales);
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
    mkv, msc = packed(n_m, sm, lm, w2), scales(n_m, sm, hkv, lm, dtype=torch.bfloat16)
    qm = (torch.randn((sm, c, h, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
    cases.append(("multi", lambda fn, i: fn(qm, *mkv, msc[0][i % n_m], msc[1][i % n_m], pos_m,
                                            i % n_m, window=lm),
                  da.decode_attention_wide_cache_multi, da.decode_attention_wide_cache_multi_plain,
                  2 * live_m * (w2 + 2 * hkv)))
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


# ------------------------------------------------ head shapes (head_dim 256, GQA rep 8)
def phase_kernel_grid(torch):
    """[kernel-grid]: scripts/kernel_smoke_tpu.py's grid on the card
    (tpuserve_torch/scripts/kernel_smoke.py): the flat, multi (C = 4),
    paged, wide and grouped entries x Hkv {1, 2, 4, 8, 32} x rep {1, 4} x
    hd {128, 256} over int8 (f32 and bf16 scales), bf16 and packed int4,
    and rep 3, 7 and 8 at Hkv 8 over every cache, each one launch held to
    its plain version at the [kernel] checks' tolerance. A PASS/FAIL line a
    combination; any FAIL fails the run."""
    from tpuserve_torch.scripts import kernel_smoke

    rows, failures = kernel_smoke.run_grid(log=lambda m: log(f"[kernel-grid] {m}"))
    log(f"[kernel-grid] {len(rows) - len(failures)} combos passed, {len(failures)} failed")
    if failures:
        fail(f"[kernel-grid] {len(failures)} combinations failed: {failures[:20]}")
    return dict(combos=len(rows), failures=failures,
                worst=max(r["max_abs_err"] / r["tol"] for r in rows))


def _head_shape_params(tag):
    """[hd256]: Gemma-7B's attention geometry (16 query and 16 kv heads of
    head_dim 256, its published config.json) on Llama-2-7B's other widths,
    8 layers; [gqa8]: Llama-2-70B's widths (d_model 8192, 64 heads over 8
    kv heads, ffn 28672), 4 layers."""
    from tpuserve_torch.models.llama import LlamaParams

    base = LlamaParams.llama2_7b()
    if tag == "hd256":
        return dataclasses.replace(base, n_layers=8, n_heads=16, n_kv_heads=16, head_dim=256)
    return dataclasses.replace(base, dim=8192, n_layers=4, n_heads=64, n_kv_heads=8,
                               head_dim=128, ffn_dim=28672)


def phase_head_shape(torch, timer, reps, smi_line, tag, paged_kv):
    """A head shape the earlier phases do not serve, end to end on the
    card ([hd256], [gqa8]; `_head_shape_params`): int4 g128 weights drawn on
    the card from a seed, packed int4 KV, served through
    InferenceManager(device="cuda") with speculation_tokens 4 (the flat
    core in the decode steps, the multi core in the verifies: 8 concurrent
    greedy requests of the periodic prompt, launches exact, no plain call);
    a full-width decode_step (also under TPUSERVE_DECODE_ATTN=grouped: the
    grouped kernel) and verify_step against the plain versions (5% of the
    logit range, as [slice] and [spec]); the same model without speculation
    served under TPUSERVE_DECODE_ATTN=grouped (the grouped kernel's launches
    exact, no plain call); then the paged setting over a `paged_kv` pool: 8
    requests, the paged core's launches exact, no plain call, a full-width
    decode_step_paged against the plain versions. Then each kernel at this
    head shape through the [kernel] checks (packed int4 KV, a verify's C=5
    candidates, the `paged_kv` pool)."""
    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models import llama
    from tpuserve_torch.ops import decode_attention, quant_matmul

    p = _head_shape_params(tag)
    res = {"params": dataclasses.asdict(p)}
    cfg = _model_config(p)
    cfg["name"] = name = f"{tag}_spec"
    cfg["generation"] = {"max_seq_len": 512, "max_slots": 8, "eos_token_id": -1,
                         "max_new_tokens": 64, "decode_horizon": 4, "speculation_tokens": 4,
                         "speculation_rounds": 4, "speculation_min_gain": 0}
    mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
    t0 = time.monotonic()
    mgr.load_model(name)
    res["load_s"] = time.monotonic() - t0
    backend = mgr.get_model(name).backend
    engine = backend.engine
    n_slots, new = engine.n_slots, 32
    prompts = [_periodic_prompt(p.vocab_size)] * n_slots
    backend.generate(prompts[0], max_new_tokens=8)      # warm-up, outside the counted run
    for mod in (quant_matmul, decode_attention):
        mod.launches = 0
    decode_attention.multi_launches = decode_attention.paged_launches = 0
    base = (engine.steps, engine.prefill_calls, engine.verify_calls, engine.spec_drafted)
    with plain_calls() as plain:
        _, wall = _serve_wave(backend, prompts, new, tag)
    steps, prefills, verifies, drafted = (a - b for a, b in zip(
        (engine.steps, engine.prefill_calls, engine.verify_calls, engine.spec_drafted), base))
    launches = {"quant_matmul": quant_matmul.launches,
                "decode_attention": decode_attention.launches,
                "decode_attention_multi": decode_attention.multi_launches}
    want = {"quant_matmul": (4 * p.n_layers + 1) * (steps + prefills),
            "decode_attention": p.n_layers * (steps - verifies),
            "decode_attention_multi": p.n_layers * verifies}
    log(f"[{tag}] {n_slots} concurrent greedy requests, {new} tokens each, speculation 4: "
        f"{wall:.2f} s ({n_slots * new / wall:.1f} tok/s); decode steps {steps - verifies}, "
        f"verifies {verifies}, prefills {prefills}, drafted {drafted}; launches {launches} "
        f"(expected {want}); plain calls {plain or 'none'}; load {res['load_s']:.1f} s")
    if plain or launches != want or verifies < 1 or steps - verifies < 1:
        fail(f"[{tag}] the served run's launches or plain calls are off")
    res.update(contiguous_launches=launches, contiguous_want=want, wall_s=wall,
               decode_steps=steps - verifies, verifies=verifies, drafted=drafted)

    # full-width decode_step (pallas and grouped) and verify_step vs plain
    cache = engine.cache
    g = torch.Generator(device=DEVICE)
    g.manual_seed(6)
    c = 5
    toks = torch.randint(0, p.vocab_size, (n_slots, c), generator=g, device=DEVICE)
    pos = torch.randint(100, 401, (n_slots,), generator=g, device=DEVICE, dtype=torch.int32)
    lens = torch.full((n_slots,), c, dtype=torch.int32, device=DEVICE)
    lens[3] = 3
    pos[5], lens[5] = -1, 0
    tensors = cache_tensors(cache)
    snapshot = [t.clone() for t in tensors]

    def restore():
        for dst, src in zip(tensors, snapshot):
            dst.copy_(src)

    def against_plain(what, step, mask=None):
        logits_k = step().float()
        restore()
        with plain_kernels(llama):
            logits_p = step().float()
        restore()
        torch.cuda.synchronize()
        sel = (lambda t: t[mask]) if mask is not None else (lambda t: t)
        ref_max = sel(logits_p).abs().max().item()
        err = sel(logits_k - logits_p).abs().max().item()
        agree = sel((logits_k.argmax(-1) == logits_p.argmax(-1)).float()).mean().item()
        finite = bool(torch.isfinite(logits_k).all())
        tol = 0.05 * ref_max
        log(f"[{tag}] full-width {what}, kernels vs plain: max|err| {err:.4g} of {ref_max:.4g} "
            f"(tol {tol:.4g}); argmax agreement {agree:.4f}; finite {finite}")
        if not finite or not err <= tol:
            fail(f"[{tag}] full-width {what}: kernel path and plain path disagree")
        return dict(err=err, tol=tol, argmax_agreement=agree)

    before = (decode_attention.launches, decode_attention.grouped_launches)
    res["decode_step"] = against_plain("decode_step", lambda: llama.decode_step(
        engine.params, p, toks[:, 0], cache, pos)[0])
    with env_set("TPUSERVE_DECODE_ATTN", "grouped"):
        res["decode_step_grouped"] = against_plain(
            "decode_step under TPUSERVE_DECODE_ATTN=grouped",
            lambda: llama.decode_step(engine.params, p, toks[:, 0], cache, pos)[0])
    valid = torch.arange(c, device=DEVICE)[None, :] < lens[:, None]
    res["verify_step"] = against_plain("verify_step", lambda: llama.verify_step(
        engine.params, p, toks, cache, pos, lens)[0], valid)
    if (decode_attention.launches - before[0], decode_attention.grouped_launches - before[1]) \
            != (p.n_layers, p.n_layers):
        fail(f"[{tag}] the full-width steps' flat and grouped launches are off")
    del snapshot
    mgr.shutdown()

    # the grouped kernel served: the same model without speculation under
    # TPUSERVE_DECODE_ATTN=grouped, every decode step's attention on it
    cfg = _model_config(p)
    cfg["name"] = name = f"{tag}_grouped"
    cfg["generation"] = {"max_seq_len": 512, "max_slots": 8, "eos_token_id": -1,
                         "max_new_tokens": 64, "decode_horizon": 4}
    with attn_mode("grouped"):
        mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
        mgr.load_model(name)
        backend = mgr.get_model(name).backend
        engine = backend.engine
        backend.generate(prompts[0], max_new_tokens=4)   # warm-up, outside the counted run
        for mod in (quant_matmul, decode_attention):
            mod.launches = 0
        decode_attention.grouped_launches = 0
        base = (engine.steps, engine.prefill_calls)
        with plain_calls() as plain:
            _, gwall = _serve_wave(backend, prompts, new, f"{tag}-grouped")
        steps, prefills = engine.steps - base[0], engine.prefill_calls - base[1]
        glaunches = {"quant_matmul": quant_matmul.launches,
                     "decode_attention": decode_attention.launches,
                     "decode_attention_grouped": decode_attention.grouped_launches}
        gwant = {"quant_matmul": (4 * p.n_layers + 1) * (steps + prefills),
                 "decode_attention": 0, "decode_attention_grouped": p.n_layers * steps}
        log(f"[{tag}] TPUSERVE_DECODE_ATTN=grouped: {n_slots} concurrent greedy requests, {new} "
            f"tokens each: {gwall:.2f} s; decode steps {steps}, prefills {prefills}; launches "
            f"{glaunches} (expected {gwant}); plain calls {plain or 'none'}")
        if plain or glaunches != gwant or steps < 1:
            fail(f"[{tag}] the grouped run's launches or plain calls are off")
        mgr.shutdown()
    res.update(grouped_launches=glaunches, grouped_want=gwant, grouped_wall_s=gwall)

    # the paged setting over a `paged_kv` pool
    cfg = _model_config(p)
    cfg["name"] = name = f"{tag}_paged"
    cfg["quantization"]["kv_cache"] = paged_kv
    cfg["generation"] = {"max_seq_len": 256, "max_slots": 8, "eos_token_id": -1,
                         "max_new_tokens": 32, "decode_horizon": 8, "paged": True,
                         "page_size": 128, "num_pages": 0, "prefill_chunk": 128}
    mgr = InferenceManager(_write_repo(cfg), num_workers=1, device=DEVICE)
    mgr.load_model(name)
    backend = mgr.get_model(name).backend
    engine = backend.engine
    rng = torch.Generator().manual_seed(14)
    prompts = [torch.randint(0, p.vocab_size, (n,), generator=rng).tolist()
               for n in (6, 40, 100, 150, 9, 77, 130, 20)]
    backend.generate(prompts[0], max_new_tokens=4)
    for mod in (quant_matmul, decode_attention):
        mod.launches = 0
    decode_attention.paged_launches = 0
    base = (engine.steps, engine.prefill_calls)
    with plain_calls() as plain:
        _, pwall = _serve_wave(backend, prompts, new, f"{tag}-paged")
    steps, prefills = engine.steps - base[0], engine.prefill_calls - base[1]
    plaunches = {"quant_matmul": quant_matmul.launches,
                 "decode_attention_paged": decode_attention.paged_launches}
    pwant = {"quant_matmul": (4 * p.n_layers + 1) * (steps + prefills),
             "decode_attention_paged": p.n_layers * steps}
    log(f"[{tag}] paged ({paged_kv} pool, pages of 128): {len(prompts)} requests of {new} tokens "
        f"in {pwall:.2f} s; decode steps {steps}, prefills {prefills}; launches {plaunches} "
        f"(expected {pwant}); plain calls {plain or 'none'}")
    if plain or plaunches != pwant or steps < 1:
        fail(f"[{tag}] the paged run's launches or plain calls are off")
    res.update(paged_launches=plaunches, paged_want=pwant, paged_wall_s=pwall)
    cache, ptm = engine.cache, engine.ptm
    g.manual_seed(7)
    for t in (cache.k, cache.v):
        if t.dtype == torch.uint8:
            t.random_(0, 256, generator=g)
        else:
            t.random_(-127, 128, generator=g)
    for t in (cache.k_scale, cache.v_scale):
        t.uniform_(0.005, 0.015, generator=g)
    n_cols = -(-engine.max_seq_len // ptm.page_size)
    table = (1 + torch.randperm(cache.n_pages - 1, generator=g, device=DEVICE))
    table = table[:n_slots * n_cols].view(n_slots, n_cols).to(torch.int32)
    ptoks = torch.randint(0, p.vocab_size, (n_slots,), generator=g, device=DEVICE)
    ppos = torch.randint(100, 250, (n_slots,), generator=g, device=DEVICE, dtype=torch.int32)
    ppos[2] = -1
    tensors = [cache.k, cache.v, cache.k_scale, cache.v_scale]
    snapshot = [t.clone() for t in tensors]
    res["decode_step_paged"] = against_plain("decode_step_paged", lambda: llama.decode_step_paged(
        engine.params, p, ptoks, cache, table, ppos)[0])
    del snapshot
    mgr.shutdown()
    torch.cuda.empty_cache()
    suffix = {"hd256": "_hd256", "gqa8": "_rep8"}[tag]
    res["kernels"] = {
        "flat": check_decode_attention(torch, timer, reps, p, tag=suffix, full_step=True),
        "multi": check_decode_attention_multi(torch, timer, reps, p, tag=suffix, c=5,
                                              main_kind="int4"),
        "paged": check_decode_attention_paged(torch, timer, reps, p, tag=suffix,
                                              main_kind=paged_kv),
        "grouped": check_decode_attention_grouped(torch, timer, reps, p, tag=suffix)}
    log(f"[{tag}] card {smi_line}")
    return res


# ------------------------------------------------ the scripts of the slice
def _hf_checkpoint(torch, root, p, n_layers):
    """An HF-named Llama checkpoint at p's widths cut to `n_layers` (bf16
    weights drawn on the card from a seed, std 0.02), with config.json."""
    from tpuserve_torch.utils.checkpoint import write_safetensors

    g = torch.Generator(device=DEVICE)
    g.manual_seed(31)
    qd, kvd = p.n_heads * p.head_dim, p.n_kv_heads * p.head_dim

    def rnd(*shape):
        return (torch.randn(shape, generator=g, device=DEVICE) * 0.02).to(torch.bfloat16).cpu()

    w = {"model.embed_tokens.weight": rnd(p.vocab_size, p.dim),
         "model.norm.weight": torch.ones(p.dim, dtype=torch.bfloat16),
         "lm_head.weight": rnd(p.vocab_size, p.dim)}
    for i in range(n_layers):
        pre = f"model.layers.{i}"
        w[f"{pre}.input_layernorm.weight"] = torch.ones(p.dim, dtype=torch.bfloat16)
        w[f"{pre}.post_attention_layernorm.weight"] = torch.ones(p.dim, dtype=torch.bfloat16)
        for nm, shape in (("self_attn.q_proj", (qd, p.dim)), ("self_attn.k_proj", (kvd, p.dim)),
                          ("self_attn.v_proj", (kvd, p.dim)), ("self_attn.o_proj", (p.dim, qd)),
                          ("mlp.gate_proj", (p.ffn_dim, p.dim)),
                          ("mlp.up_proj", (p.ffn_dim, p.dim)),
                          ("mlp.down_proj", (p.dim, p.ffn_dim))):
            w[f"{pre}.{nm}.weight"] = rnd(*shape)
    os.makedirs(root, exist_ok=True)
    write_safetensors(os.path.join(root, "model.safetensors"), w)
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump({"num_hidden_layers": n_layers, "num_attention_heads": p.n_heads,
                   "num_key_value_heads": p.n_kv_heads, "hidden_size": p.dim,
                   "intermediate_size": p.ffn_dim, "vocab_size": p.vocab_size,
                   "rope_theta": p.rope_theta, "rms_norm_eps": p.rms_eps,
                   "eos_token_id": [2]}, fh)


def phase_scripts(torch, smi_line):
    """[scripts]: the slice's five scripts on the card at short settings:
    spec_bench (7B int4 + int8 KV, the three workloads on and off, one wave
    each of TPUSERVE_SPEC_BENCH_NEW=32 tokens), spec_trace (one wave),
    verify_profile (2 rounds); then a 2-layer Llama-2-7B-width
    checkpoint written in HF naming, converted by convert_hf_llama, served
    through InferenceManager(device="cuda") (greedy tokens, no plain call)
    and scored by eval_real_ppl --token-ids with int4 RTN."""
    import numpy as np

    from tpuserve_torch.engine.manager import InferenceManager
    from tpuserve_torch.models.llama import LlamaParams
    from tpuserve_torch.scripts import (convert_hf_llama, eval_real_ppl, spec_bench, spec_trace,
                                        verify_profile)

    res, seconds = {}, {}
    with env_set("TPUSERVE_SPEC_BENCH_NEW", "32"):   # one wave a workload and side, no warm-up
        t0 = time.monotonic()
        res["spec_bench"] = spec_bench.report(spec_bench.run(DEVICE, warm=False))
        seconds["spec_bench"] = time.monotonic() - t0
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        res["spec_trace"] = spec_trace.run(DEVICE, warm=False)
        seconds["spec_trace"] = time.monotonic() - t0
        torch.cuda.empty_cache()
    if res["spec_bench"]["repetitive"]["spec_on"]["spec_drafted"] <= 0:
        fail("[scripts] spec_bench: no draft fired on the repetitive workload")
    if not any(k.startswith("_dev_spec_rounds(") or k.startswith("_dev_verify(")
               for k in res["spec_trace"]["dispatches"]):
        fail("[scripts] spec_trace: no verify dispatch traced")
    t0 = time.monotonic()
    res["verify_profile"] = verify_profile.run(DEVICE, rounds=2)
    seconds["verify_profile"] = time.monotonic() - t0
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="tpuserve_torch_ckpt_")
    try:
        t0 = time.monotonic()
        p = LlamaParams.llama2_7b()
        _hf_checkpoint(torch, os.path.join(tmp, "hf"), p, n_layers=2)
        seconds["hf_checkpoint"] = time.monotonic() - t0
        t0 = time.monotonic()
        vdir = convert_hf_llama.convert(os.path.join(tmp, "hf"), os.path.join(tmp, "repo"),
                                        "hf_llama", "1", "int4", "int8", 4, 512, device=DEVICE)
        seconds["convert"] = time.monotonic() - t0
        with open(os.path.join(vdir, "config.json")) as fh:
            cfg = json.load(fh)
        if cfg["model_params"]["n_layers"] != 2 or cfg["generation"]["eos_token_id"] != 2:
            fail(f"[scripts] convert_hf_llama wrote {cfg['model_params']}")
        t0 = time.monotonic()
        mgr = InferenceManager(os.path.join(tmp, "repo"), num_workers=1, device=DEVICE)
        mgr.load_model("hf_llama")
        backend = mgr.get_model("hf_llama").backend
        with plain_calls() as plain:
            served = backend.generate([5, 17, 100, 42, 7], max_new_tokens=16)
        mgr.shutdown()
        seconds["serve"] = time.monotonic() - t0
        log(f"[scripts] converted HF checkpoint served on the card: {served['num_generated']} "
            f"tokens {served['generated_ids']}; plain calls {plain or 'none'}")
        if plain or served["num_generated"] < 1:
            fail("[scripts] the converted checkpoint did not serve through the kernels")
        ids = np.random.default_rng(5).integers(0, p.vocab_size, 4 * 256)
        ids_path = os.path.join(tmp, "ids.json")
        with open(ids_path, "w") as fh:
            json.dump([int(t) for t in ids], fh)
        t0 = time.monotonic()
        res["eval_real_ppl"] = eval_real_ppl.main(
            ["--repository", os.path.join(tmp, "repo"), "--model", "hf_llama", "--token-ids",
             ids_path, "--ctx", "256", "--max-windows", "4", "--bits", "4", "--quantizer", "rtn",
             "--json", "--device", DEVICE])
        seconds["eval_real_ppl"] = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row = res["eval_real_ppl"]
    if not (np.isfinite(row["ppl_fp"]) and np.isfinite(row["ppl_quant"])) \
            or row["eval_windows"] != 4:
        fail(f"[scripts] eval_real_ppl: {row}")
    res["seconds"] = seconds
    log(f"[scripts] seconds {seconds}; card {smi_line}")
    return res


def _timed(seconds, what, fn, /, *args, **kw):
    """fn(*args, **kw), its wall seconds kept in `seconds` under `what` and
    logged (the script's time limit is shared by every phase)."""
    t0 = time.monotonic()
    out = fn(*args, **kw)
    seconds[what] = round(time.monotonic() - t0, 1)
    log(f"[{what}] phase {seconds[what]} s")
    return out


# every phase after device and build, by the name --phases takes, in the
# order main runs them
PHASES = ("kernel", "kernel_grid", "slice", "rest", "mixtral", "tp", "dp_sp", "mixtral_tp",
          "pp", "pp_tp", "pp_paged", "paged_tp", "spec_tp", "spec_dp_sp", "spec_paged_tp",
          "pp_mixtral", "mqa_tp", "w4a8", "odd", "g344", "w4a8_g344", "gptq", "llm_demo",
          "zoo", "paged", "spec", "spec_bf16", "spec_paged", "grouped", "grouped_bf16",
          "hd256", "gqa8", "scripts", "native", "sweep", "unpack", "diag", "qmm_sweep",
          "moe_ab")


def _parse_phases(argv):
    import argparse

    ap = argparse.ArgumentParser(description="The port's chip smoke run on one card.")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run (default: every phase); device and "
                         f"build always run. Phases: {', '.join(PHASES)}")
    names = [n for n in ap.parse_args(argv).phases.split(",") if n]
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    return set(names) or set(PHASES)


def _add_path(results, kname, tag, launched, first=None):
    """Add a path's launches to a kernel's entry of the kernels line, by
    path (`first` names the entry's own count where the path table starts
    with it); a no-op when the kernel phase did not run."""
    entry = results.get(kname)
    if entry is None:
        return
    by = entry.setdefault("launches_by_path", {} if first is None else {first: entry["launches"]})
    by[tag] = launched
    entry["launches"] += launched


def main(argv=None) -> None:
    import torch

    want = _parse_phases(argv)
    name, count, smi_line = phase_device(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpuserve_torch.models.llama import LlamaParams

    p = LlamaParams.llama2_7b()
    p_moe = LlamaParams.mixtral_8x7b()
    t0 = time.monotonic()
    seconds = {}

    def run(what, fn, *args, **kw):
        """A selected phase's result (timed), else None."""
        return _timed(seconds, what, fn, *args, **kw) if what in want else None

    build = _timed(seconds, "build", phase_build)
    timer = Timer(torch)
    results = run("kernel", phase_kernels, torch, timer, 20, p, p_moe) or {}
    # every head shape the Pallas kernels serve, each entry against its plain version
    grid_res = run("kernel_grid", phase_kernel_grid, torch)
    slice_res = run("slice", phase_slice, torch, p, smi_line)
    if slice_res and results:
        for name_, launched in slice_res["launches"].items():
            results[{"smoke": "vector_add"}.get(name_, name_)]["launches"] = launched
    # the slice through its front: the served wave's launches add to the
    # main path's
    rest_res = run("rest", phase_rest, torch, p, smi_line)
    if rest_res:
        for name_, launched in rest_res["launches"].items():
            _add_path(results, name_, "rest", launched, first="slice")
    # the MoE path: the quant-matmul on expert views and the flat core at
    # GQA rep 4, each counted over the [mixtral] run
    mixtral_res = run("mixtral", phase_mixtral, torch, p_moe, smi_line)
    if mixtral_res and results:
        results["quant_matmul_experts"]["launches"] = mixtral_res["launches"]["quant_matmul"]
        results["decode_attention_gqa"]["launches"] = \
            mixtral_res["launches"]["decode_attention"]
    # sharded serving: ranks that share the card over gloo, each counting
    # its own launches at the shard shapes (the controller gathers them)
    tp_res = run("tp", phase_tp, torch, p, smi_line)
    dp_sp_res = run("dp_sp", phase_dp_sp, torch, p, smi_line)
    mixtral_tp_res = run("mixtral_tp", phase_mixtral_tp, torch, p_moe, smi_line)
    for tag, res_ in (("tp", tp_res), ("dp-sp", dp_sp_res), ("mixtral-tp", mixtral_tp_res)):
        for name_, launched in (res_ or {}).get("launches", {}).items():
            _add_path(results, name_, tag, launched, first="mixtral")
    # the layer pipeline (stage blocks, 5D stage caches and the 5D paged
    # pool) and paged KV under tensor_parallel: row 1 on every stage's
    # shapes, row 5 on each rank's kv heads of the pool (added to the paged
    # path's count below)
    pp_res = run("pp", phase_pp, torch, p, smi_line)
    pp_tp_res = run("pp_tp", phase_pp_tp, torch, p, smi_line)
    pp_paged_res = run("pp_paged", phase_pp_paged, torch, p, smi_line)
    paged_tp_res = run("paged_tp", phase_paged_tp, torch, p, smi_line)
    # speculation across ranks (row 1 at a verify's S/dp * C rows, row 2 on
    # the rank's heads in the decode steps between verifies, row 5 per
    # shard) and pp x MoE (row 1i on each stage's own experts)
    spec_tp_res = run("spec_tp", phase_spec_tp, torch, p, smi_line)
    spec_dp_sp_res = run("spec_dp_sp", phase_spec_dp_sp, torch, p, smi_line)
    spec_paged_tp_res = run("spec_paged_tp", phase_spec_paged_tp, torch, p, smi_line)
    pp_mixtral_res = run("pp_mixtral", phase_pp_mixtral, torch, p_moe, smi_line)
    # a tp that does not divide the kv heads (Gemma-2B's one kv head at tp
    # 2): row 1 at the shard shapes, no attention kernel (einsums)
    mqa_tp_res = run("mqa_tp", phase_mqa_tp, torch, smi_line)
    for tag, res_ in (("pp", pp_res), ("pp-tp", pp_tp_res), ("pp-paged", pp_paged_res),
                      ("paged-tp", paged_tp_res), ("spec-tp", spec_tp_res),
                      ("spec-dp-sp", spec_dp_sp_res), ("spec-paged-tp", spec_paged_tp_res),
                      ("pp-mixtral", pp_mixtral_res), ("mqa-tp", mqa_tp_res)):
        if res_:
            _add_path(results, "quant_matmul", tag, res_["launches"]["quant_matmul"])
    for tag, res_ in (("spec-tp", spec_tp_res), ("spec-dp-sp", spec_dp_sp_res)):
        if res_:
            _add_path(results, "decode_attention", tag, res_["launches"]["decode_attention"],
                      first="slice")
    if pp_mixtral_res:
        _add_path(results, "quant_matmul_experts", "pp-mixtral",
                  pp_mixtral_res["launches"]["quant_matmul_experts"])
    # the slice's path with int8 activations, then with groups a 64-row
    # stage cannot tile: each route's launches are that run's
    w4a8_res = run("w4a8", phase_quant_route, torch, p, smi_line, "w4a8",
                   {"activations": "int8"}, {"w4a8_launches": 4 * p.n_layers + 1})
    if w4a8_res and results:
        results["quant_matmul_w4a8"] = dict(results["quant_matmul"]["w4a8"],
                                            launches=w4a8_res["launches"]["w4a8_launches"])
        results["quantize_rows"]["launches"] = w4a8_res["launches"]["quantize_launches"]
    odd_res = run("odd", phase_quant_route, torch, p, smi_line, "odd",
                  {"group_size": 688}, {"odd_group_launches": p.n_layers})
    if odd_res and results:
        results["quant_matmul_odd_groups"] = dict(
            results["quant_matmul"]["odd"], launches=odd_res["launches"]["odd_group_launches"])
    # w_down in groups of 344 (11008 / 32), the rest per channel: masked
    # k16 steps with bf16 x, masked k32 steps with int8 x
    g344_res = run("g344", phase_quant_route, torch, p, smi_line, "g344",
                   {"group_size": 344}, {"group_route_launches": p.n_layers})
    if g344_res and results:
        results["quant_matmul_group_route"] = dict(
            results["quant_matmul"]["group_route"],
            launches=g344_res["launches"]["group_route_launches"])
        results["stage_x"]["launches"] = g344_res["launches"]["stage_launches"]
    w4a8_g344_res = run(
        "w4a8_g344", phase_quant_route,
        torch, p, smi_line, "w4a8-g344", {"group_size": 344, "activations": "int8"},
        {"w4a8_launches": 3 * p.n_layers + 1, "w4a8_route_launches": p.n_layers})
    if w4a8_g344_res and results:
        results["quant_matmul_w4a8_route"] = dict(
            results["quant_matmul"]["w4a8_route"],
            launches=w4a8_g344_res["launches"]["w4a8_route_launches"])
    # calibrated quantization: the load's calibration pass runs the f32-x
    # route (its launches are that load's), the served run the bf16 route
    # and the flat core with LoRC on top
    gptq_res = run("gptq", phase_gptq, torch, timer, 20, p, smi_line)
    if gptq_res and results:
        results["quant_matmul_f32"] = dict(
            results["quant_records"]["f32"],
            launches=gptq_res["load_launches"]["f32_launches"],
            per="one call: wo (K 4096, N 4096), B=64, int4 g128, f32 x as three bf16 pieces",
            calibration=gptq_res["f32_calibration"])
        for name_, launched in (("quant_matmul", gptq_res["launches"]["launches"]),
                                ("decode_attention", gptq_res["attention_launches"])):
            _add_path(results, name_, "gptq", launched)
    llm_demo_res = run("llm_demo", phase_llm_demo, torch, smi_line)
    # the model zoo through the port's front: its served int8 quant-matmuls
    # (row 1b) add to the main path's, and eval_accuracy's f32-x calls to
    # the f32 route's
    zoo_res = run("zoo", phase_zoo, torch, timer, smi_line)
    if zoo_res and results:
        results["quant_matmul_int8"] = dict(zoo_res["entry"], launches=zoo_res["launches"])
        if "quant_matmul_f32" in results:
            _add_path(results, "quant_matmul_f32", "zoo", zoo_res["f32_launches"],
                      first="gptq")
    paged_res = run("paged", phase_paged_slice, torch, p, smi_line)
    # the paged kernel runs on the paged path only: its count is that run's
    if results:
        entry = results["decode_attention_paged"]
        for tag, res_ in (("paged", paged_res), ("paged-tp", paged_tp_res),
                          ("spec-paged-tp", spec_paged_tp_res)):
            if res_:
                if tag == "paged":
                    entry["launches"] = 0
                _add_path(results, "decode_attention_paged", tag,
                          res_["launches"]["decode_attention_paged"])
    spec_res = run("spec", phase_spec, torch, p, smi_line)
    # the multi kernel runs on the speculative path only: its count is that run's
    if spec_res and results:
        results["decode_attention_multi"]["launches"] = \
            spec_res["launches"]["decode_attention_multi"]
    # the JAX package's default cache (kv_cache none, bf16): the multi
    # kernel's float route, counted over that run
    spec_bf16_res = run("spec_bf16", phase_spec, torch, p, smi_line, tag="spec-bf16",
                        kv_cache="none")
    if spec_bf16_res and results:
        results["decode_attention_multi_float"] = dict(
            results["decode_attention_multi"]["float"],
            launches=spec_bf16_res["launches"]["decode_attention_multi"])
    spec_paged_res = run("spec_paged", phase_spec_paged, torch, p, smi_line)
    grouped_res = run("grouped", phase_grouped, torch, timer, p, smi_line)
    # the grouped kernel runs on the grouped path only: its count is that run's
    if grouped_res and results:
        results["decode_attention_grouped"]["launches"] = \
            grouped_res["launches"]["decode_attention_grouped"]
    grouped_bf16_res = run("grouped_bf16", phase_grouped, torch, timer, p, smi_line,
                           tag="grouped-bf16", kv_cache="none")
    if grouped_bf16_res and results:
        results["decode_attention_grouped_float"] = dict(
            results["decode_attention_grouped"]["float"],
            launches=grouped_bf16_res["launches"]["decode_attention_grouped"])
    # head_dim 256 and GQA rep 8 served end to end (the core at NT 2 paged,
    # three row groups a verify), each kernel timed at those shapes; then
    # the slice's five scripts
    shape_res = {tag: run(tag, phase_head_shape, torch, timer, 20, smi_line, tag, paged_kv)
                 for tag, paged_kv in (("hd256", "int8"), ("gqa8", "int4"))}
    for tag, suffix in (("hd256", "hd256"), ("gqa8", "rep8")):
        res_ = shape_res[tag]
        if not res_:
            continue
        for part, kname, launched in (
                ("flat", "decode_attention", res_["contiguous_launches"]["decode_attention"]),
                ("multi", "decode_attention_multi",
                 res_["contiguous_launches"]["decode_attention_multi"]),
                ("paged", "decode_attention_paged",
                 res_["paged_launches"]["decode_attention_paged"]),
                ("grouped", "decode_attention_grouped",
                 res_["grouped_launches"]["decode_attention_grouped"])):
            results[f"{kname}_{suffix}"] = dict(res_["kernels"][part], launches=launched)
    scripts_res = run("scripts", phase_scripts, torch, smi_line)
    # the native runtime last of the served phases: once built, the
    # binding finds native/build/libtpuserve.so in every later load
    native_res = run("native", phase_native, torch, p, smi_line)
    sweep_res = run("sweep", phase_sweep, torch)
    # the probes and the prebuilt-Q_wide entry run in the sweep only
    for kname, launched in (sweep_res or {}).get("launches", {}).items():
        if kname in results:
            results[kname]["launches"] = launched
    unpack_res = run("unpack", phase_unpack, torch, timer, 20, p, smi_line)
    # the unpack probes run in the microbenchmark only, the copy kernel in diag_bw
    for kname, launched in (unpack_res or {}).get("launches", {}).items():
        if kname in results:
            results[kname]["launches"] = launched
    diag_res = run("diag", phase_diag_bw, torch)
    if diag_res and results:
        results["diag_copy"]["launches"] = diag_res["launches"]
    qmm_sweep_res = run("qmm_sweep", phase_qmm_sweep, torch)
    moe_ab_res = run("moe_ab", phase_moe_ab, torch)
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
               "quant_matmul_f32": ("tpuserve_torch/csrc/quant_matmul.cu",
                                    "tpuserve/ops/quant_matmul.py:40 (_kernel, f32 x)"),
               "quant_matmul_int8": ("tpuserve_torch/csrc/quant_matmul.cu",
                                     "tpuserve/ops/quant_matmul.py:40 (_kernel, int8 weights, "
                                     "bf16 x; reached by tpuserve/models/layers.py:18 linear)"),
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
                   "tpuserve_torch/csrc/decode_attention_hopper_paged.cu",
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
               "decode_attention_hd256": (
                   "tpuserve_torch/csrc/decode_attention_hopper_hd256.cu",
                   "tpuserve/ops/decode_attention.py:160 (_wide_kernel, head_dim 256)"),
               "decode_attention_multi_hd256": (
                   "tpuserve_torch/csrc/decode_attention_hopper_hd256.cu",
                   "tpuserve/ops/decode_attention.py:804 (_wide_multi_kernel, head_dim 256)"),
               "decode_attention_paged_hd256": (
                   "tpuserve_torch/csrc/decode_attention_hopper_paged_hd256.cu",
                   "tpuserve/ops/decode_attention.py:160 (_wide_kernel, paged_sc, head_dim 256)"),
               "decode_attention_grouped_hd256": (
                   "tpuserve_torch/csrc/decode_attention_grouped_hopper_hd256.cu",
                   "tpuserve/ops/decode_attention.py:1237 (_kernel, head_dim 256)"),
               "decode_attention_rep8": (
                   "tpuserve_torch/csrc/decode_attention_hopper.cu",
                   "tpuserve/ops/decode_attention.py:160 (_wide_kernel, GQA rep 8: packed int4, "
                   "16 query rows a block)"),
               "decode_attention_multi_rep8": (
                   "tpuserve_torch/csrc/decode_attention_hopper.cu",
                   "tpuserve/ops/decode_attention.py:804 (_wide_multi_kernel, GQA rep 8: 5 x 16 "
                   "rows in 3 row groups)"),
               "decode_attention_paged_rep8": (
                   "tpuserve_torch/csrc/decode_attention_hopper_paged.cu",
                   "tpuserve/ops/decode_attention.py:160 (_wide_kernel, paged_sc, GQA rep 8: "
                   "packed int4 pages, 16 rows a block)"),
               "decode_attention_grouped_rep8": (
                   "tpuserve_torch/csrc/decode_attention_grouped_hopper.cu",
                   "tpuserve/ops/decode_attention.py:1237 (_kernel, GQA rep 8: 16 rows a "
                   "packed int4 pair)"),
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
        if kname not in results:   # its phases were not selected
            continue
        r = results[kname]
        line.append({"name": kname, "route": "cuda", "source": sources[kname][0],
                     "replaces": sources[kname][1], "launches": r["launches"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "per": r["per"]})
        if kname == "quant_matmul":   # route launches of the kernel check
            line[-1]["route_launches"] = r["route_launches"]
        if "launches_by_path" in r:
            line[-1]["launches_by_path"] = r["launches_by_path"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump({"device": name, "nvidia_smi": smi_line, "build_s": build.seconds,
                   "build_log": build.log, "kernels": results, "slice": slice_res,
                   "rest": rest_res, "paged_slice": paged_res, "spec": spec_res,
                   "spec_bf16": spec_bf16_res,
                   "spec_paged": spec_paged_res, "grouped": grouped_res,
                   "grouped_bf16": grouped_bf16_res, "w4a8": w4a8_res, "odd": odd_res,
                   "g344": g344_res, "w4a8_g344": w4a8_g344_res, "mixtral": mixtral_res,
                   "tp": tp_res, "dp_sp": dp_sp_res, "mixtral_tp": mixtral_tp_res,
                   "pp": pp_res, "pp_tp": pp_tp_res, "pp_paged": pp_paged_res,
                   "paged_tp": paged_tp_res, "spec_tp": spec_tp_res,
                   "spec_dp_sp": spec_dp_sp_res, "spec_paged_tp": spec_paged_tp_res,
                   "pp_mixtral": pp_mixtral_res, "mqa_tp": mqa_tp_res, "native": native_res,
                   "kernel_grid": grid_res, "hd256": shape_res["hd256"],
                   "gqa8": shape_res["gqa8"], "scripts": scripts_res,
                   "gptq": gptq_res, "llm_demo": llm_demo_res, "zoo": zoo_res,
                   "moe_ab": moe_ab_res,
                   "sweep": sweep_res, "unpack": unpack_res,
                   "diag_bw": diag_res, "qmm_sweep": qmm_sweep_res,
                   "phases": sorted(want, key=PHASES.index), "phase_seconds": seconds,
                   "seconds": time.monotonic() - t0}, fh, indent=1,
                  default=str)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
