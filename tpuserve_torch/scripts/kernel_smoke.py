"""The decode-attention kernel grid on the card: every entry of the Hopper
core and the grouped kernel at every head shape the TPU kernels serve, each
held to its plain PyTorch version (the port of scripts/kernel_smoke_tpu.py,
which compiles the Pallas kernels over the same grid; here the kernels are
built once and each combination is run and checked).

  kernels : wide_cache (flat), wide_cache_multi (C = 4), wide_paged (scale
            pools), wide (prebuilt Q_wide, every block read), grouped
            (TPUSERVE_DECODE_ATTN=grouped; packed int4 in place)
  Hkv     : {1, 2, 4, 8, 32}
  rep     : {1, 4}, and {3, 7, 8} at Hkv 8
  hd      : {128, 256}
  KV      : int8 with f32 and with bf16 scales, bf16, packed int4 (bf16 and
            f32 scales) where (Hkv*hd/2) % 128 == 0 and Hkv is even (never
            the wide entry); the extra ratios also an f32 cache. A paged
            pool's scales are f32 pools, so its bf16-scale cases are left out.

The TPU script's size cap (n_heads * Hkv * hd^2 <= 64 * 4096 * 128) holds;
S = 4, L = 256, pages of 64 rows. Tolerances: the core's entries 2e-3 of
the output range (+1e-6), the grouped kernel 1e-3 (+1e-7), as chip_smoke's
[kernel] checks; inactive slots must be zero and each call must launch its
kernel once. One PASS/FAIL line a combination; exits 1 on any failure.

    python -m tpuserve_torch.scripts.kernel_smoke [--quick] [--device cpu]

On the CPU the wrappers take the plain versions themselves, so every case
passes: the run checks only that the grid's inputs are well formed.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time

import torch

from tpuserve_torch.ops import decode_attention as da

KERNELS = ("wide_cache", "wide_cache_multi", "wide_paged", "wide", "grouped")
# (cache, scale dtype)
CACHES = (("int8", "f32"), ("int8", "bf16"), ("bf16", None), ("int4", "bf16"), ("int4", "f32"))
EXTRA_CACHES = CACHES + (("f32", None),)
S_DIM, L_MAX, CANDS, PAGE = 4, 256, 4, 64
_COUNTERS = {"wide_cache": "launches", "wide_cache_multi": "multi_launches",
             "wide_paged": "paged_launches", "wide": "wide_launches",
             "grouped": "grouped_launches"}


def _keep(kernel, n_kv, rep, hd, cache, sdt) -> bool:
    if n_kv * rep * n_kv * hd * hd > 64 * 4096 * 128:   # the TPU script's cap
        return False
    if cache == "int4" and (kernel == "wide" or (n_kv * hd // 2) % 128 or n_kv % 2):
        return False
    return not (kernel == "wide_paged" and sdt == "bf16")


def combos(quick: bool = False):
    """(kernel, Hkv, rep, hd, cache, scale dtype) of the grid, then the
    extra ratios at Hkv 8. `quick`: Hkv {2, 4}, rep 1, hd 128 and 256."""
    hkvs, reps = ((2, 4), (1,)) if quick else ((1, 2, 4, 8, 32), (1, 4))
    out = [c for c in itertools.product(KERNELS, hkvs, reps, (128, 256), CACHES)
           if _keep(c[0], c[1], c[2], c[3], *c[4])]
    if not quick:
        out += [(kn, 8, rep, hd, cs) for kn, rep, hd, cs in
                itertools.product(KERNELS, (3, 7, 8), (128, 256), EXTRA_CACHES)
                if _keep(kn, 8, rep, hd, *cs)]
    return [(kn, hkv, rep, hd, cs[0], cs[1]) for kn, hkv, rep, hd, cs in out]


def tag_of(kernel, n_kv, rep, hd, cache, sdt) -> str:
    kv = f"{cache}-{sdt}" if sdt else f"{cache}kv"
    return f"{kernel}/Hkv{n_kv}/rep{rep}/hd{hd}/{kv}"


def _codes(shape, cache, g, dev):
    """Random codes or values drawn on `dev` (the inputs of a combination
    are made where it runs)."""
    if cache == "int4":
        return torch.randint(0, 256, shape, generator=g, dtype=torch.int32,
                             device=dev).to(torch.uint8)
    if cache == "int8":
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int32,
                             device=dev).to(torch.int8)
    t = torch.randn(shape, generator=g, device=dev)
    return t.to(torch.bfloat16) if cache == "bf16" else t


def combo_call(kernel, n_kv, rep, hd, cache, sdt, device="cuda", seed=0):
    """(kernel call, plain call) of one combination on fresh inputs."""
    g = torch.Generator(device=device).manual_seed(seed)
    s, l, h = S_DIM, L_MAX, n_kv * rep
    w = n_kv * hd
    wst = w // 2 if cache == "int4" else w
    quant = cache in ("int8", "int4")
    sdtype = torch.bfloat16 if sdt == "bf16" else torch.float32

    def scales(shape):
        return ((torch.rand(shape, generator=g, device=device) + 0.5) * 0.01).to(sdtype)

    pos = torch.tensor([l - 2, 5, 0, -1], dtype=torch.int32, device=device)
    q = torch.randn((s, h, hd), generator=g, device=device) / hd ** 0.5
    if kernel in ("wide_cache", "wide_cache_multi"):
        k, v = (_codes((2, s, l, wst), cache, g, device) for _ in range(2))
        ks, vs = (scales((s, n_kv, l)) for _ in range(2)) if quant else (None, None)
        if kernel == "wide_cache_multi":
            q = torch.randn((s, CANDS, h, hd), generator=g, device=device) / hd ** 0.5
            pos = torch.tensor([l - CANDS - 1, 5, 0, -1], dtype=torch.int32, device=device)
            fn, plain = da.decode_attention_wide_cache_multi, \
                da.decode_attention_wide_cache_multi_plain
        else:
            fn, plain = da.decode_attention_wide_cache, da.decode_attention_wide_cache_plain
        return ((lambda f: lambda: f(q, k, v, ks, vs, pos, 1, window=l))(fn),
                (lambda f: lambda: f(q, k, v, ks, vs, pos, 1, window=l))(plain), pos)
    if kernel == "wide_paged":
        pages = l // PAGE
        n_pages = s * pages + 1
        k, v = (_codes((2, n_pages, PAGE, wst), cache, g, device) for _ in range(2))
        hp = -(-n_kv // 8) * 8
        ks, vs = ((scales((2, n_pages, hp, PAGE)) for _ in range(2)) if quant
                  else (None, None))
        perm = torch.randperm(s * pages, generator=g, device=device).to(torch.int32) + 1
        table = perm.view(s, pages).contiguous()
        return ((lambda f: lambda: f(q, k, v, ks, vs, table, pos, 1, window=l))(
                    da.decode_attention_wide_paged),
                (lambda f: lambda: f(q, k, v, ks, vs, table, pos, 1, window=l))(
                    da.decode_attention_wide_paged_plain), pos)
    if kernel == "wide":
        k, v = (_codes((s, l, n_kv, hd), cache, g, device) for _ in range(2))
        ks, vs = (scales((s, n_kv, l)) for _ in range(2)) if quant else (None, None)
        return ((lambda f: lambda: f(q, k, v, ks, vs, pos))(da.decode_attention_wide),
                (lambda f: lambda: f(q, k, v, ks, vs, pos))(da.decode_attention_wide_plain), pos)
    # grouped: an int8/float window [S, L, Hkv, hd] with [S, L, Hkv] scale
    # views of the head-major cache; packed int4 [S, L, W/2] with [S, Hkv, L]
    ks, vs = (scales((s, n_kv, l)) for _ in range(2)) if quant else (None, None)
    if cache == "int4":
        k, v = (_codes((s, l, wst), cache, g, device) for _ in range(2))
        return ((lambda f: lambda: f(q, k, v, ks, vs, pos))(da.decode_attention_packed),
                (lambda f: lambda: f(q, k, v, ks, vs, pos))(da.decode_attention_packed_plain),
                pos)
    k, v = (_codes((s, l, n_kv, hd), cache, g, device) for _ in range(2))
    kt, vt = (None, None) if ks is None else (ks.transpose(1, 2), vs.transpose(1, 2))
    return ((lambda f: lambda: f(q, k, v, kt, vt, pos))(da.decode_attention),
            (lambda f: lambda: f(q, k, v, kt, vt, pos))(da.decode_attention_plain), pos)


def run_combo(combo, device="cuda"):
    """Run one combination: (max|err|, tolerance, launches it made)."""
    kernel = combo[0]
    call, plain, pos = combo_call(*combo, device=device)
    counter = _COUNTERS[kernel]
    before = getattr(da, counter)
    out = call()
    launched = getattr(da, counter) - before
    ref = plain()
    if device != "cpu":
        torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    rel, floor = (1e-3, 1e-7) if kernel == "grouped" else (2e-3, 1e-6)
    tol = rel * ref.abs().max().item() + floor
    inactive = out[pos < 0] if kernel != "wide_cache_multi" else out[pos < 0, 0]
    if not torch.all(inactive == 0):
        err = float("inf")
    return err, tol, launched


def run_grid(quick=False, device="cuda", log=print):
    """Every combination; returns (rows, failures)."""
    rows, failures = [], []
    for combo in combos(quick):
        tag = tag_of(*combo)
        t0 = time.monotonic()
        try:
            err, tol, launched = run_combo(combo, device)
            ok = err <= tol and (launched == 1 or device == "cpu")
            msg = f"max|err| {err:.3g} (tol {tol:.3g}), {launched} launch"
        except Exception as e:   # a refused or failed launch is a FAIL line, not the end
            ok, err, tol, launched = False, None, None, 0
            msg = str(e).splitlines()[0][:200]
        rows.append(dict(combo=tag, ok=ok, max_abs_err=err, tol=tol, launches=launched))
        if not ok:
            failures.append(tag)
        log(f"{'PASS' if ok else 'FAIL'} {tag}: {msg} ({time.monotonic() - t0:.2f}s)")
    return rows, failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="Hkv in {2, 4}, rep 1, hd 128 and 256")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        sys.exit("kernel_smoke: no CUDA device (pass --device cpu for the plain versions)")
    rows, failures = run_grid(args.quick, args.device, log=lambda m: print(m, flush=True))
    print(f"# {len(rows) - len(failures)} combos passed, {len(failures)} failed", flush=True)
    if failures:
        print("KERNEL_SMOKE FAILED:", ", ".join(failures))
        sys.exit(1)
    print("KERNEL_SMOKE PASSED", flush=True)


if __name__ == "__main__":
    main()
