"""Time the decode-attention kernels of two checkouts of the repo on one card,
in turns (A, B, B, A), so that a change to a kernel is compared within one
machine and one power state.

Each turn runs in its own process from the checkout's root, builds that
checkout's kernels and calls its chip_smoke.py's kernel checks for the
flat, the paged and the multi-candidate decode attention and for
decode_attention_wide (the flat kernel at the sweep's shape), which time every
case with CUDA events around a CUDA graph, inputs rotated past the L2.
Then the grouped decode attention at the [grouped] phase's shape (S=64,
L=256, Llama-2-7B heads, step positions; and rep 4, Hkv=8) under
TPUSERVE_ATTN_DYNSKIP=0 and =1, timed the same way through the public
entries both checkouts have: the int8 window (g_kv 1 and Hkv), a packed
int4 window as the decode step hands it over (a checkout without the
packed route unpacks it with unpack_kv_codes first, as its decode step
did) and a bf16 window (the default cache's, unscaled; g_kv 1, the JAX
package's 16 // rep and Hkv: one launch in a checkout whose kernel takes
one kv unit a block whatever g_kv); and the sweep's grouped variants (its own
timing: best of 3 runs of 30 calls). The script prints one line per case with the two checkouts'
times (mean of their turns) and their ratio, and writes every turn to
chiprun_out/ab_attention.json.

    python -m tpuserve_torch.scripts.ab_attention PARENT_DIR CHANGE_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from tpuserve_torch.models.llama import LlamaParams
torch.backends.cuda.matmul.allow_tf32 = False
p = LlamaParams.llama2_7b()
timer = cs.Timer(torch)
rows = {}
for name, check in (("flat", cs.check_decode_attention), ("paged", cs.check_decode_attention_paged),
                    ("multi", cs.check_decode_attention_multi),
                    ("wide", lambda torch, timer, reps, p: cs.check_decode_attention_wide(
                        torch, timer, reps))):
    res = check(torch, timer, 20, p)
    for c in res["cases"]:
        key = " ".join(f"{k}={c[k]}" for k in ("kind", "S", "H", "Hkv", "L", "C", "window",
                                             "block_l", "step_positions") if k in c)
        rows[f"{name} {key}"] = c["ms"]
import math, os
from tpuserve_torch.ops import decode_attention as da
from tpuserve_torch.models.llama import unpack_kv_codes
g = torch.Generator(device="cuda")
g.manual_seed(8)
s, l, hd = 64, 256, 128
pos = cs.step_positions(torch, g, s)
for hkv in (32, 8):
    w = hkv * hd
    nl = max(2, math.ceil(cs.L2_FLUSH_BYTES / (2 * s * l * w)))
    kv8 = [torch.randint(-127, 128, (nl, s, l, w), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.int8) for _ in range(2)]
    nl4 = max(2, math.ceil(cs.L2_FLUSH_BYTES / (s * l * w)))
    kv4 = [torch.randint(0, 256, (nl4, s, l, w // 2), generator=g, device="cuda",
                         dtype=torch.int32).to(torch.uint8) for _ in range(2)]
    sc = [(torch.rand((max(nl, nl4), s, hkv, l), generator=g, device="cuda") + 0.5) * 0.01
          for _ in range(2)]
    q = (torch.randn((s, 32, hd), generator=g, device="cuda") / hd ** 0.5).to(torch.bfloat16)
    nlf = max(2, math.ceil(cs.L2_FLUSH_BYTES / (4 * s * l * w)))
    kvf = [torch.randn((nlf, s, l, hkv, hd), generator=g, device="cuda").to(torch.bfloat16)
           for _ in range(2)]

    def bf16(i, g_kv):
        li = i % nlf
        return da.decode_attention(q, kvf[0][li], kvf[1][li], None, None, pos, g_kv=g_kv)

    def int8(i, g_kv):
        li = i % nl
        return da.decode_attention(q, kv8[0][li].view(s, l, hkv, hd), kv8[1][li].view(s, l, hkv, hd),
                                   sc[0][li].transpose(1, 2), sc[1][li].transpose(1, 2), pos,
                                   g_kv=g_kv)

    def int4(i):
        li = i % nl4
        if hasattr(da, "decode_attention_packed"):
            return da.decode_attention_packed(q, kv4[0][li], kv4[1][li], sc[0][li], sc[1][li], pos)
        k4, v4 = (unpack_kv_codes(t[li]).view(s, l, hkv, hd) for t in kv4)
        return da.decode_attention(q, k4, v4, sc[0][li].transpose(1, 2), sc[1][li].transpose(1, 2),
                                   pos)

    for skip in ("0", "1"):
        os.environ["TPUSERVE_ATTN_DYNSKIP"] = skip
        key = f"grouped S={s} H=32 Hkv={hkv} L={l} step positions dynskip={skip}"
        rows[f"{key} int8 g_kv=1"] = timer.ms(lambda i: int8(i, 1), 20)
        rows[f"{key} int8 g_kv={hkv}"] = timer.ms(lambda i: int8(i, hkv), 20)
        rows[f"{key} packed int4 window"] = timer.ms(int4, 20)
        for g_kv in dict.fromkeys((1, 16 // (32 // hkv), hkv)):
            rows[f"{key} bf16 g_kv={g_kv}"] = timer.ms(lambda i: bf16(i, g_kv), 20)
    os.environ.pop("TPUSERVE_ATTN_DYNSKIP")
    del kv8, kv4, sc, kvf
    torch.cuda.empty_cache()
from tpuserve_torch.scripts import sweep_attention as sweep
for r in sweep.run(["g1s", "g8s", "g16s", "g32s", "g32s_bl64"], sweep.shapes(),
                   torch.device("cuda")):
    if "us" in r:
        rows[f"sweep {r['label']}"] = r["us"] / 1e3
print("AB_JSON " + json.dumps(rows), flush=True)
"""


def turn(tree: str, code: str = _TURN) -> dict:
    """Run `code` in its own process from the checkout's root; return the
    dict it prints on its AB_JSON line."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"turn in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("AB_JSON "))
    return json.loads(line[len("AB_JSON "):])


def run_ab(argv, code: str, out_name: str, description: str) -> None:
    """Turns A, B, B, A of `code` in the two checkouts named on the command
    line; every turn into chiprun_out/`out_name`, one line per case."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("a", help="checkout A (e.g. the parent commit, unpacked)")
    ap.add_argument("b", help="checkout B (e.g. the change)")
    args = ap.parse_args(argv)
    order = [("a", args.a), ("b", args.b), ("b", args.b), ("a", args.a)]
    turns = [(side, turn(tree, code)) for side, tree in order]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", out_name), "w") as fh:
        json.dump({"order": [s for s, _ in order], "turns": [t for _, t in turns]}, fh, indent=1)
    for case in dict.fromkeys(k for _, t in turns for k in t):  # every case, in order
        a = [t[case] for s, t in turns if s == "a" and case in t]
        b = [t[case] for s, t in turns if s == "b" and case in t]
        if not a or not b:
            print(f"{case}: only in {'A' if a else 'B'}: "
                  f"{' / '.join(f'{x:.4f}' for x in a or b)} ms", flush=True)
            continue
        ma, mb = sum(a) / len(a), sum(b) / len(b)
        print(f"{case}: A {' / '.join(f'{x:.4f}' for x in a)} ms, B "
              f"{' / '.join(f'{x:.4f}' for x in b)} ms, B/A {mb / ma:.3f}", flush=True)


def main(argv=None) -> None:
    run_ab(argv, _TURN, "ab_attention.json", __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
