"""Time the decode-attention kernels of two checkouts of the repo on one card,
in turns (A, B, B, A), so that a change to a kernel is compared within one
machine and one power state.

Each turn runs in its own process from the checkout's root, builds that
checkout's kernels and calls its chip_smoke.py's kernel checks for the
flat, the paged and the multi-candidate decode attention and for
decode_attention_wide (the flat kernel at the sweep's shape), which time every
case with CUDA events around a CUDA graph, inputs rotated past the L2. The
script prints one line per case with the two checkouts' times (mean of
their turns) and their ratio, and writes every turn to
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
