"""Time the decode-attention kernels of two checkouts of the repo on one card,
in turns (A, B, B, A), so that a change to a kernel is compared within one
machine and one power state.

Each turn runs in its own process from the checkout's root, builds that
checkout's kernels and calls its chip_smoke.py's kernel checks for the
flat, the paged and the multi-candidate decode attention, which time every
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
                    ("multi", cs.check_decode_attention_multi)):
    res = check(torch, timer, 20, p)
    for c in res["cases"]:
        key = " ".join(f"{k}={c[k]}" for k in ("kind", "S", "H", "Hkv", "L", "C", "window",
                                             "step_positions") if k in c)
        rows[f"{name} {key}"] = c["ms"]
print("AB_JSON " + json.dumps(rows), flush=True)
"""


def turn(tree: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=tree, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"turn in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("AB_JSON "))
    return json.loads(line[len("AB_JSON "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", help="checkout A (e.g. the parent commit, unpacked)")
    ap.add_argument("b", help="checkout B (e.g. the change)")
    args = ap.parse_args(argv)
    order = [("a", args.a), ("b", args.b), ("b", args.b), ("a", args.a)]
    turns = [(side, turn(tree)) for side, tree in order]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ab_attention.json"), "w") as fh:
        json.dump({"order": [s for s, _ in order], "turns": [t for _, t in turns]}, fh, indent=1)
    for case in turns[0][1]:
        a = [t[case] for s, t in turns if s == "a"]
        b = [t[case] for s, t in turns if s == "b"]
        ma, mb = sum(a) / len(a), sum(b) / len(b)
        print(f"{case}: A {' / '.join(f'{x:.4f}' for x in a)} ms, B "
              f"{' / '.join(f'{x:.4f}' for x in b)} ms, B/A {mb / ma:.3f}", flush=True)


if __name__ == "__main__":
    main()
