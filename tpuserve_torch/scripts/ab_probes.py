"""Time the vector add, the unpack-microbenchmark kernels and the
attention probes of two checkouts of the repo on one card, in turns (A, B,
B, A), as ab_attention.py does for the decode attention: each turn builds
that checkout's kernels and runs its chip_smoke.py's vector-add check (1M
elements of each dtype the checkout takes, inputs rotated past the L2),
unpack-probe check (the five variants at the microbenchmark's defaults, x
int8 [262144, 2048], 537 MB), attention-probe check (dma_bound,
dma_wide 2-D and 3-D, dot_only at the sweep's shape, K and V 2 x 67 MB)
and diag_bw's copy (pcopy, pcopy4d, pdyn at diag_bw's defaults, K and V
2 x 67 MB; chip_smoke's check at block_l 256, and its diag_bw phase, every
mode at block_l 256 and the copy forms at 64 and 16).
The checks time with CUDA events around a CUDA graph. One line per case with both checkouts' times (mean of their
turns) and their ratio; the library calls (torch.add, x.sum, torch._int_mm)
are cases too, so their ratio shows the noise of the call. A case one
checkout lacks is printed with its own times. Every turn goes to
chiprun_out/ab_probes.json.

    python -m tpuserve_torch.scripts.ab_probes PARENT_DIR CHANGE_DIR
"""

from __future__ import annotations

from tpuserve_torch.scripts.ab_attention import run_ab

_TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
timer = cs.Timer(torch)
rows = {}
va = cs.check_vector_add(torch, timer, 20)
for c in va.get("cases", [dict(va, dtype="float32")]):
    rows[f"vector_add 1M {c['dtype']}"] = c["ms"]
    rows[f"torch.add 1M {c['dtype']}"] = c["library_ms"]
for name, r in cs.check_unpack_probes(torch, timer, 20).items():
    rows[f"{name} x [262144, 2048]"] = r["ms"]
    if r["library_ms"] is not None:
        rows[f"library beside {name}"] = r["library_ms"]
for name, r in cs.check_probes(torch, timer, 20).items():
    rows[f"{name} K, V [64, 256, 32, 128]"] = r["ms"]
dc = cs.check_diag_copy(torch, timer, 20)
for c in dc["cases"]:
    rows[f"diag_copy {c['mode']} block_l 256"] = c["ms"]
rows["torch.sum over the views"] = dc["library_ms"]
for r in cs.phase_diag_bw(torch)["records"]:
    rows[f"diag_bw {r['mode']} block_l {r['block_l']} (best of 3)"] = r["us"] / 1e3
print("AB_JSON " + json.dumps(rows), flush=True)
"""


def main(argv=None) -> None:
    run_ab(argv, _TURN, "ab_probes.json", __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
