"""Time the quant-matmul of two checkouts of the repo on one card, in turns
(A, B, B, A), as ab_attention.py does for the decode attention: each turn
builds that checkout's kernels and runs its chip_smoke.py's quant-matmul
check (every 7B weight shape, int4 and int8, W4A8, the group sizes a
64-row stage cannot tile; inputs rotated past the L2, CUDA events around a
CUDA graph), then f32 x at wo's width (int4 g128, g96 and g40) on each
checkout's own route. One line per case with both checkouts' times (mean of their
turns) and their ratio, the per-step totals among them (the W4A8 step
summed from its cases alike in both); a case one checkout lacks is
printed with its own times. Every turn goes to
chiprun_out/ab_quant_matmul.json.

    python -m tpuserve_torch.scripts.ab_quant_matmul PARENT_DIR CHANGE_DIR
"""

from __future__ import annotations

from tpuserve_torch.scripts.ab_attention import run_ab

_TURN = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from tpuserve_torch.models.llama import LlamaParams
torch.backends.cuda.matmul.allow_tf32 = False
p = LlamaParams.llama2_7b()
res = cs.check_quant_matmul(torch, cs.Timer(torch), 20, p)
rows = {"per decode step (B=64)": res["ms"]}
if "verify" in res:
    rows["per verify step (B=72)"] = res["verify"]["ms"]
# the W4A8 step (129 calls at B=64, int4 g128) from the cases, as both
# checkouts record them
w4 = [c for c in res["cases"] if c["act_bits"] == 8 and c["group_size"] == 128 and c["B"] == 64]
if w4:
    rows["per W4A8 decode step (B=64)"] = sum(
        c["ms"] * (1 if c["name"] == "lm_head" else p.n_layers) for c in w4)
for c in res["cases"]:
    rows[f"{c['name']} K={c['K']} N={c['N']} B={c['B']} int{c['bits']} g{c['group_size']}"
         + (" W4A8" if c["act_bits"] else "")] = c["ms"]
# f32 x at wo's width (g128, an odd and a masked group), each checkout's own route
from tpuserve_torch.ops.quant_matmul import quant_matmul
timer = cs.Timer(torch)
for k, gs in ((4096, 128), (4032, 96), (4000, 40)):
    qts = [cs._qt_random(torch, 4, k, p.dim, gs) for _ in range(24)]   # 200 MB, past the L2
    x = torch.randn((64, k), device="cuda")
    rows[f"f32 x wo K={k} N={p.dim} B=64 int4 g{gs}"] = timer.ms(
        lambda i: quant_matmul(x, qts[i % len(qts)]), 20)
    del qts
print("AB_JSON " + json.dumps(rows), flush=True)
"""


def main(argv=None) -> None:
    run_ab(argv, _TURN, "ab_quant_matmul.json", __doc__.splitlines()[0])


if __name__ == "__main__":
    main()
