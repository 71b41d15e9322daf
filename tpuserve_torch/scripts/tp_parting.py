"""Where a tensor-parallel stage's greedy tokens part from one rank's.

The pipeline at pp 2 (tp 1, then tp 2) and the one-rank path decode the
same prompt on the same seeded int4 weights (Llama-2-7B widths cut to
--layers layers, int8 KV with bf16 scales, TPUSERVE_DECODE_ATTN=xla), the
pipeline's ranks as threads of this process with their collectives done in
place. Printed: each decode step's largest logit difference from the
one-rank path and whether the argmax agrees, then, at the step where the
difference is largest, every layer's largest |hidden| of slot 0 on the
one-rank path and its largest difference from the pipeline's.

    python -m tpuserve_torch.scripts.tp_parting [--layers 8] [--steps 15]

Needs a card (the kernels of the served path run; their plain versions
are not used).
"""

from __future__ import annotations

import argparse
import collections
import os
import threading


class _Comm:
    """all_reduce among threads, one thread a rank (sum or max, rank order)."""

    def __init__(self):
        self.cv = threading.Condition()
        self.slots = {}
        self.seq = collections.defaultdict(int)

    def bind(self, rank):
        comm = self

        class RankComm:
            def all_reduce(self, t, op, ranks):
                import torch

                with comm.cv:
                    n = comm.seq[(ranks, rank)]
                    comm.seq[(ranks, rank)] += 1
                    e = comm.slots.setdefault((ranks, n), {"v": {}, "out": None, "read": 0})
                    e["v"][rank] = t.clone()
                    if len(e["v"]) == len(ranks):
                        out = e["v"][ranks[0]].clone()
                        for r in ranks[1:]:
                            out = torch.maximum(out, e["v"][r]) if op == "max" else out + e["v"][r]
                        e["out"] = out
                        comm.cv.notify_all()
                    while e["out"] is None:
                        comm.cv.wait()
                    e["read"] += 1
                    out = e["out"]
                    if e["read"] == len(ranks):
                        del comm.slots[(ranks, n)]
                t.copy_(out)
                return t

        return RankComm()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpuserve_torch.scripts.tp_parting")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--prompt-len", type=int, default=5)
    ap.add_argument("--seed", type=int, default=23, help="the prompt's draw")
    args = ap.parse_args(argv)
    os.environ["TPUSERVE_DECODE_ATTN"] = "xla"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tp_parting needs a card")
    from tpuserve_torch import kernels
    from tpuserve_torch.models import llama
    from tpuserve_torch.models.llama_bench import init_quantized_params
    from tpuserve_torch.parallel import pipeline
    from tpuserve_torch.parallel.mesh import Mesh

    kernels.lib()
    dev = "cuda"
    p = llama.LlamaParams(n_layers=args.layers)
    params = init_quantized_params(p, bits=4, group_size=128, device=dev, seed=42)
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, p.vocab_size, (args.prompt_len,), generator=gen).tolist()
    n_slots, l_max = 64, 256
    bucket = 16
    while bucket < len(prompt):
        bucket *= 2
    tokens = torch.zeros((1, bucket), dtype=torch.long, device=dev)
    tokens[0, :len(prompt)] = torch.tensor(prompt)
    hidden = {}   # (path, step) -> [(layer input, layer output)] of slot 0
    where = threading.local()
    real_block = llama._forward_block

    def recording_block(prm, pre, x, p_, attn_fn, mm=None):
        y = real_block(prm, pre, x, p_, attn_fn, mm=mm)
        key = getattr(where, "key", None)
        if key is not None and x.dim() == 2 and getattr(where, "mb0", True):
            hidden.setdefault(key, []).append((x[0].float().clone(), y[0].float().clone()))
        return y

    real_mb = pipeline._microbatch

    def tracking_mb(stacks, p_, p_loc, x, cache, pos, pos_host, row0, *rest, **kw):
        where.mb0 = row0 == 0   # slot 0's microbatch
        return real_mb(stacks, p_, p_loc, x, cache, pos, pos_host, row0, *rest, **kw)

    llama._forward_block = pipeline._forward_block = recording_block
    pipeline._microbatch = tracking_mb

    def step_inputs(tok, i):
        t = torch.zeros(n_slots, dtype=torch.long, device=dev)
        pos = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
        t[0], pos[0] = tok, len(prompt) + i
        return t, pos

    cache = llama.KVCache.create(p, n_slots, l_max, quantized=True, dtype=torch.bfloat16,
                                 scale_dtype=torch.bfloat16, device=dev)
    logits, _ = llama.prefill(params, p, tokens, cache, 0, len(prompt))
    ref, toks = [logits[0].float()], [int(logits[0].argmax())]
    for i in range(args.steps):
        t, pos = step_inputs(toks[-1], i)
        where.key = ("one", i)
        logits, _ = llama.decode_step(params, p, t, cache, pos, window=l_max)
        where.key = None
        ref.append(logits[0].float())
        toks.append(int(logits[0].argmax()))

    for tp in (1, 2):
        stacked = pipeline.stack_layer_params(params, p, tp=tp)
        comm, outs = _Comm(), [None] * (2 * tp)

        def rank(r):
            m = Mesh(tp, 1, 1, r, comm.bind(r), pp=2)
            blk = pipeline.place_pipeline_params(stacked, m)
            c = pipeline.stage_cache(p, m, n_slots, l_max, True, dtype=torch.bfloat16,
                                     scale_dtype=torch.bfloat16, device=dev)
            lg, _ = pipeline.pp_prefill(blk, p, tokens, c, 0, len(prompt), m)
            got = [lg[0].float()]
            for i in range(args.steps):
                t, pos = step_inputs(toks[i], i)
                # slot 0's layers: stage 0 on rank 0, stage 1 on rank tp
                where.key = ("pp", tp, i) if r in (0, tp) else None
                lg, _ = pipeline.pp_decode_step(blk, p, t, c, pos, m, window=l_max)
                where.key = None
                got.append(lg[0].float())
            outs[r] = got

        threads = [threading.Thread(target=rank, args=(r,)) for r in range(2 * tp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        diffs = [(a - b).abs().max().item() for a, b in zip(outs[0], ref)]
        agree = [int(a.argmax()) == t for a, t in zip(outs[0], toks)]
        print(f"pp 2 x tp {tp}: max|logits - one-rank| a step {[round(d, 4) for d in diffs]}; "
              f"argmax equal {agree}", flush=True)
        worst = max(range(1, len(diffs)), key=lambda j: diffs[j])
        one, pp = hidden.get(("one", worst - 1), []), hidden.get(("pp", tp, worst - 1), [])
        for layer, ((xa, ya), (_, yb)) in enumerate(zip(one, pp)):
            print(f"  step {worst}, layer {layer}: one-rank |hidden| max in "
                  f"{xa.abs().max().item():.4g}, out {ya.abs().max().item():.4g}; "
                  f"|out - pipeline's| max {(ya - yb).abs().max().item():.4g}", flush=True)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
