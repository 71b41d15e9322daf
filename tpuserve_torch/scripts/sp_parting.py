"""Where the sequence-parallel decode's greedy tokens part from one rank's.

A one-rank engine (Llama-2-7B widths cut to --layers layers, int4 g128
weights drawn from the engine's seed, int8 KV, 512 positions, prompts
admitted in chunks of 64; TPUSERVE_DECODE_ATTN=xla) holds one request: a
periodic prompt (--prompt-len tokens, a 12-token period from numpy's
default_rng(--seed)), then --steps greedy tokens of its own decode steps.
The same steps run again on the same weights over an sp 2 mesh of
threads, collectives done in place (the 5D cache, L / 2 a rank; attention
the flash-decoding merge of the sharded engine). Printed: each step's
largest |logit| difference and the two argmaxes where they differ; then,
at the step where the difference is largest, each layer's largest
|hidden| on the one-rank path and the merge's difference from it in the
layer's input, q, k, attention output and output, and each rank's
partial there (its max score m, its mass, whether finite).

    python -m tpuserve_torch.scripts.sp_parting [--layers 8] [--steps 64]

Needs a card (the kernels of the served path run).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import threading


def slot_steps(engine, p, prompt, shared, sp=1, before_step=None):
    """One request on a one-rank engine's weights: its prompt admitted as
    the engine admits it (whole, or in prefill_chunk chunks) into a
    one-slot cache of the engine's kind, then a decode step for each token
    in `shared` (`before_step()` before each). Returns the logits [V] f32
    after the prefill and after each step. With sp > 1 the same runs over
    an sp mesh of threads (the 5D cache, L / sp a rank), so that its
    attention is the sharded engine's flash-decoding merge (rank 0's
    logits)."""
    import torch

    from tpuserve_torch.models import llama

    ec, n, cs, dev = engine.cache, len(prompt), engine._chunk_size, engine.device

    def run():
        cache = llama.KVCache.create(
            p, 1, engine.max_seq_len // sp, quantized=ec.quantized,
            scale_dtype=ec.k_scale.dtype if ec.quantized else torch.float32,
            kv_bits=ec.kv_bits, device=dev, flat=sp == 1)
        if cs and n > cs:
            for c0 in range(0, n, cs):
                m = min(cs, n - c0)
                logits, _ = llama.prefill_chunk(
                    engine.params, p, engine._tokens(prompt[c0:c0 + m], cs), cache, 0, c0, m,
                    window=engine._bucket_len(min(c0 + cs, engine.max_seq_len)))
        else:
            logits, _ = llama.prefill(engine.params, p,
                                      engine._tokens(prompt, engine._bucket_len(n)), cache, 0, n)
        out = [logits[0].float()]
        for j, tok in enumerate(shared):
            if before_step is not None:
                before_step()
            toks = torch.tensor([tok], dtype=torch.long, device=dev)
            pos = torch.tensor([n + j], dtype=torch.int32, device=dev)
            logits, _ = llama.decode_step(engine.params, p, toks, cache, pos,
                                          window=engine._window(n + j))
            out.append(logits[0].float())
        return out

    if sp == 1:
        return run()
    from tpuserve_torch.parallel import sharding
    from tpuserve_torch.parallel.mesh import Mesh
    from tpuserve_torch.scripts.tp_parting import _Comm

    comm, outs, errors = _Comm(), [None] * sp, []

    def rank(r):
        try:
            with sharding.use_mesh(Mesh(1, 1, sp, r, comm.bind(r))):
                outs[r] = run()
        except BaseException as e:  # re-raised in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpuserve_torch.scripts.sp_parting")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, default=160)
    ap.add_argument("--seed", type=int, default=5, help="the prompt's period's draw")
    args = ap.parse_args(argv)
    os.environ["TPUSERVE_DECODE_ATTN"] = "xla"
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sp_parting needs a card")
    from tpuserve_torch.models import llama
    from tpuserve_torch.parallel import sharding
    from tpuserve_torch.repository.config import ModelConfig
    from tpuserve_torch.serving.engine import GenerationEngine

    p = dataclasses.replace(llama.LlamaParams.llama2_7b(), n_layers=args.layers)
    cfg = {"name": "sp_parting", "platform": "llm", "architecture": "llama",
           "model_params": {"vocab_size": p.vocab_size, "dim": p.dim, "n_layers": p.n_layers,
                            "n_heads": p.n_heads, "n_kv_heads": p.n_kv_heads,
                            "head_dim": p.head_dim, "ffn_dim": p.ffn_dim,
                            "init": "random_quantized", "seed": 0},
           "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int8"},
           "generation": {"max_seq_len": 512, "max_slots": 1, "eos_token_id": -1,
                          "prefill_chunk": 64}}
    vdir = tempfile.mkdtemp(prefix="sp_parting_")
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    engine = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cuda")
    engine.start()
    try:
        period = np.random.default_rng(args.seed).integers(100, p.vocab_size - 1, 12).tolist()
        prompt = (period * (args.prompt_len // 12 + 1))[:args.prompt_len]
        toks = []
        for _ in range(args.steps):   # the one-rank path's own greedy tokens
            toks.append(int(slot_steps(engine, p, prompt, toks)[-1].argmax()))
        one = slot_steps(engine, p, prompt, toks[:-1])
        merge = slot_steps(engine, p, prompt, toks[:-1], sp=2)
        diffs = [(a - b).abs().max().item() for a, b in zip(one, merge)]
        parts = [(j, int(a.argmax()), int(b.argmax())) for j, (a, b) in enumerate(zip(one, merge))
                 if int(a.argmax()) != int(b.argmax())]
        print(f"tokens {toks}", flush=True)
        print(f"max|logits, merge - one-rank| after the prefill and each step "
              f"{[round(d, 4) for d in diffs]}; argmax differs at (step, one-rank, merge) "
              f"{parts}", flush=True)
        worst = max(range(1, len(diffs)), key=lambda j: diffs[j])

        where, rec = threading.local(), {}
        real_block, real_partial = llama._forward_block, sharding.seq_partial

        def block(prm, pre, x, p_, attn_fn, mm=None):
            key = getattr(where, "key", None)
            if key is None:
                return real_block(prm, pre, x, p_, attn_fn, mm=mm)

            def attn(q, k, v):
                o = attn_fn(q, k, v)
                rec.setdefault(key, []).append(
                    {"x": x[0].float(), "q": q[0].float(), "k": k[0].float(), "o": o[0].float()})
                return o

            y = real_block(prm, pre, x, p_, attn, mm=mm)
            rec[key][-1]["y"] = y[0].float()
            return y

        def partial(q, k_l, v_l, ks, vs, qpos, l_off):
            o, m, mass = real_partial(q, k_l, v_l, ks, vs, qpos, l_off)
            key = getattr(where, "key", None)
            if key is not None:
                rec.setdefault(key + ("partial",), []).append(
                    {"m": m[0], "mass": mass[0], "finite": bool(torch.isfinite(o).all())})
            return o, m, mass

        def hook(path):
            def before():
                where.n = getattr(where, "n", 0) + 1
                mesh = getattr(sharding._THREAD, "mesh", None)
                where.key = (path, 0 if mesh is None else mesh.rank) \
                    if where.n == worst else None
            return before

        llama._forward_block, sharding.seq_partial = block, partial
        try:
            for path, sp in (("one", 1), ("merge", 2)):
                where.n = 0
                slot_steps(engine, p, prompt, toks[:worst], sp=sp, before_step=hook(path))
        finally:
            llama._forward_block, sharding.seq_partial = real_block, real_partial
        for layer, (a, b) in enumerate(zip(rec[("one", 0)], rec[("merge", 0)])):
            d = {k: (a[k] - b[k]).abs().max().item() for k in ("x", "q", "k", "o", "y")}
            print(f"step {worst}, layer {layer}: one-rank |x| {a['x'].abs().max().item():.4g}, "
                  f"|o| {a['o'].abs().max().item():.4g}, |y| {a['y'].abs().max().item():.4g}; "
                  f"merge - one-rank: x {d['x']:.4g}, q {d['q']:.4g}, k {d['k']:.4g}, "
                  f"o {d['o']:.4g}, y {d['y']:.4g}", flush=True)
        for r in (0, 1):
            for layer, d in enumerate(rec.get(("merge", r, "partial"), [])):
                print(f"step {worst}, rank {r}, layer {layer}: m [{d['m'].min().item():.4g}, "
                      f"{d['m'].max().item():.4g}], mass [{d['mass'].min().item():.4g}, "
                      f"{d['mass'].max().item():.4g}], finite {d['finite']}", flush=True)
    finally:
        engine.stop()
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
