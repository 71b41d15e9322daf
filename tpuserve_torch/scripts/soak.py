#!/usr/bin/env python3
"""Concurrency soak: mixed infer/generate/status/metrics load against a live
server (PyTorch port of scripts/soak.py; no reference counterpart — the
reference client is single-threaded). Standard library only: urllib.request
and concurrent.futures.

Usage:
  python -m tpuserve_torch.scripts.soak --url http://localhost:8080 \
      --infer-model test_model --llm-model tiny_llm \
      [--threads 12] [--requests 15]

The infer op posts the infer model's first declared input; for an LLM whose
config declares `input_ids` [1, -1] INT32 it reaches LLMBackend.infer.
Exits non-zero on any non-200 response or transport error.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import random
import sys
import time
import urllib.error
import urllib.request


def _call(method: str, url: str, body=None, timeout: float = 60):
    """(status, text) of one request; HTTP error codes come back as statuses."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://localhost:8080")
    ap.add_argument("--infer-model", default="test_model")
    ap.add_argument("--llm-model", default="")
    ap.add_argument("--threads", type=int, default=12)
    ap.add_argument("--requests", type=int, default=15, help="per thread")
    args = ap.parse_args(argv)

    base = args.url.rstrip("/")
    errors = []
    counts = {"infer": 0, "generate": 0, "status": 0, "metrics": 0}

    # learn the infer model's input shape from its status
    status, text = _call("GET", f"{base}/models/{args.infer_model}")
    if status != 200:
        sys.exit(f"soak: GET /models/{args.infer_model} answered {status}: {text[:200]}")
    inp = json.loads(text)["config"]["inputs"][0]
    shape = [1 if d == -1 else int(d) for d in inp["shape"]]
    n_elems = 1
    for d in shape:
        n_elems *= d

    ops = ["infer", "infer", "status", "metrics"]
    if args.llm_model:
        ops.append("generate")

    def worker(i):
        rng = random.Random(i)
        for _ in range(args.requests):
            op = rng.choice(ops)
            try:
                if op == "infer":
                    status, text = _call(
                        "POST", f"{base}/models/{args.infer_model}/infer",
                        {"inputs": {inp["name"]: [rng.random() for _ in range(n_elems)]}},
                        timeout=300)
                elif op == "generate":
                    status, text = _call(
                        "POST", f"{base}/models/{args.llm_model}/generate",
                        {"input_ids": [rng.randint(1, 100) for _ in range(rng.randint(1, 6))],
                         "max_new_tokens": rng.randint(1, 8),
                         "temperature": rng.choice([0.0, 0.8])},
                        timeout=600)
                elif op == "status":
                    status, text = _call("GET", f"{base}/models/{args.infer_model}")
                else:
                    status, text = _call("GET", f"{base}/metrics")
                if status != 200:
                    errors.append((op, status, text[:120]))
                else:
                    counts[op] += 1
            except Exception as e:  # a transport error is a soak error: recorded, then fatal
                errors.append((op, type(e).__name__, str(e)[:120]))

    t0 = time.time()
    with cf.ThreadPoolExecutor(args.threads) as ex:
        list(ex.map(worker, range(args.threads)))

    print(f"soak: {sum(counts.values())} ok in {time.time()-t0:.0f}s {counts}, "
          f"{len(errors)} errors")
    for e in errors[:10]:
        print("  ERR", e)
    sys.exit(1 if errors else 0)


if __name__ == "__main__":
    main()
