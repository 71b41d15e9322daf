"""The port's anisotropic synthetic generator (tpuserve_torch.models.
synthetic) and accuracy script (tpuserve_torch.scripts.eval_accuracy)
against the JAX package's, on the CPU.

The generator's draws come from a torch.Generator and cannot equal
jax.random's, so both generators are held to the same structure, counted.
The script's modes run at `tiny` and are held to the JAX script's result
keys (read from its source: running the JAX modes costs minutes), finite
values, its gates and its exit code.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.models import synthetic as jsyn
from tpuserve_torch.models import llama as tllama
from tpuserve_torch.models import synthetic as tsyn
from tpuserve_torch.fixtures import create_test_model
from tpuserve_torch.scripts import eval_accuracy as teval
from tpuserve_torch.utils.errors import BackendError
from torch_parity import SMALL, write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """GPTQ's row loop issues thousands of small torch ops. With other test
    workers on the same cores, torch's intra-op thread pool spends them
    waiting for its threads (a GPTQ load on the CPU ran 240x slower with
    six workers), so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _structure(params, p, knobs):
    """What the generator promises, counted: the subspace rank of the
    embedding and of a residual write (wo), the massive embedding
    channels, the tail rows of every 2-D kernel."""
    f = {k: np.asarray(v, np.float64) for k, v in params.items()}
    r = max(4, int(round(p.dim * knobs["rank_frac"])))

    def rank(m):
        s = np.linalg.svd(m, compute_uv=False)
        return int((s > 1e-4 * s[0]).sum())

    col = np.sqrt((f["embed/weight"] ** 2).mean(0))
    tails = {}
    for name, w in f.items():
        if w.ndim == 2 and name.endswith("kernel"):
            row = np.linalg.norm(w, axis=1)
            tails[name] = int((row > 10 * np.median(row)).sum())
    return {"names": sorted((k, tuple(v.shape)) for k, v in f.items()),
            "embed_rank": rank(f["embed/weight"]), "wo_rank": rank(f["layers.0/wo/kernel"]),
            "r": r, "massive": int((col > 3 * np.median(col)).sum()), "tails": tails}


def test_synthetic_structure_matches_jax():
    """At `tiny` (one layer) with no leak and tails of median 100, the port's generator
    and the JAX package's give the same names and shapes, an embedding and
    residual writes of rank r = dim * rank_frac, dim * massive_frac
    massive channels and K * row_tail_frac tail rows in every kernel."""
    import jax

    knobs = dict(rank_frac=1.0 / 16.0, subspace_leak=0.0, row_tail_log_median=100.0,
                 massive_scale=10.0, massive_frac=0.02, row_tail_frac=0.02)
    pj = dataclasses.replace(jllama.LlamaParams.tiny(), n_layers=1)
    pt = dataclasses.replace(tllama.LlamaParams.tiny(), n_layers=1)
    gen = torch.Generator()
    gen.manual_seed(0)
    tp = tsyn.init_params_anisotropic(gen, pt, **knobs)
    jp = jsyn.init_params_anisotropic(jax.random.PRNGKey(0), pj, **knobs)
    st, sj = _structure(tp, pt, knobs), _structure(jp, pj, knobs)
    assert st == sj
    assert st["embed_rank"] == st["wo_rank"] == st["r"] == 4
    assert st["massive"] == 1
    assert set(st["tails"].values()) == {max(1, round(64 * 0.02)), max(1, round(128 * 0.02))}
    assert all(v.dtype == torch.float32 for v in tp.values())
    # the default knobs: leaked, so full rank; seeded
    gen.manual_seed(0)
    a = tsyn.init_params_anisotropic(gen, pt)
    gen.manual_seed(0)
    b = tsyn.init_params_anisotropic(gen, pt)
    assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ eval_accuracy
def _jax_result_keys(fn_name: str) -> set:
    """The result keys of scripts/eval_accuracy.py's function, read from its
    source: the dict it returns or builds, the keys it sets on `out`, and
    (for `evaluate`) the Llama branch's result.update."""
    with open(os.path.join(REPO, "scripts", "eval_accuracy.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn_name)

    def named(node, names=("out", "result")):
        return isinstance(node, ast.Name) and node.id in names

    keys, updates = set(), []
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and named(node.targets[0]) \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and named(node.targets[0].value) \
                and isinstance(node.targets[0].slice, ast.Constant):
            keys.add(node.targets[0].slice.value)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "update" and named(node.func.value):
            updates.append((node.lineno, {kw.arg for kw in node.keywords}))
    if updates:
        keys |= min(updates)[1]
    return keys


MODES = {
    "synthetic": ("evaluate_synthetic",
                  lambda: teval.evaluate_synthetic("tiny", 4, 128, 0, 64, 0, device="cpu")),
    "synthetic-gptq": ("evaluate_synthetic",
                       lambda: teval.evaluate_synthetic("tiny", 4, 128, 0, 64, 0,
                                                        quantizer="gptq", device="cpu")),
    "outlier": ("evaluate_outliers", lambda: teval.evaluate_outliers("tiny", 64, 0, device="cpu")),
    "anisotropic": ("evaluate_anisotropic",
                    lambda: teval.evaluate_anisotropic("tiny", 64, 0, device="cpu")),
    "kv-cache": ("evaluate_kv_cache",
                 lambda: teval.evaluate_kv_cache("tiny", "both", 64, 0, device="cpu")),
    "kv-long": ("evaluate_kv_long", lambda: teval.evaluate_kv_long("tiny", 64, 64, 0, device="cpu")),
}


def _finite(v) -> bool:
    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    return not isinstance(v, float) or np.isfinite(v)


@pytest.mark.parametrize("mode", list(MODES))
def test_eval_accuracy_modes(mode):
    """Each mode at `tiny` on the CPU: the JAX function's result keys (and
    `device`), finite values, the gate as the JAX script computes it, and
    int8 nearer the f32 model than int4."""
    fn_name, run = MODES[mode]
    res = run()
    assert set(res) == _jax_result_keys(fn_name) | {"device"}
    assert res["device"] == "cpu" and all(_finite(v) for v in res.values())
    if mode in ("outlier", "anisotropic"):
        assert 0 <= res["kl_int8_g128"] < res["kl_int4_rtn"]
        assert res["kl_int4_gptq"] < res["kl_int4_rtn"]
    if mode == "anisotropic":
        assert res["kl_int4_gptq_lorc32"] < res["kl_int4_gptq"]
        assert res["gate_pass"] == (min(res["kl_int4_gptq"], res["kl_int4_gptq_lorc32"]) <= 0.02
                                    and res["kl_int4_rtn"] > 0.02)
    if mode == "kv-cache":
        assert res["kl_fp_cache_to_int8_f32_scales"] < res["kl_fp_cache_to_int4"]
    if mode == "kv-long":
        assert res["kl_fp_cache_to_int8_nats"] < res["kl_fp_cache_to_int4_nats"]
    if mode == "synthetic":
        r8 = teval.evaluate_synthetic("tiny", 8, 128, 0, 64, 0, device="cpu")
        assert r8["kl_fp32_to_quant_nats"] < res["kl_fp32_to_quant_nats"]


def test_eval_accuracy_repository_model_and_cli(tmp_path, capsys, monkeypatch):
    """--model: a Llama of a repository, loaded through the port's
    repository and engine loader, RTN per its config (the JAX script's
    result keys); a classifier takes the classifier branch (the JAX
    script's keys for it: top-1 agreement and logit correlation); the
    CLI's exit code is the gate's."""
    cfg = {"name": "ll", "platform": "llm", "architecture": "llama",
           "model_params": dict(SMALL), "quantization": {"weights": "int8", "group_size": 128}}
    write_model(str(tmp_path), "ll", cfg)
    res = teval.evaluate(str(tmp_path), "ll", "", samples=32, seed=0, device="cpu")
    assert set(res) == _jax_result_keys("evaluate") | {"device"}
    assert res["metric"] == "perplexity" and np.isfinite(res["delta"])
    cdir = create_test_model(str(tmp_path), name="clf")  # the seed-42 MLP
    with open(os.path.join(cdir, "config.json")) as fh:
        clf = json.load(fh)
    clf["quantization"] = {"weights": "int8"}
    with open(os.path.join(cdir, "config.json"), "w") as fh:
        json.dump(clf, fh)
    res = teval.evaluate(str(tmp_path), "clf", "", samples=8, seed=0, device="cpu")
    assert res["metric"] == "top1_agreement" and res["device"] == "cpu"
    assert {"top1_agreement", "logit_correlation", "gate", "gate_pass"} <= set(res)
    rc = teval.main(["--kv-long-eval", "tiny", "--ctx", "32", "--samples", "32",
                     "--device", "cpu", "--json"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == (0 if json.loads(out)["gate_pass"] else 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendError, match="device='cpu'"):
        teval.main(["--synthetic", "tiny"])  # the card by default, never the CPU
