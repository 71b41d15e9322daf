"""The checkpoint and speculation scripts of tpuserve_torch against the JAX
package's (scripts/convert_hf_llama.py, eval_real_ppl.py, spec_bench.py,
spec_trace.py, verify_profile.py), on the CPU at tiny sizes:

- convert_hf_llama: the same parameter names, shapes, values and
  config.json as the JAX script from tiny HF Llama and Mixtral
  checkpoints; the converted entry served by the port's engine gives the
  JAX engine's greedy tokens on the JAX script's entry.
- eval_real_ppl --token-ids: the JAX script's result row (its keys, the
  calibration split, the perplexities within a stated tolerance).
- spec_bench, spec_trace, verify_profile with --device cpu at a tiny shape
  print the JAX scripts' keys and lines.
"""

import ast
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.serving.engine import GenerationEngine as JEngine
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.scripts import convert_hf_llama, eval_real_ppl, spec_bench, spec_trace
from tpuserve_torch.scripts import verify_profile
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.checkpoint import read_safetensors, write_safetensors
from torch_parity import SMALL, numpy_weights

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path):
    with open(path) as fh:
        return json.load(fh)


def _hf_llama(d, w, cfg, n_exp=0, seed=0):
    """An HF checkpoint (safetensors + config.json) of flat llama weights
    `w` (our names, [in, out]), mapped back to HF names ([out, in]); with
    n_exp experts a Mixtral block-sparse MoE in place of each MLP."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    hf = {"model.embed_tokens.weight": w["embed/weight"],
          "model.norm.weight": w["final_norm/scale"]}
    if "lm_head/kernel" in w:   # else tied to the embedding
        hf["lm_head.weight"] = w["lm_head/kernel"].T
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        hf[f"{pre}.input_layernorm.weight"] = w[f"layers.{i}/attn_norm/scale"]
        hf[f"{pre}.post_attention_layernorm.weight"] = w[f"layers.{i}/mlp_norm/scale"]
        for ours, theirs in names.items():
            if n_exp and ours.startswith("w_"):
                continue
            hf[f"{pre}.{theirs}.weight"] = w[f"layers.{i}/{ours}/kernel"].T
        if n_exp:
            d_model, ffn = cfg["hidden_size"], cfg["intermediate_size"]
            hf[f"{pre}.block_sparse_moe.gate.weight"] = rng.normal(size=(n_exp, d_model))
            for e in range(n_exp):
                epre = f"{pre}.block_sparse_moe.experts.{e}"
                hf[f"{epre}.w1.weight"] = rng.normal(size=(ffn, d_model)) * 0.05
                hf[f"{epre}.w2.weight"] = rng.normal(size=(d_model, ffn)) * 0.05
                hf[f"{epre}.w3.weight"] = rng.normal(size=(ffn, d_model)) * 0.05
    hf["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4)   # recomputed: skipped
    write_safetensors(os.path.join(d, "model.safetensors"),
                      {k: np.ascontiguousarray(v, np.float32) for k, v in hf.items()})


def _hf_config(n_exp=0):
    cfg = {"num_hidden_layers": SMALL["n_layers"], "num_attention_heads": SMALL["n_heads"],
           "num_key_value_heads": SMALL["n_kv_heads"], "hidden_size": SMALL["dim"],
           "head_dim": SMALL["head_dim"], "intermediate_size": SMALL["ffn_dim"],
           "vocab_size": SMALL["vocab_size"], "eos_token_id": [9, 10]}
    if n_exp:
        cfg.update(num_local_experts=n_exp, num_experts_per_tok=2, eos_token_id=2,
                   tie_word_embeddings=True)
    return cfg


@pytest.mark.parametrize("n_exp", [0, 4], ids=["llama", "mixtral"])
def test_converter_matches_jax_script(tmp_path, n_exp):
    """Every converted tensor (name, shape, dtype, values) and config.json
    equal to the JAX script's; Mixtral's experts stacked alike."""
    w = numpy_weights()
    if n_exp:
        w.pop("lm_head/kernel")       # tied: lm_head from the embedding
    _hf_llama(str(tmp_path / "hf"), w, _hf_config(n_exp), n_exp)
    jconv = _jax_script("convert_hf_llama")
    jdir = jconv.convert(str(tmp_path / "hf"), str(tmp_path / "jax"), "m", "1", "int4",
                         "int8", 4, 64)
    tdir = convert_hf_llama.convert(str(tmp_path / "hf"), str(tmp_path / "port"), "m", "1",
                                    "int4", "int8", 4, 64, device="cpu")
    ref, out = (read_safetensors(os.path.join(d, "model.safetensors")) for d in (jdir, tdir))
    assert sorted(out) == sorted(ref)
    for name in ref:
        assert out[name].dtype == ref[name].dtype and out[name].shape == ref[name].shape, name
        assert torch.equal(out[name], ref[name]), name
    if n_exp:
        assert out["layers.1/moe_gateup/kernel"].shape == (n_exp, SMALL["dim"],
                                                           2 * SMALL["ffn_dim"])
    cfgs = [_read_json(os.path.join(d, "config.json")) for d in (jdir, tdir)]
    assert cfgs[1] == cfgs[0]
    assert cfgs[1]["generation"]["eos_token_id"] == (2 if n_exp else 9)


def test_converted_entry_serves_the_jax_engines_tokens(tmp_path, monkeypatch):
    """The port's converted entry served by the port's engine (CPU, plain
    kernel versions) and the JAX script's entry by the JAX engine (its
    kernels in interpret mode): greedy tokens equal."""
    _hf_llama(str(tmp_path / "hf"), numpy_weights(), _hf_config())
    jdir = _jax_script("convert_hf_llama").convert(
        str(tmp_path / "hf"), str(tmp_path / "jax"), "m", "1", "int4", "int8", 2, 64)
    tdir = convert_hf_llama.convert(str(tmp_path / "hf"), str(tmp_path / "port"), "m", "1",
                                    "int4", "int8", 2, 64, device="cpu")
    for d in (jdir, tdir):   # full-length greedy runs, one decode step a dispatch
        path = os.path.join(d, "config.json")
        cfg = _read_json(path)
        cfg["generation"].update(eos_token_id=-1, decode_horizon=1)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    prompt = [5, 17, 100, 42, 7]
    monkeypatch.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
    monkeypatch.setattr(jllama, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
    jeng = JEngine(jdir, JModelConfig.from_file(os.path.join(jdir, "config.json")))
    jeng.start()
    try:
        ref = jeng.generate(prompt, max_new_tokens=4)["output_ids"]
    finally:
        jeng.stop()
    teng = GenerationEngine(tdir, ModelConfig.from_file(os.path.join(tdir, "config.json")),
                            device="cpu")
    teng.start()
    try:
        out = teng.generate(prompt, max_new_tokens=4)["output_ids"]
    finally:
        teng.stop()
    assert len(out) == len(prompt) + 4 and out == ref


# ------------------------------------------------------------ eval_real_ppl
# widths whose projections share three shapes (wo and w_down 128 x 128,
# w_gateup and lm_head 128 x 256), so that the JAX script's eager quantizer
# compiles for three
P_SYN = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=64,
             ffn_dim=128)


def _ppl_repo(tmp_path, quantization):
    """A tiny llama entry (f32 weights from a seed) and 4 windows of ids."""
    rng = np.random.default_rng(7)
    d, f, v, hd = P_SYN["dim"], P_SYN["ffn_dim"], P_SYN["vocab_size"], P_SYN["head_dim"]
    qd = P_SYN["n_heads"] * hd
    w = {"embed/weight": rng.normal(size=(v, d)), "final_norm/scale": np.ones(d),
         "lm_head/kernel": rng.normal(size=(d, v)) * 2 / np.sqrt(d)}
    for i in range(P_SYN["n_layers"]):
        pre = f"layers.{i}"
        w[f"{pre}/attn_norm/scale"] = np.ones(d)
        w[f"{pre}/mlp_norm/scale"] = np.ones(d)
        for name, shape in (("wq", (d, qd)), ("wk", (d, qd)), ("wv", (d, qd)), ("wo", (qd, d)),
                            ("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d))):
            w[f"{pre}/{name}/kernel"] = rng.normal(size=shape) / np.sqrt(shape[0])
    vdir = tmp_path / "models" / "syn" / "1"
    vdir.mkdir(parents=True)
    write_safetensors(str(vdir / "model.safetensors"),
                      {k: np.asarray(a, np.float32) for k, a in w.items()})
    cfg = {"name": "syn", "platform": "llm", "architecture": "llama",
           "inputs": [{"name": "input_ids", "shape": [1, -1], "data_type": "INT32"}],
           "outputs": [{"name": "output_ids", "shape": [1, -1], "data_type": "INT32"}],
           "model_params": dict(P_SYN),
           "generation": {"max_seq_len": 64, "max_slots": 2, "eos_token_id": -1},
           "quantization": quantization}
    with open(vdir / "config.json", "w") as fh:
        json.dump(cfg, fh)
    ids = rng.integers(0, v, 4 * 64)
    with open(tmp_path / "ids.json", "w") as fh:
        json.dump([int(t) for t in ids], fh)
    return str(tmp_path / "models"), str(tmp_path / "ids.json")


# (quantizer, bits, extra flags): RTN int4, and GPTQ with 2 calibration
# windows held out of the eval
PPL_CASES = [("rtn", 4, []), ("gptq", 4, ["--calib-windows", "2"])]


@pytest.mark.parametrize("quantizer,bits,extra", PPL_CASES, ids=["rtn", "gptq"])
def test_eval_real_ppl_matches_jax_script(tmp_path, monkeypatch, capsys, quantizer, bits,
                                          extra):
    """The port's --token-ids run against the JAX script's on one entry:
    the same result keys (plus `device`), window and calibration counts
    (GPTQ holds its calibration windows out: eval + calib == total), and
    perplexities within 1%: the fp legs are XLA's and torch's bf16 matmuls
    (measured 3.4e-4 and 9.4e-5 apart), the quantized legs the same codes
    through XLA's dequantizing qmatmul and the kernels' plain versions
    (measured equal to 4 decimals)."""
    repo, ids = _ppl_repo(tmp_path, {"weights": f"int{bits}", "group_size": 32})
    argv = ["--repository", repo, "--model", "syn", "--token-ids", ids, "--ctx", "64",
            "--max-windows", "4", "--bits", str(bits), "--group-size", "32",
            "--quantizer", quantizer, "--json"] + extra
    monkeypatch.setattr(sys, "argv", ["eval_real_ppl.py"] + argv)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    _jax_script("eval_real_ppl").main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = eval_real_ppl.main(argv + ["--device", "cpu"])
    assert set(out) == set(ref) | {"device"}
    for key in ("metric", "quantizer", "bits", "group_size", "ctx", "eval_windows",
                "calib_windows", "eval_tokens", "gate"):
        assert out[key] == ref[key], key
    assert out["calib_windows"] + out["eval_windows"] == 4 if quantizer == "gptq" \
        else out["eval_windows"] == 4
    for key in ("ppl_fp", "ppl_quant"):
        assert abs(out[key] - ref[key]) <= 1e-2 * ref[key], (key, out[key], ref[key])


def test_eval_real_ppl_text_without_transformers_names_token_ids(tmp_path, monkeypatch):
    """--text imports transformers only then; where it is absent the script
    exits naming --token-ids."""
    repo, _ = _ppl_repo(tmp_path, {"weights": "int4", "group_size": 32})
    text = tmp_path / "t.txt"
    text.write_text("hello")
    monkeypatch.setitem(sys.modules, "transformers", None)   # import fails
    with pytest.raises(SystemExit, match="--token-ids"):
        eval_real_ppl.main(["--text", str(text), "--tokenizer-json", "tok.json",
                            "--repository", repo, "--model", "syn", "--device", "cpu"])


# ------------------------------------------------------------ speculation
def _jax_strings(name) -> set:
    """Every string constant of the JAX script's source (its result keys
    and printed labels among them)."""
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as fh:
        tree = ast.parse(fh.read())
    return {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str)}


def _keys(d, out=None):
    out = set() if out is None else out
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict):
            _keys(v, out)
    return out


@pytest.fixture()
def tiny_spec(monkeypatch):
    for k, v in dict(TPUSERVE_SPEC_BENCH_MODEL="small", TPUSERVE_SPEC_BENCH_SLOTS="2",
                     TPUSERVE_SPEC_BENCH_NEW="12", TPUSERVE_SPEC_BENCH_K="4").items():
        monkeypatch.setenv(k, v)


def test_spec_bench_prints_the_jax_scripts_keys(tiny_spec, capsys):
    """spec_bench --device cpu on the 2-layer model: its JSON line carries
    the JAX script's keys (every one a key of the JAX script's result, and
    each workload's off/on rows), drafts fire on the repetitive workload."""
    spec_bench.main(["--device", "cpu"])
    cap = capsys.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    assert _keys(res) <= _jax_strings("spec_bench")
    assert {"metric", "spec_k", "spec_rounds", "repetitive", "random",
            "adversarial_t1"} <= set(res)
    for key in ("repetitive", "random", "adversarial_t1"):
        assert set(res[key]) == {"spec_off", "spec_on", "speedup"}
        assert set(res[key]["spec_on"]) == {"tokens_per_s", "spec_drafted", "spec_accepted",
                                            "acceptance"}
    assert res["repetitive"]["spec_on"]["spec_drafted"] > 0
    assert res["repetitive"]["spec_off"]["spec_drafted"] == 0
    assert "SPEC_BENCH DONE" in cap.err and "# targets: favorable" in cap.err


def test_spec_trace_prints_the_jax_scripts_lines(tiny_spec, capsys):
    """spec_trace --device cpu: the histogram lines kind(w=.., h=..) n=..
    total ..ms best ..ms over the port's dispatches, the measured-wave
    lines and the JAX script's JSON keys."""
    res = spec_trace.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert set(json.loads(lines[-1])) == {"metric", "tokens_per_s", "traced_s", "wall_s"}
    assert set(json.loads(lines[-1])) <= _jax_strings("spec_trace")
    assert any(ln.startswith("# measured wave:") for ln in lines)
    assert any(ln.startswith("# spec stats: drafted=") for ln in lines)
    hist = [ln for ln in lines if re.match(r"_dev_\w+\(w=\d+,h=\d+\)\s+n=\s*\d+ total\s+\d+ms"
                                           r"\s+best\s+[\d.]+ms", ln)]
    assert hist and sum(v["n"] for v in res["dispatches"].values()) >= 1
    assert any(k.startswith("_dev_decode(") for k in res["dispatches"])


def test_verify_profile_prints_every_variant(monkeypatch, capsys):
    """verify_profile --device cpu on the 2-layer model at S=2, C=3: a round
    line with every variant (the JAX script's seven names), the best-ms
    block, and llama.apply_rope / _quantize_kv_cache restored."""
    from tpuserve_torch.models import llama

    for k, v in dict(TPUSERVE_VP_MODEL="small", TPUSERVE_VP_SLOTS="2", TPUSERVE_VP_C="3",
                     TPUSERVE_VP_SEQ="128", TPUSERVE_VP_ROUNDS="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(verify_profile, "S", 2)
    monkeypatch.setattr(verify_profile, "C", 3)
    monkeypatch.setattr(verify_profile, "L", 128)
    monkeypatch.setattr(verify_profile, "ROUNDS", 2)
    rope, quant = llama.apply_rope, llama._quantize_kv_cache
    res = verify_profile.main(["--device", "cpu"])
    out = capsys.readouterr().out
    names = ["dec", "blk8", "blk72", "ver", "ver_nr", "ver_nq", "ver_nrq"]
    assert set(names) <= _jax_strings("verify_profile") | set(
        re.findall(r"^\s+(\w+)\s", _jax_doc("verify_profile"), re.M))
    assert list(res["best_ms"]) == names
    rounds = [ln for ln in out.splitlines() if ln.startswith("round ")]
    assert len(rounds) == 2 and all(f" {n} " in ln + " " for n in names for ln in rounds)
    assert "# best ms per dispatch" in out
    assert llama.apply_rope is rope and llama._quantize_kv_cache is quant


def _jax_doc(name) -> str:
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as fh:
        return ast.get_docstring(ast.parse(fh.read()))
