"""Sharded serving across processes on the CPU: gloo ranks, the event bus and
the multi-process front (tpuserve_torch.parallel, server/follower.py).

- the engine at tensor_parallel 2, and at data_parallel 2 x
  sequence_parallel 2 with a prompt over both sp halves (admitted in
  chunks), starts its own follower ranks and gives the one-rank engine's
  greedy tokens on the same checkpoint;
- two `python -m tpuserve_torch.server` processes joined by
  TPUSERVE_COORDINATOR / NUM_PROCESSES / PROCESS_ID answer REST with the
  same tokens;
- dispatcher.MultiHostGenerator (the sharded path without the scheduler)
  on two ranks;
- what the port leaves out, and the JAX engine's refusals, are refused
  with a BackendError naming them (the CLI's form keeps the JAX multi-host
  refusals of pipeline_parallel, paged KV and speculation), and a failed
  sharded start leaves no live-engine mark.

Every spawned rank runs under a timeout (TPUSERVE_DIST_TIMEOUT 60 s for the
groups; the engine waits 60 s for its ranks at stop and kills the rest; the
CLI processes are killed at 120 s).
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from tpuserve_torch.engine.manager import InferenceManager
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.serving import engine as engine_mod
from tpuserve_torch.serving.engine import GenerationEngine
from tpuserve_torch.utils.errors import BackendError, TpuServeError
from torch_parity import SMALL, write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 120
PROMPTS = [[5, 17, 100, 42, 7], list(range(30, 70)), [3, 1, 4, 1, 5, 9, 2, 6]]

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ranks_env(monkeypatch):
    monkeypatch.setenv("TPUSERVE_DIST_TIMEOUT", "60")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for key in ("TPUSERVE_COORDINATOR", "TPUSERVE_NUM_PROCESSES", "TPUSERVE_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    yield
    assert engine_mod._MH_LIVE_ENGINE is None


def _config(name, sharding=None, kv="int8", **gen):
    """SMALL with 4 kv heads: a tp rank's packed int4 rows are 128 bytes, the
    flat core's width."""
    generation = dict(max_seq_len=64, max_slots=4, eos_token_id=-1, max_new_tokens=6,
                      prefill_chunk=16)
    generation.update(gen)
    return {"name": name, "platform": "llm", "architecture": "llama",
            "model_params": dict(SMALL, n_kv_heads=4),
            "quantization": {"weights": "int4", "group_size": 128, "kv_cache": kv},
            "generation": generation, "sharding": sharding or {}}


def _generate(engine, prompts=PROMPTS, max_new=6):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    out = []
    for r in reqs:
        assert r.done.wait(timeout=DEADLINE), "a request did not finish"
        assert r.error is None, r.error
        out.append(list(r.output_ids))
    return out


def _one_rank_tokens(vdir, cfg, cut=None):
    """The one-rank engine's greedy tokens; with `cut` (tp, dp, sp) also the
    block_fingerprint of each rank's cut of its whole weights."""
    from tpuserve_torch.parallel.mesh import Mesh
    from tpuserve_torch.parallel.sharding import block_fingerprint, shard_llama_params

    eng = GenerationEngine(vdir, ModelConfig.from_dict(dict(cfg, sharding={})), device="cpu")
    eng.start()
    try:
        tokens = _generate(eng)
        if cut is None:
            return tokens
        return tokens, [block_fingerprint(shard_llama_params(eng.params, Mesh(*cut, r)))
                        for r in range(cut[0] * cut[1] * cut[2])]
    finally:
        eng.stop()


@pytest.mark.parametrize("sharding,kv", [({"tensor_parallel": 2}, "int4"),
                                         ({"data_parallel": 2, "sequence_parallel": 2}, "int8")])
def test_engine_ranks_match_one_rank(tmp_path, sharding, kv):
    """The engine starts world - 1 follower ranks on this host (gloo on the
    CPU), every rank cuts each parameter of the checkpoint to its block as
    it loads (the blocks' checksums equal those of the one-rank engine's
    weights cut whole), and the controller's greedy tokens equal the
    one-rank engine's: a 40-token prompt admitted in chunks of 16 spans both
    sp windows of 32. Then every rank profiles the same decode dispatch."""
    cfg = _config("m", sharding, kv=kv)
    vdir = write_model(str(tmp_path), "m", cfg)
    cut = tuple(sharding.get(k, 1) for k in ("tensor_parallel", "data_parallel",
                                              "sequence_parallel"))
    ref, prints = _one_rank_tokens(vdir, cfg, cut)
    eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
    eng.start()
    try:
        assert len(eng._followers) == eng.mesh.size - 1
        before = eng.rank_stats()   # rank 0's counts are this process's, earlier tests' too
        assert _generate(eng) == ref
        stats = eng.serving_stats()
        assert stats["mesh"]["backend"] == "gloo"
        assert [r["rank"] for r in stats["ranks"]] == list(range(eng.mesh.size))
        assert [r["plain_row_shards"] for r in stats["ranks"]] == \
            [r["plain_row_shards"] for r in before]
        assert [r["param_fingerprint"] for r in stats["ranks"]] == prints
        assert all(r["decode_profile"] is None for r in stats["ranks"])
        eng.profile_next_decode()
        _generate(eng, PROMPTS[:1], max_new=3)
        profiles = [r["decode_profile"] for r in eng.rank_stats()]
        assert all(pr is not None and pr["host_ms"] > 0 for pr in profiles), profiles
    finally:
        eng.stop()
    assert eng._followers == [] and not torch.distributed.is_initialized()


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=DEADLINE) as resp:
        return json.loads(resp.read())


def test_cli_processes_answer_rest(tmp_path):
    """Two CLI processes, process 0 serving REST and process 1 its follower,
    load a tensor_parallel 2 model over REST and generate the one-rank
    engine's greedy tokens; SIGINT to process 0 ends both."""
    from tpuserve_torch.parallel.distributed import free_port

    cfg = _config("m", {"tensor_parallel": 2}, kv="int4")
    vdir = write_model(str(tmp_path), "m", cfg)
    ref = _one_rank_tokens(vdir, cfg)
    repo, port, rest = str(tmp_path), free_port(), free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUSERVE_")}
    env.update(PYTHONPATH=REPO, TPUSERVE_COORDINATOR=f"127.0.0.1:{port}",
               TPUSERVE_NUM_PROCESSES="2", TPUSERVE_DIST_TIMEOUT="60", OMP_NUM_THREADS="1")
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpuserve_torch.server", "--platform", "cpu", "--repository",
         repo, "--host", "127.0.0.1", "--port", str(rest)], cwd=REPO,
        env=dict(env, TPUSERVE_PROCESS_ID=str(r)), stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        url = f"http://127.0.0.1:{rest}"
        deadline = time.monotonic() + DEADLINE
        while True:
            try:
                _http("GET", url + "/health")
                break
            except OSError:
                assert time.monotonic() < deadline, "the controller never answered"
                assert all(p.poll() is None for p in procs)
                time.sleep(0.2)
        assert _http("POST", url + "/models/m/load")["message"] == "Model loaded successfully"
        got = [_http("POST", url + "/models/m/generate",
                     {"input_ids": p, "max_new_tokens": 6})["generated_ids"] for p in PROMPTS]
        assert got == ref
        procs[0].send_signal(signal.SIGINT)
        assert [p.wait(timeout=DEADLINE) for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    assert "follower 1/2 up (gloo)" in (tmp_path / "rank1.log").read_text()


GENERATOR_RANK = """\
import json, sys
import torch
torch.set_num_threads(1)
from tpuserve_torch.models.llama import LlamaParams
from tpuserve_torch.parallel import distributed
from tpuserve_torch.parallel.dispatcher import MultiHostGenerator, is_controller
distributed.initialize(device_type="cpu")
p = LlamaParams(**json.loads(sys.argv[1]))
gen = MultiHostGenerator(p, n_slots=4, max_len=64, tp=2, seed=3)
out = gen.generate([5, 17, 100, 42, 7], 8) if is_controller() else gen.follow(8)
print(json.dumps(out))
distributed.shutdown()
"""


def _generator_ranks(dims):
    """Two gloo ranks joined by the TPUSERVE_* variables run
    dispatcher.MultiHostGenerator at tensor_parallel 2; each rank's greedy
    tokens, and the same seeded model's on one rank."""
    from tpuserve_torch.models import llama as tllama
    from tpuserve_torch.parallel.distributed import free_port

    env = dict(os.environ, PYTHONPATH=REPO, TPUSERVE_COORDINATOR=f"127.0.0.1:{free_port()}",
               TPUSERVE_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, "-c", GENERATOR_RANK, json.dumps(dims)],
                              env=dict(env, TPUSERVE_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=DEADLINE) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    got = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    p = tllama.LlamaParams(**dims)
    params = tllama.init_params(p, dtype=torch.float32, device="cpu", seed=3)
    cache = tllama.KVCache.create(p, 4, 64, quantized=False, dtype=torch.float32, device="cpu")
    tokens = torch.zeros((1, 16), dtype=torch.long)
    tokens[0, :5] = torch.tensor([5, 17, 100, 42, 7])
    ref = [int(tllama.prefill(params, p, tokens, cache, 0, 5)[0][0].argmax())]
    for i in range(7):
        t = torch.zeros((4,), dtype=torch.long)
        pos = torch.full((4,), -1, dtype=torch.int32)
        t[0], pos[0] = ref[-1], 5 + i
        ref.append(int(tllama.decode_step(params, p, t, cache, pos)[0][0].argmax()))
    return got, ref


def test_multihost_generator_ranks_agree(tmp_path):
    """The sharded model without the scheduler
    (dispatcher.MultiHostGenerator): two gloo ranks at tensor_parallel 2,
    the prompt broadcast from rank 0, both return the greedy tokens of the
    same seeded model run on one rank."""
    got, ref = _generator_ranks(dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                                     n_kv_heads=2, head_dim=16, ffn_dim=128))
    assert got == [ref, ref]


def test_multihost_generator_ranks_agree_over_one_kv_head(tmp_path):
    """The same over one kv head: tensor_parallel 2 does not divide it, so
    both ranks joined by the variables keep every kv head (the JAX
    package's GSPMD-only mesh) and attend with the query heads of their wo
    rows."""
    got, ref = _generator_ranks(dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                                     n_kv_heads=1, head_dim=16, ffn_dim=128))
    assert got == [ref, ref]


REFUSALS = {
    "paged": ({"tensor_parallel": 2}, {"paged": True, "page_size": 16, "prefill_chunk": 0},
              "paged kv_cache int4 is single-chip"),
    "pipeline": ({"pipeline_parallel": 2}, {"prefill_chunk": 0},
                 "kv_cache int4 does not compose with pipeline_parallel"),
    "gspmd_only": ({"tensor_parallel": 8}, {}, "kv_cache int4 under tp needs tp \\| n_kv_heads"),
    "gspmd_pipeline": ({"tensor_parallel": 8, "pipeline_parallel": 2}, {"prefill_chunk": 0},
                       "n_heads/n_kv_heads/ffn_dim must divide by tensor_parallel 8 under "
                       "pipeline_parallel"),
    "slots": ({"data_parallel": 3}, {}, "max_slots 4 must divide by data_parallel 3"),
    "int4_sp": ({"sequence_parallel": 2}, {}, "kv_cache int4 does not compose"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_left_out_configs_refused(tmp_path, case):
    """What the JAX engine refuses (a paged int4 pool under a mesh; int4
    KV under the pipeline's 5D stage caches; int4 KV, and the pipeline, at
    a tp that does not divide n_kv_heads, whose other configurations the
    port serves as the JAX package does) raises a BackendError with its
    words, before any rank is started."""
    sharding, gen, msg = REFUSALS[case]
    cfg = _config("r", sharding, kv="int4", **gen)
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match=msg):
        eng.start()
    assert eng._followers == [] and not torch.distributed.is_initialized()


CLI_REFUSALS = {
    "cli_pipeline": ({"pipeline_parallel": 2}, {"prefill_chunk": 0},
                     "multi-host serving v1 does not compose with pipeline_parallel"),
    "cli_paged": ({"tensor_parallel": 2}, {"paged": True, "page_size": 16, "prefill_chunk": 0},
                  "page-table bookkeeping is controller-local"),
    "cli_paged_dp": ({"data_parallel": 2}, {"paged": True, "page_size": 16, "prefill_chunk": 0},
                     "multi-host serving v1 does not compose with paged KV"),
    "cli_speculation": ({"data_parallel": 2}, {"speculation_tokens": 4},
                        "multi-host serving v1 does not compose with speculative decoding"),
}


@pytest.mark.parametrize("case", list(CLI_REFUSALS))
def test_cli_form_refuses_pipeline_and_paged(tmp_path, monkeypatch, case):
    """Ranks joined by the TPUSERVE_* variables (the CLI's multi-process
    form, the JAX package's multi-host) keep the JAX multi-host v1
    refusals of pipeline_parallel, of paged KV and of speculative
    decoding, before joining; the same configurations are served by ranks
    an engine starts itself."""
    sharding, gen, msg = CLI_REFUSALS[case]
    monkeypatch.setenv("TPUSERVE_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TPUSERVE_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUSERVE_PROCESS_ID", "0")
    cfg = _config("c", sharding, kv="int8", **gen)
    eng = GenerationEngine(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu")
    with pytest.raises(BackendError, match=msg):
        eng.start()
    assert eng._followers == [] and not torch.distributed.is_initialized()
    monkeypatch.setenv("TPUSERVE_ENGINE_RANK", "1")   # a rank an engine started
    eng._check_supported()


def test_failed_sharded_start_leaves_no_live_mark(tmp_path, monkeypatch):
    """A sharded start that fails after taking the one-model mark gives it
    back, so the next sharded load is not refused as a second model; while
    one is live, a second is refused (the engine's mark and the manager's
    rule)."""
    from tpuserve_torch.parallel import distributed

    def no_ranks(world, device_type, log_dir=None):
        raise BackendError("follower rank 1 exited with code 1 before joining")

    monkeypatch.setattr(distributed, "launch_local_ranks", no_ranks)
    cfg = ModelConfig.from_dict(_config("a", {"tensor_parallel": 2}, kv="int4"))
    for _ in range(2):
        eng = GenerationEngine(str(tmp_path), cfg, device="cpu")
        with pytest.raises(BackendError, match="exited with code 1"):
            eng.start()
        assert engine_mod._MH_LIVE_ENGINE is None
    engine_mod._MH_LIVE_ENGINE = object()
    try:
        with pytest.raises(BackendError, match="ONE model at a time"):
            GenerationEngine(str(tmp_path), cfg, device="cpu").start()
    finally:
        engine_mod._MH_LIVE_ENGINE = None
    write_model(str(tmp_path), "solo", _config("solo"))
    write_model(str(tmp_path), "wide", _config("wide", {"tensor_parallel": 2}, kv="int4"))
    manager = InferenceManager(str(tmp_path), device="cpu")
    try:
        manager.load_model("solo")
        with pytest.raises(TpuServeError, match="a sharded model is served alone"):
            manager.load_model("wide")
    finally:
        manager.shutdown()
