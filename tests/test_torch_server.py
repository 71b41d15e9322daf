"""The port's REST front (tpuserve_torch.server) on the CPU.

Every route the JAX front's tests cover, less those that need the model zoo,
served over a small int4 Llama (torch_parity.SMALL: int4 g128 weights,
packed int4 KV) with device="cpu"; the same request list sent to the JAX
front (its kernels in Pallas interpret mode) and to the port's, with equal
status codes, equal JSON key sets and equal greedy tokens and streams; and
the CLI, `python -m tpuserve_torch.server`, in subprocesses: on the CPU, on
the card by default (where a load fails here and nothing runs on the CPU),
and refusing an incomplete multi-process setting.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import aiohttp
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tpuserve.models import llama as jllama
from tpuserve.quant import core as jcore
from tpuserve.server.http import create_app as jax_create_app
from tpuserve_torch.quant.core import QTensor
from tpuserve_torch.server import __main__ as cli
from tpuserve_torch.server.http import _MANAGER_KEY, create_app
from torch_parity import serve_config, write_model, write_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 60  # seconds: every server, client call and subprocess below
PROMPT = [5, 17, 100, 42, 7]


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """`llm` ships a tokenizer.json, `llm_plain` (the same weights) none."""
    root = str(tmp_path_factory.mktemp("front_repo"))
    write_tokenizer(write_model(root, "llm", serve_config("llm")))
    write_model(root, "llm_plain", serve_config("llm_plain"))
    return root


async def _client(app):
    client = TestClient(TestServer(app), timeout=aiohttp.ClientTimeout(total=DEADLINE))
    await client.start_server()
    return client


def serve(repo, body):
    """Run `body(client, app)` against the port's app over `repo` (CPU)."""
    async def go():
        app = create_app(repo, device="cpu")
        client = await _client(app)
        try:
            await asyncio.wait_for(body(client, app), DEADLINE)
        finally:
            await client.close()

    asyncio.run(go())


async def _ndjson(resp):
    return [json.loads(line) for line in (await resp.text()).splitlines() if line]


# ------------------------------------------------------------------ routes
def test_health_home_and_device_routes(repo):
    """No card here: the device routes describe none, and no TPU backs the
    port."""
    async def body(c, app):
        r = await c.get("/health")
        data = await r.json()
        assert r.status == 200 and data["status"] == "healthy"
        assert isinstance(data["time"], int)
        r = await c.get("/")
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
        for path in ("/cuda", "/tpu"):
            r = await c.get(path)
            assert r.status == 200
            assert await r.json() == {"cuda_available": False, "tpu_available": False,
                                      "device_count": 0, "platform": "cpu"}
        r = await c.get("/devices")
        assert await r.json() == {"devices": [], "device_details": []}
        for path in ("/gpu/memory", "/tpu/memory"):
            r = await c.get(path)
            assert r.status == 200 and await r.json() == {"memory_info": []}

    serve(repo, body)


def test_list_and_status(repo):
    async def body(c, app):
        r = await c.get("/models")
        data = await r.json()
        assert r.status == 200 and data["model_count"] == 2
        assert {m["name"]: (m["is_loaded"], m["state"]) for m in data["models"]} == {
            "llm": (False, "UNLOADED"), "llm_plain": (False, "UNLOADED")}
        r = await c.get("/models/llm")
        data = await r.json()
        assert r.status == 200 and data["version"] == "1" and data["is_loaded"] is False
        assert data["available_versions"] == ["1"]
        assert data["config"]["inputs"][0]["name"] == "input_ids"
        assert "stats" not in data
        r = await c.get("/models/ghost")
        assert r.status == 404 and "error" in await r.json()

    serve(repo, body)


def test_lifecycle_codes_and_error_paths(repo):
    """The reference's codes: 202 on load, 200 when already loaded, 201 on
    unload, 200 when not loaded, 400 for a model not loaded, 404 for an
    unknown one; bad JSON, empty or missing ids and bad inputs are 400."""
    async def body(c, app):
        assert (await c.post("/models/ghost/load")).status == 404
        for path in ("/models/llm/generate", "/models/llm/infer"):
            r = await c.post(path, json={"input_ids": PROMPT})
            assert r.status == 400 and "not loaded" in (await r.json())["error"]
        assert (await c.get("/models/llm/stats")).status == 400
        r = await c.post("/models/llm/load")
        assert r.status == 202 and (await r.json())["message"] == "Model loaded successfully"
        r = await c.post("/models/llm/load")
        assert r.status == 200 and "already loaded" in (await r.json())["message"].lower()
        r = await c.get("/models/llm")
        data = await r.json()
        assert data["is_loaded"] is True and data["state"] == "LOADED"
        assert data["stats"]["memory_usage_bytes"] > 0
        for path in ("/models/llm/generate", "/models/llm/infer"):
            r = await c.post(path, data=b"not json")
            assert r.status == 400 and (await r.json())["error"] == "invalid JSON body"
        for bad in ({"input_ids": []}, {"input_ids": 5}, {"max_new_tokens": 3}):
            r = await c.post("/models/llm/generate", json=bad)
            assert r.status == 400 and "input_ids" in (await r.json())["error"]
        r = await c.post("/models/llm/infer", json={})
        assert r.status == 400 and "inputs" in (await r.json())["error"]
        r = await c.post("/models/llm/infer", json={"inputs": [{"name": "input_ids"}]})
        assert r.status == 400
        r = await c.post("/models/llm/generate", json={"input_ids": list(range(64))})
        assert r.status == 400 and "max_seq_len" in (await r.json())["error"]
        r = await c.post("/models/llm/unload")
        assert r.status == 201 and (await r.json())["message"] == "Model unloaded successfully"
        r = await c.post("/models/llm/unload")
        assert r.status == 200 and "not loaded" in (await r.json())["message"].lower()
        assert (await c.post("/models/llm/generate", json={"input_ids": PROMPT})).status == 400

    serve(repo, body)


def test_generate_unary_streamed_and_text(repo):
    """Unary greedy tokens equal backend.generate's; a stream (body flag or
    ?stream=1) carries the same tokens and ends with a done chunk; a text
    request tokenizes with the model's tokenizer.json; stop ids, logprobs
    and sampling pass through."""
    async def body(c, app):
        assert (await c.post("/models/llm/load")).status == 202
        backend = app[_MANAGER_KEY].get_model("llm").backend
        want = await asyncio.to_thread(backend.generate, PROMPT, max_new_tokens=5)
        r = await c.post("/models/llm/generate", json={"input_ids": PROMPT, "max_new_tokens": 5})
        data = await r.json()
        assert r.status == 200 and data["model_name"] == "llm"
        assert data["generated_ids"] == want["generated_ids"] and data["num_generated"] == 5
        assert data["output_ids"] == PROMPT + want["generated_ids"]

        for kw in (dict(json={"input_ids": PROMPT, "max_new_tokens": 5, "stream": True}),
                   dict(json={"input_ids": PROMPT, "max_new_tokens": 5},
                        params={"stream": "1"})):
            r = await c.post("/models/llm/generate", **kw)
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("application/x-ndjson")
            chunks = await _ndjson(r)
            assert [ch["token"] for ch in chunks[:-1]] == want["generated_ids"]
            assert chunks[-1] == {"done": True, "finish_reason": "max_new_tokens",
                                  "num_generated": 5}

        stop = want["generated_ids"][2]
        n_stop = want["generated_ids"].index(stop) + 1
        r = await c.post("/models/llm/generate", json={
            "input_ids": PROMPT, "max_new_tokens": 5, "stop_token_ids": [stop],
            "logprobs": True, "stream": True})
        chunks = await _ndjson(r)
        assert chunks[-1]["finish_reason"] == "stop" and chunks[-1]["num_generated"] == n_stop
        assert len(chunks[-1]["logprobs"]) == n_stop
        assert all(lp <= 0 for lp in chunks[-1]["logprobs"])

        r = await c.post("/models/llm/generate", json={
            "input_ids": PROMPT, "max_new_tokens": 4, "temperature": 0.8, "top_p": 0.9,
            "seed": 3})
        assert r.status == 200 and (await r.json())["num_generated"] == 4

        r = await c.post("/models/llm/generate", json={"text": "hello world tok7",
                                                        "max_new_tokens": 4})
        data = await r.json()
        assert r.status == 200, data
        assert data["output_ids"][:3] == [1, 2, 7] and isinstance(data["text"], str)
        r2 = await c.post("/models/llm/generate", json={"input_ids": [1, 2, 7],
                                                         "max_new_tokens": 4})
        assert (await r2.json())["generated_ids"] == data["generated_ids"]
        engine = backend.engine
        assert data["text"] == engine.tokenizer.decode(data["generated_ids"])

    serve(repo, body)


@pytest.fixture()
def one_torch_thread():
    """GPTQ's load issues thousands of small torch ops; with other test
    workers on the same cores, torch's intra-op thread pool spends them
    waiting for its threads (the load below ran 240x slower with six
    workers), so the test runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_repository_llm_demo_loads_and_generates(one_torch_thread):
    """The repository's own demo LLM (models/llm_demo: GPTQ with LoRC 16 on
    random weights from a seed, int4 weights and KV, speculation 4) loads
    from the real models/ directory over the port's front and generates;
    its greedy tokens equal backend.generate's."""
    async def body(c, app):
        r = await c.post("/models/llm_demo/load")
        assert r.status in (200, 202), await r.text()
        backend = app[_MANAGER_KEY].get_model("llm_demo").backend
        params = backend.engine.params
        assert isinstance(params["layers.0/wqkv/kernel"], QTensor)
        assert params["layers.0/wqkv/kernel@lorc_a"].shape[1] == 16
        r = await c.post("/models/llm_demo/generate",
                         json={"input_ids": PROMPT, "max_new_tokens": 6})
        data = await r.json()
        assert r.status == 200 and data["num_generated"] == 6, data
        want = await asyncio.to_thread(backend.generate, PROMPT, max_new_tokens=6)
        assert data["generated_ids"] == want["generated_ids"]
        assert (await c.post("/models/llm_demo/unload")).status == 201

    serve(os.path.join(REPO, "models"), body)


def test_text_without_tokenizer_rejected(repo):
    async def body(c, app):
        assert (await c.post("/models/llm_plain/load")).status == 202
        r = await c.post("/models/llm_plain/generate", json={"text": "hello"})
        assert r.status == 400 and "tokenizer" in (await r.json())["error"]
        assert app[_MANAGER_KEY].get_model("llm_plain").backend.engine.tokenizer is None

    serve(repo, body)


def test_infer_stats_and_metrics(repo):
    """/infer on the LLM reaches LLMBackend.infer (input_ids in, output_ids
    out, the config's max_new_tokens); /stats and /metrics count it, and
    /metrics carries the engine's serving_stats."""
    async def body(c, app):
        assert (await c.post("/models/llm/load")).status == 202
        r = await c.post("/models/llm/infer", json={"inputs": {"input_ids": PROMPT}})
        data = await r.json()
        assert r.status == 200, data
        assert data["model_name"] == "llm" and data["model_version"] == "1"
        out = data["outputs"][0]
        assert out["name"] == "output_ids" and out["data_type"] == "INT32"
        assert out["shape"] == [1, len(PROMPT) + 5] and out["data"][:len(PROMPT)] == PROMPT
        r = await c.post("/models/llm/generate", json={"input_ids": PROMPT})
        assert (await r.json())["output_ids"] == out["data"]
        r = await c.post("/models/llm/infer", json={"inputs": [
            {"name": "input_ids", "shape": [1, 5], "data_type": "INT32", "data": PROMPT}]})
        assert (await r.json())["outputs"][0]["data"] == out["data"]

        r = await c.get("/models/llm/stats")
        data = await r.json()
        assert r.status == 200 and data["version"] == "1"
        assert data["stats"]["inference_count"] >= 3
        r = await c.get("/metrics")
        data = await r.json()
        assert data["platform"] == "cpu" and data["device_count"] == 0 and data["memory"] == []
        serving = data["models"]["llm:1"]["serving"]
        assert serving["tokens_generated"] >= 15 and serving["max_slots"] == 4
        assert serving["paged"] is False and serving["decode_steps"] >= 1

    serve(repo, body)


def test_profile_capture(repo, tmp_path):
    """/profile/start and /profile/stop around a served request: a
    torch.profiler Chrome trace (CPU activity here) in the trace dir."""
    async def body(c, app):
        assert (await c.post("/models/llm/load")).status == 202
        r = await c.get("/profile")
        assert r.status == 200 and await r.json() == {"active": False, "trace_dir": None}
        trace_dir = str(tmp_path / "trace")
        r = await c.post("/profile/start", json={"dir": trace_dir})
        assert r.status == 200
        assert await r.json() == {"status": "started", "trace_dir": trace_dir}
        assert (await c.post("/profile/start", json={})).status == 409
        assert (await (await c.get("/profile")).json())["active"] is True
        r = await c.post("/models/llm/generate", json={"input_ids": PROMPT})
        assert r.status == 200
        r = await c.post("/profile/stop")
        data = await r.json()
        assert r.status == 200 and data["status"] == "stopped"
        assert [f["path"] for f in data["files"]] == ["trace.json"]
        assert data["total_bytes"] == os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
        with open(os.path.join(trace_dir, "trace.json")) as fh:
            assert "traceEvents" in json.load(fh)
        assert (await c.post("/profile/stop")).status == 400

    serve(repo, body)


def test_auth_token(repo, monkeypatch):
    """TPUSERVE_AUTH_TOKEN guards every route but / and /health."""
    monkeypatch.setenv("TPUSERVE_AUTH_TOKEN", "s3cret")

    async def body(c, app):
        assert (await c.get("/health")).status == 200
        assert (await c.get("/")).status == 200
        r = await c.get("/models")
        assert r.status == 401 and "token" in (await r.json())["error"]
        assert (await c.get("/models", headers={"Authorization": "Bearer nope"})).status == 401
        assert (await c.get("/models", headers={"Authorization": "Bearer s3cret"})).status == 200
        assert (await c.post("/models/llm/load")).status == 401

    serve(repo, body)


# ------------------------------------------------- parity with the JAX front
# (name, method, path, JSON body, raw body); "{trace}" is each front's own
# trace dir. Greedy requests compare their tokens, streams their NDJSON.
REQUESTS = [
    ("health", "GET", "/health", None, None),
    ("home", "GET", "/", None, None),
    ("cuda", "GET", "/cuda", None, None),
    ("tpu", "GET", "/tpu", None, None),
    ("devices", "GET", "/devices", None, None),
    ("gpu_memory", "GET", "/gpu/memory", None, None),
    ("tpu_memory", "GET", "/tpu/memory", None, None),
    ("models", "GET", "/models", None, None),
    ("status_unloaded", "GET", "/models/llm", None, None),
    ("status_unknown", "GET", "/models/ghost", None, None),
    ("load_unknown", "POST", "/models/ghost/load", None, None),
    ("generate_not_loaded", "POST", "/models/llm/generate", {"input_ids": PROMPT}, None),
    ("infer_not_loaded", "POST", "/models/llm/infer", {"inputs": {"input_ids": PROMPT}}, None),
    ("stats_not_loaded", "GET", "/models/llm/stats", None, None),
    ("load", "POST", "/models/llm/load", None, None),
    ("load_again", "POST", "/models/llm/load", None, None),
    ("status_loaded", "GET", "/models/llm", None, None),
    ("generate_greedy", "POST", "/models/llm/generate",
     {"input_ids": PROMPT, "max_new_tokens": 5}, None),
    ("generate_greedy_other", "POST", "/models/llm/generate",
     {"input_ids": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], "max_new_tokens": 6}, None),
    ("generate_stop_logprobs", "POST", "/models/llm/generate",
     {"input_ids": [511, 0, 256], "max_new_tokens": 5, "logprobs": True,
      "stop_token_ids": [100]}, None),
    ("generate_sampled", "POST", "/models/llm/generate",
     {"input_ids": PROMPT, "max_new_tokens": 4, "temperature": 0.8, "top_k": 20}, None),
    ("generate_stream", "POST", "/models/llm/generate",
     {"input_ids": PROMPT, "max_new_tokens": 5, "stream": True}, None),
    ("generate_stream_logprobs", "POST", "/models/llm/generate",
     {"input_ids": [9, 8, 7], "max_new_tokens": 4, "stream": True, "logprobs": True}, None),
    ("generate_stream_query", "POST", "/models/llm/generate?stream=1",
     {"input_ids": [9, 8, 7], "max_new_tokens": 4}, None),
    ("generate_text", "POST", "/models/llm/generate",
     {"text": "hello world tok7 tok300", "max_new_tokens": 4}, None),
    ("generate_bad_json", "POST", "/models/llm/generate", None, b"not json"),
    ("generate_empty_ids", "POST", "/models/llm/generate", {"input_ids": []}, None),
    ("generate_no_ids", "POST", "/models/llm/generate", {"max_new_tokens": 2}, None),
    ("infer", "POST", "/models/llm/infer", {"inputs": {"input_ids": PROMPT}}, None),
    ("infer_list_form", "POST", "/models/llm/infer", {"inputs": [
        {"name": "input_ids", "shape": [1, 3], "data_type": "INT32", "data": [9, 8, 7]}]}, None),
    ("infer_bad_json", "POST", "/models/llm/infer", None, b"not json"),
    ("infer_no_inputs", "POST", "/models/llm/infer", {}, None),
    ("stats", "GET", "/models/llm/stats", None, None),
    ("metrics", "GET", "/metrics", None, None),
    ("profile_status", "GET", "/profile", None, None),
    ("profile_start", "POST", "/profile/start", {"dir": "{trace}"}, None),
    ("profile_start_again", "POST", "/profile/start", {}, None),
    ("profile_stop", "POST", "/profile/stop", None, None),
    ("profile_stop_again", "POST", "/profile/stop", None, None),
    ("unload", "POST", "/models/llm/unload", None, None),
    ("unload_again", "POST", "/models/llm/unload", None, None),
    ("generate_unloaded", "POST", "/models/llm/generate", {"input_ids": PROMPT}, None),
]
# greedy requests whose tokens must be equal (the rest: codes and keys)
_TOKENS = {"generate_greedy": "generated_ids", "generate_greedy_other": "generated_ids",
           "generate_stop_logprobs": "generated_ids", "generate_text": "output_ids",
           "infer": "outputs", "infer_list_form": "outputs"}


async def _send_all(app, trace_dir):
    client = await _client(app)
    out = {}
    try:
        for name, method, path, body, raw in REQUESTS:
            if isinstance(body, dict) and body.get("dir") == "{trace}":
                body = {"dir": trace_dir}
            kw = {"data": raw} if raw is not None else ({"json": body} if body is not None else {})
            r = await asyncio.wait_for(client.request(method, path, **kw), DEADLINE)
            ctype = r.headers.get("Content-Type", "")
            if "ndjson" in ctype:
                payload = await _ndjson(r)
            elif "json" in ctype:
                payload = await r.json()
            else:
                payload = await r.text()
            out[name] = (r.status, ctype.split(";")[0], payload)
    finally:
        await client.close()
    return out


@pytest.fixture(scope="module")
def parity(repo, tmp_path_factory):
    """The request list through the JAX front (a JAX InferenceManager, its
    kernels in Pallas interpret mode) and through the port's (device="cpu"),
    one after the other on the same repository."""
    traces = tmp_path_factory.mktemp("traces")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
        mp.setattr(jllama, "qmatmul",
                   lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
        jax_out = asyncio.run(_send_all(jax_create_app(repo), str(traces / "jax")))
    port_out = asyncio.run(_send_all(create_app(repo, device="cpu"), str(traces / "port")))
    return jax_out, port_out


@pytest.mark.parametrize("name", [r[0] for r in REQUESTS])
def test_rest_parity_with_jax_front(parity, name):
    """Equal status codes, content types and JSON key sets; equal greedy
    tokens and NDJSON streams. /cuda, /tpu and /devices describe different
    devices, so only their keys are compared."""
    (j_status, j_type, j_body), (t_status, t_type, t_body) = (parity[0][name], parity[1][name])
    assert (t_status, t_type) == (j_status, j_type), (t_body, j_body)
    if isinstance(j_body, dict):
        assert set(t_body) == set(j_body)
    if name in _TOKENS:
        assert t_status == 200
        key = _TOKENS[name]
        if key == "outputs":
            assert [o["data"] for o in t_body[key]] == [o["data"] for o in j_body[key]]
        else:
            assert t_body[key] == j_body[key]
        if name == "generate_text":
            assert t_body["text"] == j_body["text"]
    if j_type == "application/x-ndjson":
        assert [ch.get("token") for ch in t_body] == [ch.get("token") for ch in j_body]
        assert [set(ch) for ch in t_body] == [set(ch) for ch in j_body]
        assert t_body[-1]["done"] is True
    if name in ("models", "status_loaded", "metrics"):
        inner = {"models": lambda b: [sorted(m) for m in b["models"]],
                 "status_loaded": lambda b: sorted(b["stats"]),
                 "metrics": lambda b: sorted(b["models"])}[name]
        assert inner(t_body) == inner(j_body)


# ------------------------------------------------------------------- CLI
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=DEADLINE) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUSERVE_")}
    env.update(PYTHONPATH=REPO, **extra)
    return env


class _Cli:
    """`python -m tpuserve_torch.server ARGS` on a free port, killed by its
    PID in `close` if it is still up."""

    def __init__(self, tmp_path, *args, env=None):
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log = open(tmp_path / f"server_{self.port}.log", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tpuserve_torch.server", "--host", "127.0.0.1",
             "--port", str(self.port), *args],
            cwd=REPO, env=env or _env(), stdout=self.log, stderr=subprocess.STDOUT)

    def wait_healthy(self):
        deadline = time.monotonic() + DEADLINE
        while time.monotonic() < deadline:
            assert self.proc.poll() is None, self.output()
            try:
                if _http("GET", self.url + "/health")[0] == 200:
                    return
            except OSError:
                time.sleep(0.2)
        raise AssertionError("server did not answer /health: " + self.output())

    def interrupt(self):
        """SIGINT; the exit code within the deadline."""
        self.proc.send_signal(signal.SIGINT)
        return self.proc.wait(timeout=30)

    def output(self):
        self.log.seek(0)
        return self.log.read()[-4000:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=DEADLINE)
        self.log.close()


def test_cli_cpu_serves_rest_and_grpc_then_stops_on_sigint(repo, tmp_path):
    """--platform cpu: /health, load, greedy tokens equal to the in-process
    front's, the soak (LLM infer and generate) with no error, gRPC on the
    same manager, and a clean exit on SIGINT."""
    from tpuserve_torch.server import tpuserve_pb2 as pb
    from tpuserve_torch.server.grpc import GrpcClient

    grpc_port = _free_port()
    srv = _Cli(tmp_path, "--platform", "cpu", "--repository", repo,
               "--grpc-port", str(grpc_port))
    client = None
    try:
        srv.wait_healthy()
        assert _http("POST", srv.url + "/models/llm/load") == (
            202, {"message": "Model loaded successfully", "name": "llm", "version": "1"})
        status, data = _http("POST", srv.url + "/models/llm/generate",
                             {"input_ids": PROMPT, "max_new_tokens": 5})
        assert status == 200 and data["num_generated"] == 5

        async def body(c, app):
            await c.post("/models/llm/load")
            r = await c.post("/models/llm/generate", json={"input_ids": PROMPT,
                                                            "max_new_tokens": 5})
            assert (await r.json())["generated_ids"] == data["generated_ids"]

        serve(repo, body)

        soak = subprocess.run(
            [sys.executable, "-m", "tpuserve_torch.scripts.soak", "--url", srv.url,
             "--infer-model", "llm", "--llm-model", "llm", "--threads", "4", "--requests", "3"],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=DEADLINE)
        assert soak.returncode == 0, soak.stdout + soak.stderr
        assert "12 ok" in soak.stdout and "0 errors" in soak.stdout

        client = GrpcClient(f"127.0.0.1:{grpc_port}")
        listed = client.list_models(pb.ListModelsRequest(), timeout=DEADLINE)
        assert {m.name: m.is_loaded for m in listed.models} == {"llm": True, "llm_plain": False}
        resp = client.generate(pb.GenerateRequest(name="llm", input_ids=PROMPT,
                                                  max_new_tokens=5), timeout=DEADLINE)
        assert list(resp.generated_ids) == data["generated_ids"]
        client.close()
        client = None
        assert srv.interrupt() == 0, srv.output()
    finally:
        if client is not None:
            client.close()
        srv.close()


def test_cli_default_platform_never_serves_on_cpu(repo, tmp_path):
    """No --platform: the card. Without one the server answers, and a load
    fails with the engine's no-card error; nothing is served on the CPU."""
    srv = _Cli(tmp_path, "--repository", repo)
    try:
        srv.wait_healthy()
        status, data = _http("GET", srv.url + "/cuda")
        assert status == 200 and data["cuda_available"] is False
        status, data = _http("POST", srv.url + "/models/llm/load")
        assert status == 500 and "device='cpu'" in data["error"], data
        status, data = _http("GET", srv.url + "/models/llm")
        assert data["state"] == "ERROR" and "device='cpu'" in data["error"]
        status, data = _http("POST", srv.url + "/models/llm/generate", {"input_ids": PROMPT})
        assert status == 400 and "not loaded" in data["error"]
        assert srv.interrupt() == 0, srv.output()
    finally:
        srv.close()


def test_cli_refuses_multihost(repo):
    """A coordinator without the process count and id is refused at start
    (the multi-process form itself is tests/test_torch_multihost.py's)."""
    res = subprocess.run(
        [sys.executable, "-m", "tpuserve_torch.server", "--platform", "cpu", "--repository",
         repo], cwd=REPO, env=_env(TPUSERVE_COORDINATOR="127.0.0.1:1"),
        capture_output=True, text=True, timeout=DEADLINE)
    assert res.returncode != 0
    assert "multi-process serving: TPUSERVE_COORDINATOR, TPUSERVE_NUM_PROCESSES and " \
        "TPUSERVE_PROCESS_ID must all be set" in res.stderr


@pytest.mark.parametrize("value,device", [
    ("", "cuda"), ("gpu", "cuda"), ("cuda", "cuda"), ("GPU", "cuda"), ("cpu", "cpu"),
    ("tpu", None), ("cuda:1", None)])
def test_cli_platform_flag(monkeypatch, value, device):
    """--platform and TPUSERVE_PLATFORM name the device models load on:
    "", gpu or cuda the card, cpu the CPU; anything else is a usage error
    (exit 2) from the flag and from the variable alike."""
    monkeypatch.delenv("TPUSERVE_PLATFORM", raising=False)
    if device is None:
        with pytest.raises(SystemExit) as e:
            cli.main(["--platform", value])
        assert e.value.code == 2
        monkeypatch.setenv("TPUSERVE_PLATFORM", value)
        with pytest.raises(SystemExit) as e:
            cli.main([])
        assert e.value.code == 2
    else:
        assert cli._platform(value) == device
