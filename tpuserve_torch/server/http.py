"""REST frontend (PyTorch port of tpuserve/server/http.py).

Reference counterpart: the Go/Gin server (server/main.go) — 10 routes
(:903-917), JSON handling, version resolution, classification
post-processing, graceful shutdown. A single-process aiohttp app over the
InferenceManager; blocking engine work runs in a thread pool so the event
loop stays free.

Route surface (the JAX front's, route for route):
  GET  /                      home page
  GET  /health                health + unix time
  GET  /cuda                  accelerator availability (the card)
  GET  /tpu                   same keys; tpu_available is false here
  GET  /devices               device descriptions
  GET  /gpu/memory, /tpu/memory   per-card memory telemetry
  GET  /models                repository listing w/ states (live rescan)
  GET  /models/{name}         model status + config + available versions
  POST /models/{name}/load    load (202; already loaded -> 200, quirk §2c.2-3)
  POST /models/{name}/unload  unload (201 on success, reference quirk §2c.3)
  POST /models/{name}/infer   inference (+top-5 classifications w/ labels)
  GET  /models/{name}/stats   per-model stats (reference plumbed, never exposed — §5)
  POST /models/{name}/generate  LLM generation (token ids or text in, ids out)
  GET  /metrics               server-wide telemetry (cards, models, tokens/s)
  GET  /profile, POST /profile/start, /profile/stop   torch.profiler capture

The reference's unusual success codes (202 for load, 201 for unload,
server/main.go:296,359) are replicated deliberately for drop-in client
compatibility.

Streaming holds one thread of the loop's default executor per stream while
it waits for the stream's next token, as the JAX front does: at most
min(32, os.cpu_count() + 4) streams progress at once.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
import os
import queue as _queue
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

try:
    from aiohttp import web
except ImportError:  # pragma: no cover
    web = None

from tpuserve_torch import __version__
from tpuserve_torch import device as device_mod
from tpuserve_torch.engine.manager import InferenceManager, ModelState
from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import (
    InvalidArgumentError,
    ModelAlreadyLoadedError,
    ModelNotFoundError,
    ModelNotLoadedError,
    TpuServeError,
    ValidationError,
)
from tpuserve_torch.utils.tensor import Tensor

_MANAGER_KEY = web.AppKey("manager", InferenceManager) if web else None


def _json_error(status: int, message: str):
    return web.json_response({"error": message}, status=status)


def _error_status(e: Exception) -> int:
    if isinstance(e, TpuServeError):
        return e.status
    return 500


async def _in_thread(func, *args, **kw):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(func, *args, **kw))


# ---------------------------------------------------------------------- pages
_HOME_HTML = f"""<!DOCTYPE html>
<html><head><title>Quantized Inference Server</title></head>
<body style="font-family: sans-serif; max-width: 46rem; margin: 2rem auto;">
<h1>Quantized Inference Server v{__version__}</h1>
<p>PyTorch/CUDA serving engine. Endpoints:</p>
<ul>
<li><code>GET /health</code>, <code>GET /cuda</code>, <code>GET /devices</code>,
    <code>GET /gpu/memory</code>, <code>GET /metrics</code></li>
<li><code>GET /models</code>, <code>GET /models/{{name}}</code>,
    <code>GET /models/{{name}}/stats</code></li>
<li><code>POST /models/{{name}}/load|unload|infer|generate</code></li>
</ul>
<p>See <code>docs/api.md</code> for the full reference.</p>
</body></html>"""


async def handle_home(request):
    """≙ server/main.go:54-121 (markdown-rendered home page)."""
    return web.Response(text=_HOME_HTML, content_type="text/html")


async def handle_health(request):
    """≙ server/main.go:125-131."""
    return web.json_response({"status": "healthy", "time": int(time.time())})


async def handle_cuda(request):
    """Accelerator info (≙ /cuda, server/main.go:134-142): the CUDA card.
    No TPU backs this server, so tpu_available is false."""
    return web.json_response(
        {
            "cuda_available": device_mod.is_gpu_available(),
            "tpu_available": False,
            "device_count": device_mod.get_device_count(),
            "platform": device_mod.platform_name(),
        }
    )


async def handle_devices(request):
    """≙ server/main.go:145-158."""
    infos = await _in_thread(device_mod.all_device_infos)
    return web.json_response({"devices": [i.describe() for i in infos],
                              "device_details": [i.to_dict() for i in infos]})


async def handle_memory(request):
    """≙ server/main.go:161-187 (/gpu/memory)."""
    mems = await _in_thread(device_mod.all_memory_infos)
    return web.json_response({"memory_info": [m.to_dict() for m in mems]})


# ---------------------------------------------------------------------- models
async def handle_list_models(request):
    """≙ server/main.go:191-217."""
    manager = request.app[_MANAGER_KEY]
    entries = await _in_thread(manager.list_models)
    models = [
        {
            "name": e["name"],
            "version": e["version"],
            "is_loaded": e["state"] == ModelState.LOADED.value,
            "state": e["state"],
        }
        for e in entries
    ]
    return web.json_response(
        {
            "repository_path": manager.repository.path,
            "model_count": len({m["name"] for m in models}),
            "models": models,
        }
    )


async def handle_model_status(request):
    """≙ GetModelStatus (server/main.go:368-449)."""
    manager = request.app[_MANAGER_KEY]
    name = request.match_info["name"]
    version = request.query.get("version") or None
    try:
        versions = await _in_thread(manager.repository.get_versions, name)
    except ModelNotFoundError as e:
        return _json_error(404, str(e))
    try:
        resolved = await _in_thread(manager.repository.resolve_version, name, version)
        config = await _in_thread(manager.repository.get_config, name, resolved)
    except TpuServeError as e:
        return _json_error(_error_status(e), str(e))
    status = await _in_thread(manager.get_model_status, name, resolved)
    body = {
        "name": name,
        "version": resolved,
        "is_loaded": status["state"] == ModelState.LOADED.value,
        "state": status["state"],
        "repository_path": manager.repository.path + "/" + name,
        "available_versions": versions,
        "config": config.to_dict(),
    }
    if "stats" in status:
        body["stats"] = status["stats"]
    if "error" in status:
        body["error"] = status["error"]
    return web.json_response(body)


async def handle_load(request):
    """≙ LoadModel (server/main.go:220-302). Success = 202 Accepted; already
    loaded short-circuits to 200 (reference quirks §2c.2-3)."""
    manager = request.app[_MANAGER_KEY]
    name = request.match_info["name"]
    version = request.query.get("version") or None
    try:
        resolved = await _in_thread(manager.repository.resolve_version, name, version)
    except ModelNotFoundError as e:
        return _json_error(404, str(e))
    if manager.is_model_loaded(name, resolved):
        return web.json_response(
            {"message": "Model already loaded", "name": name, "version": resolved},
            status=200,
        )
    try:
        await _in_thread(manager.load_model, name, resolved)
    except ModelAlreadyLoadedError:
        return web.json_response(
            {"message": "Model already loaded", "name": name, "version": resolved},
            status=200,
        )
    except TpuServeError as e:
        return _json_error(_error_status(e), str(e))
    except Exception as e:
        return _json_error(500, f"Failed to load model: {e}")
    return web.json_response(
        {"message": "Model loaded successfully", "name": name, "version": resolved},
        status=202,
    )


async def handle_unload(request):
    """≙ UnloadModel (server/main.go:305-365). Success = 201 (quirk §2c.3)."""
    manager = request.app[_MANAGER_KEY]
    name = request.match_info["name"]
    version = request.query.get("version") or None
    try:
        await _in_thread(manager.unload_model, name, version)
    except ModelNotLoadedError:
        return web.json_response(
            {"message": "Model not loaded", "name": name}, status=200
        )
    except TpuServeError as e:
        return _json_error(_error_status(e), str(e))
    return web.json_response(
        {"message": "Model unloaded successfully", "name": name, "version": version or ""},
        status=201,
    )


# ---------------------------------------------------------------------- infer
def _parse_inputs(body: Dict, config) -> List[Tensor]:
    """JSON inputs -> Tensors.

    Accepts the reference format {"inputs": {"name": [flat or nested]}}
    (server/main.go:485-571): flat arrays are reshaped to the declared shape
    with element-count validation; a -1 batch dim is inferred from the data.
    Also accepts the richer form {"inputs": [{"name","shape","data_type","data"}]}.
    """
    raw = body.get("inputs")
    if raw is None:
        raise InvalidArgumentError("request body must contain 'inputs'")

    tensors: List[Tensor] = []
    if isinstance(raw, dict):
        for name, data in raw.items():
            decl = config.input_config(name)
            if decl is None:
                # pass through; Model.validate_inputs reports unknown names
                arr = np.asarray(data, dtype=np.float32)
                tensors.append(Tensor.from_numpy(name, arr))
                continue
            np_dt = decl.data_type.np_dtype or np.float32
            arr = np.asarray(data, dtype=np_dt)
            shape = list(decl.shape)
            if arr.ndim == 1 and len(shape) > 1:  # flat array: reshape to declared shape
                known = 1
                dynamic = [i for i, d in enumerate(shape) if d == -1]
                for d in shape:
                    if d != -1:
                        known *= d
                if len(dynamic) == 1:
                    if known == 0 or arr.size % known != 0:
                        raise InvalidArgumentError(
                            f"input '{name}': {arr.size} elements do not fit shape {shape}"
                        )
                    shape[dynamic[0]] = arr.size // known
                elif not dynamic:
                    if arr.size != known:
                        raise InvalidArgumentError(
                            f"input '{name}': expected {known} elements, got {arr.size}"
                        )
                else:
                    raise InvalidArgumentError(
                        f"input '{name}': flat data is ambiguous for shape {shape}; "
                        "send nested data or the list input form with an explicit shape"
                    )
                arr = arr.reshape(shape)
            tensors.append(Tensor(name=name, dtype=decl.data_type, shape=arr.shape, data=arr))
    elif isinstance(raw, list):
        for entry in raw:
            if not isinstance(entry, dict) or "name" not in entry or "data" not in entry:
                raise InvalidArgumentError("list-form inputs need 'name' and 'data'")
            dtype = DataType.from_string(entry.get("data_type", "FP32"))
            np_dt = dtype.np_dtype or np.float32
            arr = np.asarray(entry["data"], dtype=np_dt)
            if "shape" in entry:
                arr = arr.reshape([int(d) for d in entry["shape"]])
            tensors.append(Tensor(name=entry["name"], dtype=dtype, shape=arr.shape, data=arr))
    else:
        raise InvalidArgumentError("'inputs' must be an object or a list")
    return tensors


def _find_top_classes(probs: np.ndarray, labels: List[str], top_n: int = 5) -> List[Dict]:
    """≙ findTopClasses (server/main.go:744-786): argsort descending, no
    softmax, label attached when index is in range."""
    flat = probs.reshape(-1)
    top_n = min(top_n, flat.size)
    idx = np.argsort(-flat)[:top_n]
    out = []
    for i in idx:
        entry = {"index": int(i), "probability": float(flat[i])}
        if int(i) < len(labels):
            entry["label"] = labels[int(i)]
        out.append(entry)
    return out


def _load_labels(path: str) -> List[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


async def handle_infer(request):
    """≙ RunInference (server/main.go:452-601), the hot path. An LLM model
    reaches LLMBackend.infer (input_ids in, output_ids out)."""
    manager = request.app[_MANAGER_KEY]
    name = request.match_info["name"]
    version = request.query.get("version") or None
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    try:
        resolved = await _in_thread(manager.repository.resolve_version, name, version)
        config = await _in_thread(manager.repository.get_config, name, resolved)
        if not manager.is_model_loaded(name, resolved):
            return _json_error(
                400, f"Model {name} is not loaded. Load the model first using /models/{name}/load"
            )
        inputs = _parse_inputs(body, config)
        outputs = await _in_thread(manager.run_inference, name, inputs, resolved)
    except (InvalidArgumentError, ValidationError) as e:
        return _json_error(400, str(e))
    except TpuServeError as e:
        return _json_error(_error_status(e), str(e))
    except Exception as e:
        return _json_error(500, f"Inference failed: {e}")

    model_dir = manager.repository.get_model_path(name, resolved)
    response_outputs = []
    for t in outputs:
        arr = t.numpy()
        entry = {
            "name": t.name,
            "data_type": t.dtype.value,
            "shape": list(t.shape),
            "data": np.asarray(arr, dtype=np.float64).reshape(-1).tolist()
            if t.dtype.is_floating
            else arr.reshape(-1).tolist(),
        }
        label_path = config.resolve_label_file(model_dir, t.name)
        if label_path:
            try:
                labels = _load_labels(label_path)
                if labels:
                    entry["classifications"] = _find_top_classes(arr.astype(np.float32), labels)
            except OSError:
                pass  # labels are best-effort (≙ server/main.go:698-707)
        response_outputs.append(entry)

    return web.json_response(
        {"model_name": name, "model_version": resolved, "outputs": response_outputs}
    )


async def handle_stats(request):
    """Per-model stats endpoint — the reference computed these but exposed no
    route (SURVEY.md §5 tracing)."""
    manager = request.app[_MANAGER_KEY]
    name = request.match_info["name"]
    version = request.query.get("version") or None
    try:
        model = manager.get_model(name, version)
    except ModelNotLoadedError as e:
        return _json_error(400, str(e))
    return web.json_response(
        {"name": name, "version": model.config.version, "stats": model.get_stats()}
    )


async def handle_generate(request):
    """LLM generation: {"input_ids": [...], "max_new_tokens": N, ...} ->
    {"output_ids": [...], "num_generated": N}. Requires an LLM-backend model."""
    manager = request.app[_MANAGER_KEY]
    name = request.match_info["name"]
    version = request.query.get("version") or None
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    try:
        model = manager.get_model(name, version)
    except ModelNotLoadedError as e:
        return _json_error(400, str(e))
    backend = model.backend
    if not hasattr(backend, "generate"):
        return _json_error(400, f"model '{name}' is not a generative model")
    kw = {}
    for k in ("max_new_tokens", "temperature", "top_k", "top_p", "min_p",
              "seed", "repetition_penalty", "stop_token_ids", "logprobs"):
        if k in body:
            kw[k] = body[k]

    text = body.get("text")
    if text is not None:
        # text-in/text-out (requires a model-local tokenizer.json)
        try:
            t0 = time.perf_counter_ns()
            result = await _in_thread(backend.engine.generate_text, str(text), **kw)
            model.stats.record_inference(time.perf_counter_ns() - t0)
            model.stats.record_tokens(
                generated=result["num_generated"],
                prefilled=len(result["output_ids"]) - result["num_generated"])
        except TpuServeError as e:
            return _json_error(_error_status(e), str(e))
        except Exception as e:
            return _json_error(500, f"Generation failed: {e}")
        return web.json_response({"model_name": name, **result})

    ids = body.get("input_ids")
    if not isinstance(ids, list) or not ids:
        return _json_error(400, "'input_ids' must be a non-empty list of token ids (or send 'text')")

    if body.get("stream") or request.query.get("stream"):
        # newline-delimited JSON chunks: {"token": t} ... {"done": true, ...}
        try:
            req = await _in_thread(backend.engine.submit, ids, **kw)
        except TpuServeError as e:
            return _json_error(_error_status(e), str(e))
        resp = web.StreamResponse(headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(request)
        n = 0
        try:
            done = False
            while not done:
                # one executor hop per *burst*: block for the first token,
                # then drain whatever else the engine already queued
                toks = [await _in_thread(req.token_queue.get)]
                while True:
                    try:
                        toks.append(req.token_queue.get_nowait())
                    except _queue.Empty:
                        break
                buf = bytearray()
                for tok in toks:
                    if tok is None:
                        done = True
                        model.stats.record_tokens(generated=n, prefilled=len(ids))
                        final = {"done": True, "finish_reason": req.finish_reason,
                                 "num_generated": n}
                        if req.want_logprobs:
                            final["logprobs"] = list(req.logprobs)
                        if req.error:
                            final["error"] = req.error
                        buf += json.dumps(final).encode() + b"\n"
                        break
                    n += 1
                    buf += json.dumps({"token": int(tok)}).encode() + b"\n"
                await resp.write(bytes(buf))
        except (asyncio.CancelledError, ConnectionResetError, ConnectionError):
            # client went away mid-stream: free the slot promptly
            req.aborted = True
            raise
        await resp.write_eof()
        return resp

    try:
        t0 = time.perf_counter_ns()
        result = await _in_thread(backend.generate, ids, **kw)
        model.stats.record_inference(time.perf_counter_ns() - t0)
        model.stats.record_tokens(generated=len(result["output_ids"]) - len(ids)
                                  if len(result["output_ids"]) >= len(ids) else 0,
                                  prefilled=len(ids))
    except TpuServeError as e:
        return _json_error(_error_status(e), str(e))
    except Exception as e:
        return _json_error(500, f"Generation failed: {e}")
    return web.json_response({"model_name": name, **result})


async def handle_metrics(request):
    """Server-wide telemetry: per-card memory + per-model serving stats
    (tokens/s + utilization endpoint)."""
    manager = request.app[_MANAGER_KEY]
    mems = await _in_thread(device_mod.all_memory_infos)
    models = {}
    for m in manager.loaded_models():
        stats = m.get_stats()
        engine = getattr(m.backend, "_engine", None)
        if engine is not None:  # LLM: scheduler telemetry
            stats["serving"] = engine.serving_stats()
        models[f"{m.config.name}:{m.config.version}"] = stats
    return web.json_response(
        {
            "platform": device_mod.platform_name(),
            "device_count": device_mod.get_device_count(),
            "memory": [x.to_dict() for x in mems],
            "models": models,
            "time": int(time.time()),
        }
    )


# ----------------------------------------------------------------- profiling
# On-demand torch.profiler capture. POST /profile/start begins a trace of
# the host's ops (the starting thread's) and, on the card, of every device
# kernel the process launches, the scheduler thread's included; /profile/stop
# ends it, writes a Chrome trace (trace.json) into the trace dir and returns
# the artifact listing. One capture at a time. Kineto's profiler state is
# process-global, so one single-worker executor starts and stops it.
_PROFILE_KEY = web.AppKey("tpuserve_torch_profile", dict) if web is not None else None
_TRACE_FILE = "trace.json"


async def _in_profiler_thread(st, func, *args):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(st["executor"], functools.partial(func, *args))


def _profile_start(device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _profile_stop(prof, trace_dir):
    prof.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, _TRACE_FILE))


async def handle_profile_status(request):
    st = request.app[_PROFILE_KEY]
    return web.json_response({"active": st.get("dir") is not None,
                              "trace_dir": st.get("dir")})


async def handle_profile_start(request):
    st = request.app[_PROFILE_KEY]
    if st.get("dir") is not None:
        return _json_error(409, f"profiling already active: {st['dir']}")
    try:
        body = await request.json()
    except Exception:
        body = {}
    trace_dir = body.get("dir") or os.path.join(
        tempfile.gettempdir(), f"tpuserve_torch_trace_{int(time.time())}")
    st["dir"] = trace_dir  # claimed before the await: a second start gets 409
    try:
        os.makedirs(trace_dir, exist_ok=True)
        st["prof"] = await _in_profiler_thread(st, _profile_start,
                                               request.app[_MANAGER_KEY].device)
    except Exception as e:  # pragma: no cover - profiler-specific failures
        st["dir"] = None
        return _json_error(500, f"profiler start failed: {e}")
    return web.json_response({"status": "started", "trace_dir": trace_dir})


async def handle_profile_stop(request):
    st = request.app[_PROFILE_KEY]
    trace_dir = st.get("dir")
    if trace_dir is None or st.get("prof") is None:
        return _json_error(400, "profiling is not active")
    prof = st.pop("prof")
    try:
        await _in_profiler_thread(st, _profile_stop, prof, trace_dir)
    except Exception as e:  # pragma: no cover
        return _json_error(500, f"profiler stop failed: {e}")
    finally:
        st["dir"] = None
    files = []
    total = 0
    for root, _dirs, names in os.walk(trace_dir):
        for n in names:
            fp = os.path.join(root, n)
            sz = os.path.getsize(fp)
            files.append({"path": os.path.relpath(fp, trace_dir), "bytes": sz})
            total += sz
    return web.json_response({"status": "stopped", "trace_dir": trace_dir,
                              "files": files, "total_bytes": total})


# ---------------------------------------------------------------------- app
# Paths that stay open when TPUSERVE_AUTH_TOKEN is set (load-balancer /
# liveness probes). Everything else then requires
# `Authorization: Bearer <token>`. As in the JAX front, the token guards
# REST only: gRPC has no check.
_OPEN_PATHS = frozenset({"/", "/health"})


@web.middleware if web is not None else (lambda f: f)
async def _auth_middleware(request, handler):
    token = os.environ.get("TPUSERVE_AUTH_TOKEN")
    if token and request.path not in _OPEN_PATHS:
        got = request.headers.get("Authorization", "")
        if got != f"Bearer {token}":
            return _json_error(401, "missing or invalid bearer token")
    return await handler(request)


def create_app(repository_path: str = "./models", manager: Optional[InferenceManager] = None,
               device="cuda"):
    """Build the aiohttp application (route table ≙ server/main.go:903-917).
    Without `manager`, one is made over `repository_path` that loads its
    models on `device` (the card unless the caller asks for the CPU)."""
    if web is None:  # pragma: no cover
        raise RuntimeError("aiohttp is required for the REST server")
    app = web.Application(client_max_size=256 * 1024 * 1024,
                          middlewares=[_auth_middleware])
    app[_MANAGER_KEY] = manager or InferenceManager(repository_path, device=device)

    app.router.add_get("/", handle_home)
    app.router.add_get("/health", handle_health)
    app.router.add_get("/cuda", handle_cuda)
    app.router.add_get("/tpu", handle_cuda)
    app.router.add_get("/devices", handle_devices)
    app.router.add_get("/gpu/memory", handle_memory)
    app.router.add_get("/tpu/memory", handle_memory)
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_get("/models", handle_list_models)
    app.router.add_get("/models/{name}", handle_model_status)
    app.router.add_get("/models/{name}/stats", handle_stats)
    app.router.add_post("/models/{name}/load", handle_load)
    app.router.add_post("/models/{name}/unload", handle_unload)
    app.router.add_post("/models/{name}/infer", handle_infer)
    app.router.add_post("/models/{name}/generate", handle_generate)
    app[_PROFILE_KEY] = {"executor": concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="tpuserve-torch-profiler")}
    app.router.add_get("/profile", handle_profile_status)
    app.router.add_post("/profile/start", handle_profile_start)
    app.router.add_post("/profile/stop", handle_profile_stop)

    async def _cleanup(app):
        st = app[_PROFILE_KEY]
        prof = st.pop("prof", None)
        if prof is not None:  # a capture left running: end it on its thread
            await _in_profiler_thread(st, prof.stop)
        st["executor"].shutdown(wait=True)
        await _in_thread(app[_MANAGER_KEY].shutdown)

    app.on_cleanup.append(_cleanup)
    return app


def run_server(repository_path: str = "./models", host: str = "0.0.0.0", port: int = 8080,
               device="cuda"):
    """Blocking entry point with graceful shutdown (≙ server/main.go:938-951's
    SIGINT/SIGTERM + 5s drain; aiohttp handles signal-driven teardown)."""
    app = create_app(repository_path, device=device)
    web.run_app(app, host=host, port=port, shutdown_timeout=5.0, print=None)
