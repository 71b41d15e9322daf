"""gRPC frontend (PyTorch port of tpuserve/server/grpc.py).

The reference advertised gRPC but shipped none (SURVEY.md §2c.12). This is a
real grpc.io server over the same InferenceManager as REST. Service wiring is
hand-written with `grpc.method_handlers_generic_handler` (no grpc python
plugin; messages come from proto/tpuserve.proto ->
tpuserve_torch/server/tpuserve_pb2.py, the JAX package's descriptor byte for
byte, so the wire service is the same `/tpuserve.TpuServe/...` and either
package's client talks to either server).

As in the JAX front, TPUSERVE_AUTH_TOKEN guards REST only: gRPC has no
check.

Run: `python -m tpuserve_torch.server --grpc-port 9090` (alongside REST), or
standalone via `serve_grpc()`.
"""

from __future__ import annotations

import json
import time
from concurrent import futures
from typing import List, Optional

import numpy as np

try:
    import grpc
except ImportError:  # pragma: no cover
    grpc = None

from tpuserve_torch.engine.manager import InferenceManager, ModelState
from tpuserve_torch.server import tpuserve_pb2 as pb
from tpuserve_torch.server.http import _find_top_classes, _load_labels
from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import (
    InvalidArgumentError,
    ModelAlreadyLoadedError,
    ModelNotFoundError,
    ModelNotLoadedError,
    TpuServeError,
    UnsupportedError,
    ValidationError,
)
from tpuserve_torch.utils.tensor import Tensor

_SERVICE = "tpuserve.TpuServe"


def _abort(context, e: Exception):
    code = grpc.StatusCode.INTERNAL
    if isinstance(e, ModelNotFoundError):
        code = grpc.StatusCode.NOT_FOUND
    elif isinstance(e, (ModelNotLoadedError, InvalidArgumentError, ValidationError)):
        code = grpc.StatusCode.INVALID_ARGUMENT
    elif isinstance(e, ModelAlreadyLoadedError):
        code = grpc.StatusCode.ALREADY_EXISTS
    elif isinstance(e, UnsupportedError):
        code = grpc.StatusCode.UNIMPLEMENTED
    context.abort(code, str(e))


def _tensor_from_pb(t: pb.Tensor) -> Tensor:
    dtype = DataType.from_string(t.data_type or "FP32")
    np_dt = dtype.np_dtype or np.float32
    shape = [int(d) for d in t.shape]
    if t.raw_data:
        arr = np.frombuffer(t.raw_data, dtype=np_dt)
    elif t.int_data:
        arr = np.asarray(list(t.int_data), dtype=np_dt)
    else:
        arr = np.asarray(list(t.float_data), dtype=np_dt)
    if shape:
        arr = arr.reshape(shape)
    return Tensor(name=t.name, dtype=dtype, shape=arr.shape, data=arr)


def _tensor_to_pb(t: Tensor) -> pb.Tensor:
    arr = t.numpy()
    out = pb.Tensor(name=t.name, data_type=t.dtype.value, shape=list(arr.shape))
    if t.dtype.is_floating:
        out.float_data.extend(np.asarray(arr, np.float32).reshape(-1).tolist())
    else:
        out.int_data.extend(np.asarray(arr, np.int64).reshape(-1).tolist())
    return out


class TpuServeService:
    def __init__(self, manager: InferenceManager):
        self.manager = manager

    # ------------------------------------------------------------------
    def Health(self, request, context):
        return pb.HealthResponse(status="healthy", time=int(time.time()))

    def ListModels(self, request, context):
        entries = self.manager.list_models()
        return pb.ListModelsResponse(
            repository_path=self.manager.repository.path,
            models=[
                pb.ModelEntry(
                    name=e["name"],
                    version=e["version"],
                    is_loaded=e["state"] == ModelState.LOADED.value,
                    state=e["state"],
                )
                for e in entries
            ],
        )

    def ModelStatus(self, request, context):
        try:
            versions = self.manager.repository.get_versions(request.name)
            resolved = self.manager.repository.resolve_version(
                request.name, request.version or None
            )
            config = self.manager.repository.get_config(request.name, resolved)
        except TpuServeError as e:
            _abort(context, e)
        status = self.manager.get_model_status(request.name, resolved)
        return pb.ModelStatusResponse(
            name=request.name,
            version=resolved,
            is_loaded=status["state"] == ModelState.LOADED.value,
            state=status["state"],
            available_versions=versions,
            config_json=json.dumps(config.to_dict()),
            error=status.get("error", ""),
        )

    def LoadModel(self, request, context):
        try:
            resolved = self.manager.repository.resolve_version(
                request.name, request.version or None
            )
            if self.manager.is_model_loaded(request.name, resolved):
                return pb.ModelActionResponse(
                    message="Model already loaded", name=request.name, version=resolved
                )
            self.manager.load_model(request.name, resolved)
        except ModelAlreadyLoadedError:
            return pb.ModelActionResponse(
                message="Model already loaded", name=request.name, version=request.version
            )
        except TpuServeError as e:
            _abort(context, e)
        return pb.ModelActionResponse(
            message="Model loaded successfully", name=request.name, version=resolved
        )

    def UnloadModel(self, request, context):
        try:
            self.manager.unload_model(request.name, request.version or None)
        except ModelNotLoadedError:
            return pb.ModelActionResponse(message="Model not loaded", name=request.name)
        except TpuServeError as e:
            _abort(context, e)
        return pb.ModelActionResponse(
            message="Model unloaded successfully", name=request.name, version=request.version
        )

    def Infer(self, request, context):
        try:
            resolved = self.manager.repository.resolve_version(
                request.name, request.version or None
            )
            config = self.manager.repository.get_config(request.name, resolved)
            inputs = [_tensor_from_pb(t) for t in request.inputs]
            outputs = self.manager.run_inference(request.name, inputs, resolved)
        except TpuServeError as e:
            _abort(context, e)
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL, f"Inference failed: {e}")

        model_dir = self.manager.repository.get_model_path(request.name, resolved)
        pb_outputs = []
        for t in outputs:
            out = pb.InferOutput(tensor=_tensor_to_pb(t))
            label_path = config.resolve_label_file(model_dir, t.name)
            if label_path:
                try:
                    labels = _load_labels(label_path)
                    for c in _find_top_classes(t.numpy().astype(np.float32), labels):
                        out.classifications.append(
                            pb.Classification(
                                index=c["index"],
                                probability=c["probability"],
                                label=c.get("label", ""),
                            )
                        )
                except OSError:
                    pass
            pb_outputs.append(out)
        return pb.InferResponse(
            model_name=request.name, model_version=resolved, outputs=pb_outputs
        )

    # ------------------------------------------------------------------
    def _generate_backend(self, request, context):
        try:
            model = self.manager.get_model(request.name, request.version or None)
        except TpuServeError as e:
            _abort(context, e)
        backend = model.backend
        if not hasattr(backend, "engine"):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"model '{request.name}' is not a generative model",
            )
        kw = {}
        if request.max_new_tokens:
            kw["max_new_tokens"] = request.max_new_tokens
        if request.temperature:
            kw["temperature"] = request.temperature
        if request.top_k:
            kw["top_k"] = request.top_k
        if request.top_p:
            kw["top_p"] = request.top_p
        if request.repetition_penalty and request.repetition_penalty != 1.0:
            kw["repetition_penalty"] = request.repetition_penalty
        if request.stop_token_ids:
            kw["stop_token_ids"] = list(request.stop_token_ids)
        if request.logprobs:
            kw["logprobs"] = True
        return backend.engine, list(request.input_ids), kw, model

    def Generate(self, request, context):
        engine, ids, kw, model = self._generate_backend(request, context)
        try:
            t0 = time.perf_counter_ns()
            result = engine.generate(ids, **kw)
            model.stats.record_inference(time.perf_counter_ns() - t0)
            model.stats.record_tokens(generated=result["num_generated"], prefilled=len(ids))
        except TpuServeError as e:
            _abort(context, e)
        return pb.GenerateResponse(
            output_ids=result["output_ids"],
            generated_ids=result["generated_ids"],
            num_generated=result["num_generated"],
            finish_reason=result["finish_reason"],
            logprobs=result.get("logprobs", []),
        )

    def GenerateStream(self, request, context):
        """Server-streaming generation: tokens as they decode."""
        engine, ids, kw, model = self._generate_backend(request, context)
        try:
            req = engine.submit(ids, **kw)
        except TpuServeError as e:
            _abort(context, e)
        while True:
            tok = req.token_queue.get()
            if tok is None:
                model.stats.record_tokens(generated=len(req.output_ids), prefilled=len(ids))
                yield pb.TokenChunk(token=0, done=True, finish_reason=req.finish_reason)
                return
            yield pb.TokenChunk(token=int(tok), done=False)

    def Metrics(self, request, context):
        from tpuserve_torch import device as device_mod

        models = {
            f"{m.config.name}:{m.config.version}": m.get_stats()
            for m in self.manager.loaded_models()
        }
        payload = {
            "platform": device_mod.platform_name(),
            "device_count": device_mod.get_device_count(),
            "memory": [x.to_dict() for x in device_mod.all_memory_infos()],
            "models": models,
            "time": int(time.time()),
        }
        return pb.MetricsResponse(json=json.dumps(payload))


def _handlers(service: TpuServeService):
    """Hand-rolled method handler table (no grpc codegen plugin available)."""
    rpcs = {
        "Health": (pb.HealthRequest, pb.HealthResponse, "unary"),
        "ListModels": (pb.ListModelsRequest, pb.ListModelsResponse, "unary"),
        "ModelStatus": (pb.ModelRequest, pb.ModelStatusResponse, "unary"),
        "LoadModel": (pb.ModelRequest, pb.ModelActionResponse, "unary"),
        "UnloadModel": (pb.ModelRequest, pb.ModelActionResponse, "unary"),
        "Infer": (pb.InferRequest, pb.InferResponse, "unary"),
        "Generate": (pb.GenerateRequest, pb.GenerateResponse, "unary"),
        "GenerateStream": (pb.GenerateRequest, pb.TokenChunk, "stream"),
        "Metrics": (pb.MetricsRequest, pb.MetricsResponse, "unary"),
    }
    table = {}
    for name, (req_t, resp_t, kind) in rpcs.items():
        method = getattr(service, name)
        if kind == "unary":
            table[name] = grpc.unary_unary_rpc_method_handler(
                method,
                request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString,
            )
        else:
            table[name] = grpc.unary_stream_rpc_method_handler(
                method,
                request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString,
            )
    return grpc.method_handlers_generic_handler(_SERVICE, table)


def create_grpc_server(
    manager: InferenceManager, port: int, host: str = "0.0.0.0", max_workers: int = 16
):
    if grpc is None:  # pragma: no cover
        raise RuntimeError("grpcio is required for the gRPC server")
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_handlers(TpuServeService(manager)),))
    server.add_insecure_port(f"{host}:{port}")
    return server


def serve_grpc(repository_path: str, port: int = 9090, host: str = "0.0.0.0", device="cuda"):
    manager = InferenceManager(repository_path, device=device)
    server = create_grpc_server(manager, port, host)
    server.start()
    server.wait_for_termination()


class GrpcClient:
    """Minimal client helper (tests, scripts). Mirrors the hand-rolled
    service wiring on the caller side."""

    def __init__(self, target: str):
        self.channel = grpc.insecure_channel(target)

        def unary(name, req_t, resp_t):
            return self.channel.unary_unary(
                f"/{_SERVICE}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            )

        self.health = unary("Health", pb.HealthRequest, pb.HealthResponse)
        self.list_models = unary("ListModels", pb.ListModelsRequest, pb.ListModelsResponse)
        self.model_status = unary("ModelStatus", pb.ModelRequest, pb.ModelStatusResponse)
        self.load_model = unary("LoadModel", pb.ModelRequest, pb.ModelActionResponse)
        self.unload_model = unary("UnloadModel", pb.ModelRequest, pb.ModelActionResponse)
        self.infer = unary("Infer", pb.InferRequest, pb.InferResponse)
        self.generate = unary("Generate", pb.GenerateRequest, pb.GenerateResponse)
        self.metrics = unary("Metrics", pb.MetricsRequest, pb.MetricsResponse)
        self.generate_stream = self.channel.unary_stream(
            f"/{_SERVICE}/GenerateStream",
            request_serializer=pb.GenerateRequest.SerializeToString,
            response_deserializer=pb.TokenChunk.FromString,
        )

    def close(self):
        self.channel.close()
