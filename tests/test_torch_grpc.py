"""The port's gRPC front (tpuserve_torch.server.grpc) on the wire, both ways.

The port keeps the JAX package's descriptor byte for byte, so the service is
`/tpuserve.TpuServe/...` on either side: the JAX package's GrpcClient
against the port's server and the port's GrpcClient against the JAX server
(its kernels in Pallas interpret mode), every one of the nine RPCs in each
of the four pairings, and greedy tokens equal across all four.
"""

import json

import pytest

grpc = pytest.importorskip("grpc")

from tpuserve.engine.manager import InferenceManager as JManager  # noqa: E402
from tpuserve.models import llama as jllama  # noqa: E402
from tpuserve.quant import core as jcore  # noqa: E402
from tpuserve.server import tpuserve_pb2 as jpb  # noqa: E402
from tpuserve.server.grpc import GrpcClient as JGrpcClient  # noqa: E402
from tpuserve.server.grpc import create_grpc_server as jax_create_grpc_server  # noqa: E402
from tpuserve_torch.engine.manager import InferenceManager  # noqa: E402
from tpuserve_torch.server import tpuserve_pb2 as pb  # noqa: E402
from tpuserve_torch.server.grpc import GrpcClient, create_grpc_server  # noqa: E402
from torch_parity import serve_config, write_model  # noqa: E402

DEADLINE = 60  # seconds, every RPC
PROMPT = [5, 17, 100, 42, 7]
CLIENTS = {"jax": (JGrpcClient, jpb), "port": (GrpcClient, pb)}


def _serve(create, manager):
    server = create(manager, port=0, host="127.0.0.1")
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, f"127.0.0.1:{port}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers over one repository, `llm` loaded in each; `spare` stays
    unloaded for the lifecycle RPCs."""
    root = str(tmp_path_factory.mktemp("grpc_repo"))
    write_model(root, "llm", serve_config("llm"))
    write_model(root, "spare", serve_config("spare", max_new_tokens=2))
    started = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jllama, "_decode_attn_mode", lambda p: "pallas")
        mp.setattr(jllama, "qmatmul",
                   lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))
        try:
            jmgr = JManager(root, num_workers=1)
            started.append(jmgr)
            jmgr.load_model("llm")
            tmgr = InferenceManager(root, num_workers=1, device="cpu")
            started.append(tmgr)
            tmgr.load_model("llm")
            want = tmgr.get_model("llm").backend.generate(PROMPT, max_new_tokens=5)
            jserver, jaddr = _serve(jax_create_grpc_server, jmgr)
            started.append(jserver)
            tserver, taddr = _serve(create_grpc_server, tmgr)
            started.append(tserver)
            yield {"jax": jaddr, "port": taddr}, want
        finally:
            for obj in reversed(started):
                if hasattr(obj, "stop"):
                    obj.stop(grace=None)
                else:
                    obj.shutdown()


def test_both_pb2_modules_share_the_descriptor():
    """One process imports both: the same serialized file, package
    `tpuserve`, and the same wire service."""
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.name == "tpuserve.proto" and pb.DESCRIPTOR.package == "tpuserve"
    assert list(pb.DESCRIPTOR.services_by_name) == ["TpuServe"]
    assert len(pb.DESCRIPTOR.services_by_name["TpuServe"].methods) == 9
    req = pb.GenerateRequest(name="llm", input_ids=PROMPT, max_new_tokens=5)
    assert jpb.GenerateRequest.FromString(req.SerializeToString()) == req


@pytest.mark.parametrize("client_side", ["jax", "port"])
@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_nine_rpcs(servers, client_side, server_side):
    """Health, ListModels, ModelStatus, LoadModel, UnloadModel, Infer,
    Generate, GenerateStream and Metrics; greedy tokens equal the port's
    backend.generate whichever client and server."""
    addrs, want = servers
    make_client, m = CLIENTS[client_side]
    client = make_client(addrs[server_side])
    try:
        resp = client.health(m.HealthRequest(), timeout=DEADLINE)
        assert resp.status == "healthy" and resp.time > 0

        listed = client.list_models(m.ListModelsRequest(), timeout=DEADLINE)
        assert {e.name: (e.is_loaded, e.state) for e in listed.models} == {
            "llm": (True, "LOADED"), "spare": (False, "UNLOADED")}
        st = client.model_status(m.ModelRequest(name="llm"), timeout=DEADLINE)
        assert (st.version, st.is_loaded, st.state) == ("1", True, "LOADED")
        assert json.loads(st.config_json)["model_params"]["head_dim"] == 128
        with pytest.raises(grpc.RpcError) as e:
            client.model_status(m.ModelRequest(name="ghost"), timeout=DEADLINE)
        assert e.value.code() == grpc.StatusCode.NOT_FOUND

        resp = client.load_model(m.ModelRequest(name="llm"), timeout=DEADLINE)
        assert resp.message == "Model already loaded" and resp.version == "1"
        resp = client.unload_model(m.ModelRequest(name="spare"), timeout=DEADLINE)
        assert resp.message == "Model not loaded"
        with pytest.raises(grpc.RpcError) as e:
            client.load_model(m.ModelRequest(name="ghost"), timeout=DEADLINE)
        assert e.value.code() == grpc.StatusCode.NOT_FOUND

        resp = client.infer(m.InferRequest(name="llm", inputs=[m.Tensor(
            name="input_ids", data_type="INT32", shape=[1, 5], int_data=PROMPT)]),
            timeout=DEADLINE)
        out = resp.outputs[0].tensor
        assert out.name == "output_ids" and list(out.shape) == [1, 10]
        assert list(out.int_data) == want["output_ids"]
        with pytest.raises(grpc.RpcError) as e:
            client.infer(m.InferRequest(name="spare"), timeout=DEADLINE)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT

        req = m.GenerateRequest(name="llm", input_ids=PROMPT, max_new_tokens=5)
        resp = client.generate(req, timeout=DEADLINE)
        assert list(resp.generated_ids) == want["generated_ids"]
        assert list(resp.output_ids) == want["output_ids"]
        assert (resp.num_generated, resp.finish_reason) == (5, "max_new_tokens")
        chunks = list(client.generate_stream(req, timeout=DEADLINE))
        assert [c.token for c in chunks[:-1]] == want["generated_ids"]
        assert chunks[-1].done and chunks[-1].finish_reason == "max_new_tokens"
        resp = client.generate(m.GenerateRequest(name="llm", input_ids=PROMPT, max_new_tokens=5,
                                                 logprobs=True,
                                                 stop_token_ids=[want["generated_ids"][1]]),
                               timeout=DEADLINE)
        n_stop = want["generated_ids"].index(want["generated_ids"][1]) + 1
        assert resp.finish_reason == "stop" and resp.num_generated == n_stop
        assert len(resp.logprobs) == n_stop and all(lp <= 0 for lp in resp.logprobs)
        with pytest.raises(grpc.RpcError) as e:
            client.generate(m.GenerateRequest(name="spare", input_ids=PROMPT), timeout=DEADLINE)
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT

        payload = json.loads(client.metrics(m.MetricsRequest(), timeout=DEADLINE).json)
        assert set(payload) == {"platform", "device_count", "memory", "models", "time"}
        assert payload["models"]["llm:1"]["inference_count"] >= 1
    finally:
        client.close()


def test_port_server_load_unload_cycle(servers):
    """The lifecycle RPCs that change state, on the port's server (a model
    loads on the CPU in a second): load, load again, unload, unload again."""
    addrs, _ = servers
    client = GrpcClient(addrs["port"])
    try:
        resp = client.load_model(pb.ModelRequest(name="spare"), timeout=DEADLINE)
        assert (resp.message, resp.version) == ("Model loaded successfully", "1")
        resp = client.load_model(pb.ModelRequest(name="spare"), timeout=DEADLINE)
        assert resp.message == "Model already loaded"
        resp = client.generate(pb.GenerateRequest(name="spare", input_ids=PROMPT),
                               timeout=DEADLINE)
        assert resp.num_generated == 2  # the config's max_new_tokens
        resp = client.unload_model(pb.ModelRequest(name="spare"), timeout=DEADLINE)
        assert resp.message == "Model unloaded successfully"
        resp = client.unload_model(pb.ModelRequest(name="spare"), timeout=DEADLINE)
        assert resp.message == "Model not loaded"
    finally:
        client.close()
