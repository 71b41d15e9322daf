"""Micro-batching and the zoo's serving path against the JAX package on
the CPU: the batcher's coalescing and its split (both packages' batchers on
the same requests), the zoo backend's infer with a bucketed batch of 3,
`models/test_model` from its safetensors, the TorchScript backend, the
manager's dynamic batching and /stats, and eval_accuracy's classifier
branch. Inputs from numpy with a seed; tolerances stated at each test."""

import importlib.util
import json
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_tree_to_numpy
from tpuserve.engine.batcher import MicroBatcher as JMicroBatcher
from tpuserve.engine.jax_backend import JaxBackend as JJaxBackend
from tpuserve.engine.torch_backend import TorchBackend as JTorchBackend
from tpuserve.models import layers as jlayers
from tpuserve.models.registry import get_architecture as jget
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.utils.dtypes import DataType as JDataType
from tpuserve.utils.tensor import Tensor as JTensor
from tpuserve_torch import fixtures
from tpuserve_torch.engine.batcher import MicroBatcher
from tpuserve_torch.engine.jax_backend import JaxBackend, load_checkpoint
from tpuserve_torch.engine.manager import InferenceManager
from tpuserve_torch.engine.torch_backend import TorchBackend
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.scripts import eval_accuracy as teval
from tpuserve_torch.utils.checkpoint import read_safetensors, write_safetensors
from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import BackendError
from tpuserve_torch.utils.tensor import Tensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the seed-42 MLP against the numpy forward (the acceptance bound)
FIXTURE_ATOL = 1e-5
# f32 models: the same arithmetic in another summation order
F32_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Six test workers share the cores: torch's intra-op pool on one thread
    here keeps this file's CPU forwards from waiting on the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pallas(monkeypatch):
    """The JAX zoo's linear on its Pallas quant-matmul (interpret mode)."""
    monkeypatch.setattr(jlayers, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


# ---------------------------------------------------------------------- batcher
PACKAGES = {"port": (MicroBatcher, Tensor, DataType), "jax": (JMicroBatcher, JTensor, JDataType)}


class Doubler:
    """An infer fn: y = 2x, recording every call's batch."""

    def __init__(self, tensor_cls, dtype, delay=0.0):
        self.calls, self.delay = [], delay
        self.tensor_cls, self.dtype = tensor_cls, dtype

    def __call__(self, inputs):
        self.calls.append(inputs[0].shape[0])
        time.sleep(self.delay)
        x = inputs[0].numpy()
        y = (2.0 * x).astype(np.float32)
        return [self.tensor_cls(name="y", dtype=self.dtype.FP32, shape=y.shape, data=y)]


def _run_concurrent(batcher_cls, tensor_cls, dtype, rows, delay_us=200_000):
    """One request a thread, all released at once; the followers arrive in
    the leader's window. Returns (calls, each request's output, batcher)."""
    fn = Doubler(tensor_cls, dtype)
    mb = batcher_cls(fn, batch_axis_inputs=["x"], max_queue_delay_us=delay_us)
    outs, barrier = {}, threading.Barrier(len(rows))

    def run(i):
        barrier.wait()
        if i:
            time.sleep(0.02)
        x = np.full((rows[i], 3), float(i + 1), np.float32)
        outs[i] = mb.infer([tensor_cls(name="x", dtype=dtype.FP32, shape=x.shape, data=x)])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return fn.calls, outs, mb


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_coalescing_and_split(package):
    """Requests of 1, 2 and 1 rows coalesce into one forward of 4 rows, and
    each gets back exactly its rows; the counters say so. Both packages'
    batchers give the same calls, outputs and counters."""
    batcher_cls, tensor_cls, dtype = PACKAGES[package]
    calls, outs, mb = _run_concurrent(batcher_cls, tensor_cls, dtype, [1, 2, 1])
    assert calls == [4] and mb.batches == 1 and mb.batched_requests == 3
    for i, rows in enumerate([1, 2, 1]):
        assert outs[i][0].shape == (rows, 3)
        np.testing.assert_array_equal(outs[i][0].numpy(), np.full((rows, 3), 2.0 * (i + 1)))


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_fall_through_and_errors(package):
    """Other non-batch shapes do not merge, unbatchable inputs fall through
    to direct calls, and an error reaches every follower."""
    batcher_cls, tensor_cls, dtype = PACKAGES[package]
    fn = Doubler(tensor_cls, dtype)

    def t(x):
        x = np.asarray(x, np.float32)
        return tensor_cls(name="x", dtype=dtype.FP32, shape=x.shape, data=x)

    mb = batcher_cls(fn, batch_axis_inputs=["x"], max_queue_delay_us=0)
    assert mb.infer([t(np.ones((2, 5)))])[0].shape == (2, 5)
    assert mb.infer([t(np.ones((1, 3)))])[0].shape == (1, 3)
    off = batcher_cls(fn, batch_axis_inputs=[], max_queue_delay_us=10_000)
    assert off.infer([t(np.ones((1, 3)))])[0].shape == (1, 3)
    assert fn.calls == [2, 1, 1] and mb.batches == 0

    def boom(inputs):
        time.sleep(0.01)
        raise RuntimeError("kaboom")

    bad = batcher_cls(boom, batch_axis_inputs=["x"], max_queue_delay_us=100_000)
    errors, barrier = [], threading.Barrier(2)

    def run(i):
        barrier.wait()
        if i:
            time.sleep(0.02)
        try:
            bad.infer([t(np.ones((1, 3)))])
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert errors == ["kaboom", "kaboom"]


def test_arrivals_during_a_forward_join_the_next_batch():
    """The port's leader opens its window before it waits for an instance:
    three requests that arrive while a forward runs make one batch of 3
    after it. (The JAX package's batcher runs each of them alone.)"""
    fn = Doubler(Tensor, DataType, delay=0.3)
    mb = MicroBatcher(fn, batch_axis_inputs=["x"], max_queue_delay_us=1000)
    outs = {}

    def run(i):
        x = np.full((1, 3), float(i), np.float32)
        outs[i] = mb.infer([Tensor.from_numpy("x", x)])[0].numpy()

    first = threading.Thread(target=run, args=(0,), daemon=True)
    first.start()
    time.sleep(0.1)                    # the first forward is running
    rest = [threading.Thread(target=run, args=(i,), daemon=True) for i in (1, 2, 3)]
    for t in rest:
        t.start()
        time.sleep(0.01)
    for t in [first] + rest:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in [first] + rest)
    assert fn.calls == [1, 3] and (mb.batches, mb.batched_requests) == (1, 3)
    for i in range(4):
        np.testing.assert_array_equal(outs[i], np.full((1, 3), 2.0 * i))


def test_stress_many_threads_every_row_back():
    """32 threads (more than the cores) on 2 instances with a short switch
    interval: every request gets exactly its rows, and the counters add up
    to the forwards and requests the infer fn saw."""
    fn = Doubler(Tensor, DataType, delay=0.001)
    mb = MicroBatcher(fn, batch_axis_inputs=["x"], max_queue_delay_us=500, instance_count=2)
    outs, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            try:
                x = np.full((1 + i % 3, 3), float(i), np.float32)
                outs[i] = mb.infer([Tensor.from_numpy("x", x)])[0].numpy()
            except BaseException as e:  # noqa: BLE001 - recorded and asserted below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(32)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not any(t.is_alive() for t in threads), "a request was never answered"
    finally:
        sys.setswitchinterval(old)
    assert not errors
    for i in range(32):
        np.testing.assert_array_equal(outs[i], np.full((1 + i % 3, 3), 2.0 * i))
    assert sum(fn.calls) == sum(1 + i % 3 for i in range(32))
    assert mb.batched_requests - mb.batches == 32 - len(fn.calls)


# ---------------------------------------------------------------------- zoo backend
BACKEND_CASES = {
    "mlp-f32": ({"architecture": "mlp", "model_params": {"features": [32, 10]},
                 "inputs": [{"name": "input", "shape": [-1, 16], "data_type": "FLOAT32"}],
                 "outputs": [{"name": "output", "shape": [-1, 10], "data_type": "FLOAT32"}]},
                F32_RTOL),
    "mlp-int8": ({"architecture": "mlp", "model_params": {"features": [256, 10]},
                  "quantization": {"weights": "int8"},
                  "inputs": [{"name": "input", "shape": [-1, 16], "data_type": "FLOAT32"}],
                  "outputs": [{"name": "output", "shape": [-1, 10], "data_type": "FLOAT32"}]},
                 F32_RTOL),
    "mlp-int4": ({"architecture": "mlp", "model_params": {"features": [256, 10]},
                  "quantization": {"weights": "int4"},
                  "inputs": [{"name": "input", "shape": [-1, 16], "data_type": "FLOAT32"}],
                  "outputs": [{"name": "output", "shape": [-1, 10], "data_type": "FLOAT32"}]},
                 F32_RTOL),
}


def _entry(root, name, spec):
    """A `platform: jax` entry: JAX-initialized weights as params.npz (f32;
    bf16 values are exact in it)."""
    cfg = dict(spec, name=name, platform="jax")
    vdir = os.path.join(root, name, "1")
    os.makedirs(vdir)
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    params = jax_tree_to_numpy(jax.jit(jget(JModelConfig.from_dict(cfg)).init)(
        jax.random.PRNGKey(1)))
    np.savez(os.path.join(vdir, "params.npz"),
             **{k: np.asarray(v, np.float32) for k, v in params.items()})
    return vdir, cfg


@pytest.mark.parametrize("case", sorted(BACKEND_CASES))
def test_zoo_backend_bucketed_batch_matches_jax(tmp_path, case):
    """A batch of 3 padded to the bucket of 4 by both packages' zoo
    backends (weights quantized at load per the config), the padding cut
    off, outputs cast to the declared dtypes."""
    spec, rel = BACKEND_CASES[case]
    vdir, cfg = _entry(str(tmp_path), case, spec)
    inp = cfg["inputs"][0]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, inp["shape"][1])).astype(np.float32)
    be = JaxBackend(vdir, ModelConfig.from_dict(cfg), device="cpu")
    be.load()
    be.warmup()
    jbe = JJaxBackend(vdir, JModelConfig.from_dict(cfg))
    jbe.load()
    got = be.infer([Tensor.from_numpy(inp["name"], x)])
    ref = jbe.infer([JTensor.from_numpy(inp["name"], x)])
    assert [(t.name, t.shape, t.dtype.value) for t in got] == \
        [(t.name, t.shape, t.dtype.value) for t in ref]
    assert got[0].shape[0] == 3
    for g, r in zip(got, ref):
        r = r.numpy()
        assert np.abs(g.numpy() - r).max() <= rel * np.abs(r).max(), (g.name, case)
    assert be.memory_usage_bytes() == jbe.memory_usage_bytes()


def test_test_model_from_safetensors(tmp_path):
    """The repository's models/test_model: the port's safetensors reader
    equals safetensors.numpy.load_file (and reads a file the port writes,
    BF16 included); through the manager its output equals
    reference_mlp_forward within FIXTURE_ATOL."""
    from safetensors.numpy import load_file

    path = os.path.join(REPO, "models", "test_model", "1", "model.safetensors")
    ours, theirs = read_safetensors(path), load_file(path)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v)
    mixed = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
             "b": np.arange(4, dtype=np.int64), "c": np.ones((2, 2), np.float16)}
    write_safetensors(str(tmp_path / "m.safetensors"), mixed)
    back = read_safetensors(str(tmp_path / "m.safetensors"))
    assert torch.equal(back["a"], mixed["a"])
    np.testing.assert_array_equal(back["b"].numpy(), mixed["b"])
    np.testing.assert_array_equal(load_file(str(tmp_path / "m.safetensors"))["c"], mixed["c"])

    m = InferenceManager(os.path.join(REPO, "models"), device="cpu")
    try:
        m.load_model("test_model")
        x = np.array([[1.0, 2.0, 3.0]], np.float32)
        out = m.run_inference("test_model", [Tensor.from_numpy("input", x)])
        want = fixtures.reference_mlp_forward(fixtures.make_test_model_weights(), x)
        assert out[0].name == "output"
        np.testing.assert_allclose(out[0].numpy(), want, rtol=0, atol=FIXTURE_ATOL)
    finally:
        m.shutdown()


def test_checkpoint_formats_refused_cleanly(tmp_path):
    """An orbax checkpoint/ directory is refused (the port has no orbax
    reader); no checkpoint at all is named as such."""
    (tmp_path / "checkpoint").mkdir()
    with pytest.raises(BackendError, match="orbax"):
        load_checkpoint(str(tmp_path))
    with pytest.raises(BackendError, match="no checkpoint"):
        load_checkpoint(str(tmp_path / "checkpoint"))


def test_manager_dynamic_batching_stats(tmp_path):
    """The seed-42 MLP with dynamic_batching: concurrent one-row /infer
    calls coalesce (visible in /stats) and each gets its own answer."""
    vdir = fixtures.create_test_model(str(tmp_path), name="batched_mlp")
    with open(os.path.join(vdir, "config.json")) as fh:
        cfg = json.load(fh)
    cfg.update(dynamic_batching=True, max_batch_size=16,
               inputs=[{"name": "input", "shape": [-1, 3], "data_type": "FP32"}],
               outputs=[{"name": "output", "shape": [-1, 2], "data_type": "FP32"}])
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    m = InferenceManager(str(tmp_path), device="cpu")
    try:
        m.load_model("batched_mlp")
        outs, barrier = {}, threading.Barrier(6)

        def run(i):
            barrier.wait()
            if i:
                time.sleep(0.001)
            x = np.full((1, 3), float(i), np.float32)
            outs[i] = m.run_inference("batched_mlp", [Tensor.from_numpy("input", x)])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        stats = m.get_model_status("batched_mlp")["stats"]
        assert stats.get("dynamic_batched_requests", 0) >= 2, stats
        assert stats["dynamic_batches"] < 6
        w = fixtures.make_test_model_weights()
        for i in range(6):
            want = fixtures.reference_mlp_forward(w, np.full((1, 3), float(i), np.float32))
            np.testing.assert_allclose(outs[i][0].numpy(), want, rtol=0, atol=FIXTURE_ATOL)
    finally:
        m.shutdown()


# ---------------------------------------------------------------------- torchscript
def test_torchscript_backend_matches_jax_packages(tmp_path):
    """A scripted module served by the port's backend (on the device the
    manager names, here the CPU) gives the JAX package's TorchScript
    backend's outputs, names and dtypes."""

    class TinyNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(3, 2)

        def forward(self, x):
            return torch.relu(self.fc(x)), x.sum(dim=1)

    torch.manual_seed(0)
    vdir = tmp_path / "ts" / "1"
    vdir.mkdir(parents=True)
    torch.jit.script(TinyNet().eval()).save(str(vdir / "model.pt"))
    cfg = {"name": "ts", "platform": "pytorch",
           "inputs": [{"name": "input", "shape": [-1, 3], "data_type": "FLOAT32"}],
           "outputs": [{"name": "output", "shape": [-1, 2], "data_type": "FLOAT32"}]}
    be = TorchBackend(str(vdir), ModelConfig.from_dict(cfg), device="cpu")
    be.load()
    jbe = JTorchBackend(str(vdir), JModelConfig.from_dict(cfg))
    jbe.load()
    x = np.random.default_rng(6).normal(size=(4, 3)).astype(np.float32)
    got = be.infer([Tensor.from_numpy("input", x)])
    ref = jbe.infer([JTensor.from_numpy("input", x)])
    assert [(t.name, t.shape) for t in got] == [(t.name, t.shape) for t in ref] == \
        [("output", (4, 2)), ("output_1", (4,))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert be.memory_usage_bytes() == jbe.memory_usage_bytes() == 8 * 4
    with pytest.raises(BackendError, match="model.pt"):
        TorchBackend(str(tmp_path), ModelConfig.from_dict(cfg), device="cpu").load()


# ---------------------------------------------------------------------- eval_accuracy
def _jax_eval_accuracy():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_accuracy", os.path.join(REPO, "scripts", "eval_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_accuracy_classifier_branch_matches_jax(tmp_path):
    """--model on a zoo classifier: the same result keys (plus `device`)
    and values as the JAX script on the same checkpoint and draws: top-1
    agreement equal, logit correlation within 1e-5 (f32 x on int8 weights:
    the f32 route against XLA's dequantize-then-matmul)."""
    spec, _ = BACKEND_CASES["mlp-int8"]
    _entry(str(tmp_path), "clf", spec)
    res = teval.evaluate(str(tmp_path), "clf", "", samples=16, seed=0, device="cpu")
    ref = _jax_eval_accuracy().evaluate(str(tmp_path), "clf", "", 16, 0)
    assert set(res) == set(ref) | {"device"} and res["device"] == "cpu"
    assert res["metric"] == ref["metric"] == "top1_agreement"
    assert res["top1_agreement"] == ref["top1_agreement"]
    assert abs(res["logit_correlation"] - ref["logit_correlation"]) <= 1e-5
    assert res["gate_pass"] == ref["gate_pass"]
    assert teval.main(["--repository", str(tmp_path), "--model", "clf", "--samples", "16",
                       "--device", "cpu", "--json"]) == (0 if res["gate_pass"] else 1)
