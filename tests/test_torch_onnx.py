"""The ONNX subsystem against the JAX package on the CPU: the wire format
(each package reads the other's file), the importer's op set on graphs
written by the port's own writer (a Conv/BatchNormalization/MaxPool/Gemm
classifier with stride-2 SAME-padded conv and pool among them), the seed-42
fixture against reference_mlp_forward, and the ONNX backend's infer with a
bucketed batch of 3 and through the manager. Inputs from numpy with a
seed. Tolerances stated at each test."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve import fixtures as jfixtures
from tpuserve.engine.onnx_backend import OnnxBackend as JOnnxBackend
from tpuserve.onnx import build as jbuild
from tpuserve.onnx import load_model as jload
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve.utils.tensor import Tensor as JTensor
from tpuserve_torch import fixtures
from tpuserve_torch.engine.manager import InferenceManager
from tpuserve_torch.engine.onnx_backend import OnnxBackend
from tpuserve_torch.onnx import Graph, Node, ValueInfo, build, load_model, save_model
from tpuserve_torch.onnx.proto import DT_FLOAT, Attribute
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.utils.errors import UnsupportedError
from tpuserve_torch.utils.tensor import Tensor

# f32 graphs: the same arithmetic in another summation order
F32_RTOL = 1e-5
# the seed-42 fixture against the numpy forward (the acceptance bound)
FIXTURE_ATOL = 1e-5

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Six test workers share the cores: torch's intra-op pool on one thread
    here keeps this file's CPU forwards from waiting on the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _run_port(graph_or_path, **inputs):
    g = load_model(graph_or_path) if isinstance(graph_or_path, str) else graph_or_path
    params, apply, _, _ = build(g)
    out = apply({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                {k: torch.from_numpy(v) for k, v in inputs.items()})
    return {k: v.numpy() for k, v in out.items()}


def _run_jax(path, **inputs):
    params, apply, _, _ = jbuild(jload(path))
    out = apply(params, {k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _a(name, **kw):
    return Attribute(name, **kw)


# ---------------------------------------------------------------------- wire format
def test_fixture_matches_reference_forward(tmp_path):
    """The port's seed-42 fixture: written by the port's writer, read by
    both packages' readers (same nodes and initializers), run by both
    importers; within FIXTURE_ATOL of reference_mlp_forward."""
    vdir = fixtures.create_onnx_test_model(str(tmp_path))
    path = os.path.join(vdir, "model.onnx")
    g, jg = load_model(path), jload(path)
    assert [n.op_type for n in g.nodes] == [n.op_type for n in jg.nodes] == \
        ["MatMul", "Add", "Relu", "MatMul", "Add"]
    for k, v in jg.initializers.items():
        np.testing.assert_array_equal(g.initializers[k], v)
    x = np.array([[1.0, 2.0, 3.0], [-1.0, 0.5, 2.0]], np.float32)
    want = fixtures.reference_mlp_forward(fixtures.make_test_model_weights(), x)
    np.testing.assert_allclose(_run_port(path, input=x)["output"], want, rtol=0,
                               atol=FIXTURE_ATOL)
    np.testing.assert_allclose(_run_jax(path, input=x)["output"], want, rtol=0,
                               atol=FIXTURE_ATOL)
    for k, v in fixtures.make_test_model_weights().items():
        np.testing.assert_array_equal(v, jfixtures.make_test_model_weights()[k])


def test_reads_the_jax_packages_file(tmp_path):
    """The JAX package's own fixture file parses identically in the port."""
    path = os.path.join(jfixtures.create_onnx_test_model(str(tmp_path)), "model.onnx")
    g, jg = load_model(path), jload(path)
    assert [(n.op_type, n.inputs, n.outputs) for n in g.nodes] == \
        [(n.op_type, n.inputs, n.outputs) for n in jg.nodes]
    assert [(v.name, v.shape) for v in g.inputs] == [(v.name, v.shape) for v in jg.inputs]
    x = np.ones((1, 3), np.float32)
    np.testing.assert_allclose(_run_port(path, input=x)["output"],
                               _run_jax(path, input=x)["output"], rtol=F32_RTOL)


# ---------------------------------------------------------------------- op set
def _cnn_graph(auto_pad_conv, auto_pad_pool):
    """Conv (3x3/2) + BatchNormalization + Relu + MaxPool (3x3/2) +
    AveragePool (2x2, pads) + GlobalAveragePool + Flatten + Gemm (transB)
    + Softmax: a small NCHW classifier."""
    rs = np.random.RandomState(3)
    conv_attrs = {"strides": _a("strides", ints=[2, 2]),
                  "kernel_shape": _a("kernel_shape", ints=[3, 3])}
    if auto_pad_conv:
        conv_attrs["auto_pad"] = _a("auto_pad", s=auto_pad_conv.encode())
    else:
        conv_attrs["pads"] = _a("pads", ints=[1, 0, 2, 1])
    pool_attrs = {"kernel_shape": _a("kernel_shape", ints=[3, 3]),
                  "strides": _a("strides", ints=[2, 2])}
    if auto_pad_pool:
        pool_attrs["auto_pad"] = _a("auto_pad", s=auto_pad_pool.encode())
    inits = {"w": rs.randn(6, 3, 3, 3), "b": rs.randn(6), "scale": rs.rand(6) + 0.5,
             "bnb": rs.randn(6), "mean": rs.randn(6), "var": rs.rand(6) + 0.5,
             "fc": rs.randn(10, 6), "fcb": rs.randn(10)}
    inits = {k: v.astype(np.float32) for k, v in inits.items()}
    nodes = [
        Node("Conv", ["x", "w", "b"], ["c"], "conv", conv_attrs),
        Node("BatchNormalization", ["c", "scale", "bnb", "mean", "var"], ["bn"], "bn",
             {"epsilon": _a("epsilon", f=1e-3)}),
        Node("Relu", ["bn"], ["r"], "relu"),
        Node("MaxPool", ["r"], ["mp"], "mp", pool_attrs),
        Node("AveragePool", ["mp"], ["ap"], "ap",
             {"kernel_shape": _a("kernel_shape", ints=[2, 2]),
              "strides": _a("strides", ints=[1, 1]), "pads": _a("pads", ints=[0, 1, 1, 0])}),
        Node("GlobalAveragePool", ["ap"], ["gap"], "gap"),
        Node("Flatten", ["gap"], ["flat"], "flat"),
        Node("Gemm", ["flat", "fc", "fcb"], ["logits"], "gemm",
             {"transB": _a("transB", i=1), "alpha": _a("alpha", f=0.5),
              "beta": _a("beta", f=2.0)}),
        Node("Softmax", ["logits"], ["y"], "sm", {"axis": _a("axis", i=-1)}),
    ]
    return Graph("cnn", nodes, inits, [ValueInfo("x", DT_FLOAT, [2, 3, 16, 16])],
                 [ValueInfo("y", DT_FLOAT, [2, 10])])


@pytest.mark.parametrize("conv_pad,pool_pad", [
    ("SAME_UPPER", "SAME_UPPER"), ("SAME_LOWER", "SAME_LOWER"), ("", ""), ("", "SAME_UPPER")],
    ids=["same_upper", "same_lower", "explicit", "explicit_conv-same_pool"])
def test_cnn_graph_matches_jax(tmp_path, conv_pad, pool_pad):
    """A 16x16 input at stride 2 gives SAME an odd total: both importers put
    the extra row after (XLA's SAME, also for SAME_LOWER: the reference's
    fault, carried)."""
    path = str(tmp_path / "cnn.onnx")
    save_model(path, _cnn_graph(conv_pad, pool_pad))
    x = np.random.default_rng(0).normal(size=(2, 3, 16, 16)).astype(np.float32)
    got, ref = _run_port(path, x=x)["y"], _run_jax(path, x=x)["y"]
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, ref, rtol=F32_RTOL, atol=1e-7)


OP_CASES = {
    # name: (nodes, initializers, input shape)
    "matmul_add_relu": ([Node("MatMul", ["x", "w"], ["m"]), Node("Add", ["m", "b"], ["a"]),
                         Node("Relu", ["a"], ["y"])],
                        {"w": (6, 4), "b": (4,)}, (3, 6)),
    "sub_mul_div": ([Node("Sub", ["x", "b"], ["s"]), Node("Mul", ["s", "b"], ["m"]),
                     Node("Div", ["m", "c"], ["y"])], {"b": (6,), "c": (6,)}, (3, 6)),
    "unary": ([Node("Sigmoid", ["x"], ["a"]), Node("Tanh", ["a"], ["b"]), Node("Erf", ["b"], ["c"]),
               Node("Exp", ["c"], ["d"]), Node("Log", ["d"], ["e"]), Node("Neg", ["e"], ["f"]),
               Node("Sqrt", ["d"], ["g"]), Node("Add", ["f", "g"], ["y"])], {}, (3, 6)),
    "pow": ([Node("Pow", ["x", "p"], ["y"])], {"p": ()}, (3, 6)),
    "activations": ([Node("LeakyRelu", ["x"], ["a"], attrs={"alpha": _a("alpha", f=0.2)}),
                     Node("Elu", ["a"], ["b"], attrs={"alpha": _a("alpha", f=0.7)}),
                     Node("Gelu", ["b"], ["c"]),
                     Node("Gelu", ["c"], ["d"],
                          attrs={"approximate": _a("approximate", s=b"tanh")}),
                     Node("Clip", ["d"], ["e"], attrs={"min": _a("min", f=-0.3),
                                                       "max": _a("max", f=0.8)}),
                     Node("Identity", ["e"], ["f"]), Node("Dropout", ["f"], ["y"])], {}, (3, 6)),
    "log_softmax": ([Node("LogSoftmax", ["x"], ["y"], attrs={"axis": _a("axis", i=1)})], {},
                    (3, 6)),
    "shape_ops": ([Node("Reshape", ["x", "shape"], ["r"]),
                   Node("Transpose", ["r"], ["t"], attrs={"perm": _a("perm", ints=[0, 2, 1])}),
                   Node("Concat", ["t", "t"], ["c"], attrs={"axis": _a("axis", i=2)}),
                   Node("Unsqueeze", ["c"], ["u"], attrs={"axes": _a("axes", ints=[1])}),
                   Node("Squeeze", ["u"], ["s"], attrs={"axes": _a("axes", ints=[1])}),
                   Node("ReduceMean", ["s"], ["y"], attrs={"axes": _a("axes", ints=[2]),
                                                           "keepdims": _a("keepdims", i=0)})],
                  {"shape": np.asarray([3, 2, 3], np.int64)}, (3, 6)),
    "shape_gather_cast": ([Node("Shape", ["x"], ["sh"]), Node("Gather", ["sh", "i"], ["g"]),
                           Node("Cast", ["g"], ["gf"], attrs={"to": _a("to", i=DT_FLOAT)}),
                           Node("Gather", ["x", "j"], ["rows"], attrs={"axis": _a("axis", i=1)}),
                           Node("Mul", ["rows", "gf"], ["y"])],
                          {"i": np.asarray(1, np.int64), "j": np.asarray([0, -1, 2], np.int64)},
                          (3, 6)),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_set_matches_jax(tmp_path, case):
    """Each op of the JAX importer's set, on a small graph, against it."""
    nodes, inits, shape = OP_CASES[case]
    rs = np.random.RandomState(5)
    inits = {k: (v if isinstance(v, np.ndarray) else
                 np.asarray(rs.rand(*v) + 0.5, np.float32)) for k, v in inits.items()}
    out_shape = [-1]
    g = Graph(case, nodes, inits, [ValueInfo("x", DT_FLOAT, list(shape))],
              [ValueInfo("y", DT_FLOAT, out_shape)])
    path = str(tmp_path / f"{case}.onnx")
    save_model(path, g)
    x = (np.random.default_rng(1).normal(size=shape) * 0.7).astype(np.float32)
    if case == "pow":
        x = np.abs(x) + 0.1
    got, ref = _run_port(path, x=x)["y"], _run_jax(path, x=x)["y"]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=F32_RTOL, atol=1e-6)


def test_constant_and_node_order(tmp_path):
    """A Constant node, and nodes out of topological order."""
    from tpuserve_torch.onnx.proto import TensorProto

    c = np.arange(6, dtype=np.float32).reshape(1, 6)
    const = Node("Constant", [], ["k"], attrs={"value": _a("value", t=TensorProto("k", c))})
    g = Graph("const", [Node("Add", ["x", "k"], ["y"]), const],
              {}, [ValueInfo("x", DT_FLOAT, [2, 6])], [ValueInfo("y", DT_FLOAT, [2, 6])])
    x = np.ones((2, 6), np.float32)
    np.testing.assert_array_equal(_run_port(g, x=x)["y"], x + c)


def test_unsupported_op_raises_clearly():
    g = Graph("bad", [Node("NonMaxSuppression", ["x"], ["y"])], {},
              [ValueInfo("x", DT_FLOAT, [1])], [ValueInfo("y", DT_FLOAT, [1])])
    with pytest.raises(UnsupportedError, match="NonMaxSuppression"):
        _run_port(g, x=np.zeros((1,), np.float32))


# ---------------------------------------------------------------------- backend
def _dynamic_entry(root):
    """The CNN graph with a dynamic batch dim, as a repository entry."""
    vdir = os.path.join(root, "onnx_cnn", "1")
    os.makedirs(vdir)
    g = _cnn_graph("SAME_UPPER", "SAME_UPPER")
    g.inputs = [ValueInfo("x", DT_FLOAT, [-1, 3, 16, 16])]
    save_model(os.path.join(vdir, "model.onnx"), g)
    cfg = {"name": "onnx_cnn", "platform": "onnx",
           "inputs": [{"name": "x", "shape": [-1, 3, 16, 16], "data_type": "FLOAT32"}],
           "outputs": [{"name": "y", "shape": [-1, 10], "data_type": "FLOAT32"}]}
    return vdir, cfg


def test_backend_bucketed_batch_matches_jax(tmp_path):
    """A batch of 3 padded to the bucket of 4 in both packages' ONNX
    backends, the padding cut off; the rows as each run alone."""
    vdir, cfg = _dynamic_entry(str(tmp_path))
    x = np.random.default_rng(2).normal(size=(3, 3, 16, 16)).astype(np.float32)
    be = OnnxBackend(vdir, ModelConfig.from_dict(cfg), device="cpu")
    be.load()
    be.warmup()
    jbe = JOnnxBackend(vdir, JModelConfig.from_dict(cfg))
    jbe.load()
    got = be.infer([Tensor.from_numpy("x", x)])
    ref = jbe.infer([JTensor.from_numpy("x", x)])
    assert [(t.name, t.shape, t.dtype.value) for t in got] == \
        [(t.name, t.shape, t.dtype.value) for t in ref] == [("y", (3, 10), "FP32")]
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=F32_RTOL, atol=1e-7)
    solo = be.infer([Tensor.from_numpy("x", x[1:2])])[0].numpy()
    np.testing.assert_allclose(solo[0], got[0].numpy()[1], rtol=F32_RTOL, atol=1e-7)
    assert be.metadata_extras()["graph_inputs"] == ["x"]
    assert be.memory_usage_bytes() == sum(v.nbytes for v in load_model(
        os.path.join(vdir, "model.onnx")).initializers.values())


def test_manager_serves_fixture(tmp_path):
    """Scan -> load -> infer -> unload through InferenceManager(device="cpu")."""
    fixtures.create_onnx_test_model(str(tmp_path), name="onnx_mlp")
    m = InferenceManager(str(tmp_path), device="cpu")
    try:
        m.load_model("onnx_mlp")
        x = np.array([[1.0, 2.0, 3.0]], np.float32)
        out = m.run_inference("onnx_mlp", [Tensor.from_numpy("input", x)])
        want = fixtures.reference_mlp_forward(fixtures.make_test_model_weights(), x)
        np.testing.assert_allclose(out[0].numpy(), want, rtol=0, atol=FIXTURE_ATOL)
        assert m.get_model_status("onnx_mlp")["state"] == "LOADED"
        m.unload_model("onnx_mlp")
    finally:
        m.shutdown()
