"""The model zoo against the JAX package on the CPU: each layer of
tpuserve_torch/models/layers.py, and mlp, bert (2 layers, dim 128) and
resnet50 (32x32, 10 classes) in f32 or bf16 and int8/int4 quantized
(DenseNet-121 is in test_torch_densenet.py). Inputs come from numpy with a
seed; weights from the JAX package's `init`, carried across by
`interop.params_from_numpy`. The JAX side runs its Pallas quant-matmul in
interpret mode; the port its plain version. Tolerances are stated at
each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import jax_to_torch_params, to_np
from tpuserve.models import layers as jlayers
from tpuserve.models.registry import get_architecture as jget
from tpuserve.quant import core as jcore
from tpuserve.repository.config import ModelConfig as JModelConfig
from tpuserve_torch import interop
from tpuserve_torch.models import layers as tlayers
from tpuserve_torch.models.registry import get_architecture as tget
from tpuserve_torch.models.registry import known_architectures
from tpuserve_torch.quant.core import QTensor as TQTensor
from tpuserve_torch.quant.core import quantize_param_tree as tquantize_param_tree
from tpuserve_torch.repository.config import ModelConfig as TModelConfig

# f32: the same arithmetic in another summation order
F32_RTOL = 1e-5
# bf16: a layer is a chain of bf16 ops (layer_norm: five), and the two
# frameworks round intermediates at other places; up to four roundings
# (2^-8 relative each) may land apart
BF16_REL = 2.0 ** -6


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


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None else jnp.asarray(a)


def _t(a, dtype=None):
    t = interop.tensor_from_numpy(np.asarray(a), "cpu")
    return t.to(dtype) if dtype is not None else t


def _close(got, ref, rel, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max|err| {err} > {rel} x {scale}"


def _dtypes(kind):
    return {"f32": (jnp.float32, torch.float32, F32_RTOL),
            "bf16": (jnp.bfloat16, torch.bfloat16, BF16_REL)}[kind]


# ---------------------------------------------------------------------- layers
def test_registry_names_every_family():
    assert set(known_architectures()) >= {"mlp", "bert", "densenet121", "densenet169",
                                          "resnet50", "resnet101", "llama", "mixtral"}


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("weight", ["plain", "int8_g128", "int8_channel", "int4_g128"])
def test_linear(kind, weight):
    """A [3, 256] x [256, 40] linear with bias; quantized weights go through
    qmatmul (JAX: Pallas interpret; port: the kernel's plain version)."""
    jdt, tdt, rel = _dtypes(kind)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 40)) * 0.05).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    jp = {"fc/kernel": _j(w), "fc/bias": _j(b)}
    if weight != "plain":
        bits, gs = {"int8_g128": (8, 128), "int8_channel": (8, 0), "int4_g128": (4, 128)}[weight]
        jp["fc/kernel"] = jcore.quantize(jp["fc/kernel"], bits=bits, group_size=gs)
    tp = jax_to_torch_params(jp)
    ref = jlayers.linear(jp, "fc", _j(x, jdt))
    got = tlayers.linear(tp, "fc", _t(x, tdt))
    assert got.dtype == tdt
    _close(to_np(got), np.asarray(ref.astype(jnp.float32)), rel, f"linear {weight} {kind}")


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_norms(kind, norm):
    jdt, tdt, rel = _dtypes(kind)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"n/scale": rng.normal(size=(64,)).astype(np.float32),
         "n/bias": rng.normal(size=(64,)).astype(np.float32)}
    jp = {k: _j(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    ref = getattr(jlayers, norm)(jp, "n", _j(x, jdt))
    got = getattr(tlayers, norm)(tp, "n", _t(x, tdt))
    _close(to_np(got), np.asarray(ref.astype(jnp.float32)), rel, norm)


CONV_CASES = [
    # (h, w, cin, cout, k, stride, padding)
    (32, 32, 3, 8, 7, 2, "SAME"),     # the stem: even total at stride 2 -> odd row after
    (15, 15, 4, 6, 3, 2, "SAME"),     # odd size at stride 2
    (9, 9, 4, 6, 3, 1, "SAME"),
    (8, 8, 16, 12, 1, 2, "SAME"),     # 1x1 projection at stride 2
    (9, 7, 4, 6, 3, 1, "VALID"),
    (8, 8, 4, 6, 3, 2, ((1, 2), (0, 1))),
]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[0]}x{c[1]}k{c[4]}s{c[5]}{c[6]}")
def test_conv2d(kind, case):
    """NHWC conv over a flat HWIO kernel, with bias, against
    lax.conv_general_dilated (XLA's SAME split, explicit pads)."""
    h, w, cin, cout, k, s, pad = case
    jdt, tdt, rel = _dtypes(kind)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    p = {"c/kernel": (rng.normal(size=(k * k * cin, cout)) * 0.2).astype(np.float32),
         "c/bias": rng.normal(size=(cout,)).astype(np.float32)}
    jp = {n: _j(v) for n, v in p.items()}
    tp = {n: _t(v) for n, v in p.items()}
    ref = jlayers.conv2d(jp, "c", _j(x, jdt), kernel_hw=(k, k), stride=s, padding=pad, bias=True)
    got = tlayers.conv2d(tp, "c", _t(x, tdt), kernel_hw=(k, k), stride=s, padding=pad, bias=True)
    assert got.dtype == tdt and got.is_contiguous()  # NHWC out, no NCHW copy left
    _close(to_np(got), np.asarray(ref.astype(jnp.float32)), rel, f"conv2d {case}")


def test_conv2d_quantized_kernel():
    """An int8 QTensor conv kernel (K = 3*3*16 = 144: per channel) is
    dequantized per call, in bf16."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 10, 16)).astype(np.float32)
    wk = (rng.normal(size=(144, 8)) * 0.2).astype(np.float32)
    jp = {"c/kernel": jcore.quantize(_j(wk), bits=8, group_size=0)}
    tp = jax_to_torch_params(jp)
    ref = jlayers.conv2d(jp, "c", _j(x, jnp.bfloat16), kernel_hw=(3, 3), stride=2)
    got = tlayers.conv2d(tp, "c", _t(x, torch.bfloat16), kernel_hw=(3, 3), stride=2)
    _close(to_np(got), np.asarray(ref.astype(jnp.float32)), BF16_REL, "conv2d int8")


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_batch_norm_inference(kind):
    jdt, tdt, rel = _dtypes(kind)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    p = {"bn/scale": rng.normal(size=(6,)), "bn/bias": rng.normal(size=(6,)),
         "bn/mean": rng.normal(size=(6,)), "bn/var": rng.uniform(0.5, 2.0, size=(6,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    ref = jlayers.batch_norm_inference({k: _j(v) for k, v in p.items()}, "bn", _j(x, jdt))
    got = tlayers.batch_norm_inference({k: _t(v) for k, v in p.items()}, "bn", _t(x, tdt))
    assert got.dtype == tdt
    _close(to_np(got), np.asarray(ref.astype(jnp.float32)), rel, "batch_norm")


POOL_CASES = [("max", 3, 2, "SAME", 16), ("max", 3, 2, "SAME", 15), ("max", 2, 2, "VALID", 9),
              ("avg", 2, 2, "VALID", 8), ("avg", 3, 2, "SAME", 15)]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pools(kind, case):
    """max_pool pads SAME with -inf (odd row after); avg_pool sums in f32
    over window * window, padding counted as zeros."""
    op, window, stride, pad, n = case
    jdt, tdt, rel = _dtypes(kind)
    x = np.random.default_rng(5).normal(size=(2, n, n, 5)).astype(np.float32) - 3.0
    jf, tf = getattr(jlayers, f"{op}_pool"), getattr(tlayers, f"{op}_pool")
    ref = jf(_j(x, jdt), window, stride, pad)
    got = tf(_t(x, tdt), window, stride, pad)
    assert got.dtype == tdt
    _close(to_np(got), np.asarray(ref.astype(jnp.float32)), rel, f"{op}_pool {case}")


@pytest.mark.parametrize("name", ["relu", "gelu", "silu", "tanh", "sigmoid", "identity"])
def test_activation(name):
    """gelu is jax.nn.gelu's default tanh approximation."""
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    ref = jlayers.activation(name)(_j(x))
    got = tlayers.activation(name)(_t(x))
    _close(to_np(got), np.asarray(ref), F32_RTOL, name)
    with pytest.raises(ValueError):
        tlayers.activation("swish9")


# ---------------------------------------------------------------------- models
def _configs(arch, inputs, outputs, model_params):
    d = {"name": f"zoo_{arch}", "platform": "jax", "architecture": arch, "inputs": inputs,
         "outputs": outputs, "model_params": model_params}
    return JModelConfig.from_dict(d), TModelConfig.from_dict(d)


MLP = ("mlp", [{"name": "input", "shape": [-1, 16], "data_type": "FLOAT32"}],
       [{"name": "output", "shape": [-1, 10], "data_type": "FLOAT32"}],
       {"features": [32, 10], "activation": "gelu"})
BERT = ("bert", [{"name": "input_ids", "shape": [-1, 24], "data_type": "INT32"},
                 {"name": "attention_mask", "shape": [-1, 24], "data_type": "INT32"}],
        [{"name": "logits", "shape": [-1, 3], "data_type": "FLOAT32"}],
        {"vocab_size": 300, "dim": 128, "n_layers": 2, "n_heads": 4, "ffn_dim": 256,
         "max_len": 64, "num_labels": 3})
RESNET = ("resnet50", [{"name": "input", "shape": [-1, 32, 32, 3], "data_type": "FLOAT32"}],
          [{"name": "logits", "shape": [-1, 10], "data_type": "FLOAT32"}], {})


def _inputs(arch):
    rng = np.random.default_rng(7)
    if arch == "mlp":
        return {"input": rng.normal(size=(3, 16)).astype(np.float32)}
    if arch == "bert":
        mask = np.ones((3, 24), np.int32)
        mask[1, 15:] = 0
        mask[2, 5:] = 0
        return {"input_ids": rng.integers(0, 300, (3, 24)).astype(np.int32),
                "attention_mask": mask}
    return {"input": rng.normal(size=(3, 32, 32, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def zoo():
    """Each model's JAX config, port config and JAX-initialized params
    (built once: the JAX init compiles per shape)."""
    out = {}
    for spec in (MLP, BERT, RESNET):
        jcfg, tcfg = _configs(*spec)
        out[spec[0]] = (jcfg, tcfg, jax.jit(jget(jcfg).init)(jax.random.PRNGKey(0)))
    return out


# (arch, param dtype, weights, tolerance relative to the output's max |.|).
# f32 models hold F32_RTOL, int8 f32 too (the port's f32-x route: three
# exact bf16 pieces; measured at most 6.1e-7 on this seed); bf16 models a
# bf16 fraction of the range: measured 0.61% (bert bf16, pooled), 0.40%
# (bert int4, logits), 0.73% and 1.37% (resnet50, bf16 and int8: 16 bf16
# blocks; the codes are shared, so only bf16 rounding differs).
MODEL_CASES = [
    ("mlp", "f32", "none", F32_RTOL), ("mlp", "f32", "int8", F32_RTOL),
    ("mlp", "f32", "int4", F32_RTOL),
    ("bert", "f32", "none", F32_RTOL), ("bert", "bf16", "none", 2e-2),
    ("bert", "f32", "int8", F32_RTOL), ("bert", "bf16", "int4", 2e-2),
    ("resnet50", "bf16", "none", 5e-2), ("resnet50", "bf16", "int8", 5e-2),
]


def quantized_pair(jparams, bits, predicate):
    """Both packages' params for one quantization of `jparams`: the port's
    quantize_param_tree (codes and scales bitwise the JAX one's,
    test_torch_quant.py; the JAX quantize compiles once per weight shape,
    ~20 s for a ResNet-50) with the architecture's predicate, each QTensor
    handed to JAX from numpy."""
    tparams = tquantize_param_tree(jax_to_torch_params(jparams), bits=bits, group_size=128,
                                   predicate=predicate)
    jq = {}
    for k, v in tparams.items():
        if isinstance(v, TQTensor):
            jq[k] = jcore.QTensor(q=_j(to_np(v.q)), scale=_j(to_np(v.scale)), bits=v.bits,
                                  group_size=v.group_size, orig_shape=v.orig_shape)
        else:
            jq[k] = jparams[k]
    return jq, tparams


@pytest.mark.parametrize("arch,dtype,weights,rel", MODEL_CASES,
                         ids=[f"{a}-{d}-{w}" for a, d, w, _ in MODEL_CASES])
def test_model_matches_jax(zoo, arch, dtype, weights, rel):
    """The whole forward, JAX vs port, on the same weights and inputs
    (quantized with the architecture's predicate: `quantized_pair`). Top-1
    is equal on every row."""
    jcfg, tcfg, jparams = zoo[arch]
    jarch, tarch = jget(jcfg), tget(tcfg, "cpu")
    cast = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jparams = {k: v.astype(cast) for k, v in jparams.items()}
    if weights == "none":
        tparams = jax_to_torch_params(jparams)
    else:
        jparams, tparams = quantized_pair(jparams, {"int8": 8, "int4": 4}[weights],
                                          tarch.quant_predicate)
    x = _inputs(arch)
    ref = jax.jit(jarch.apply)(jparams, {k: _j(v) for k, v in x.items()})
    got = tarch.apply(tparams, {k: torch.from_numpy(v) for k, v in x.items()})
    assert set(got) == set(ref)
    for name in ref:
        _close(to_np(got[name]), np.asarray(ref[name].astype(jnp.float32)), rel,
               f"{arch} {dtype} {weights} {name}")
    out = jcfg.outputs[0].name
    assert (to_np(got[out]).argmax(-1) == np.asarray(ref[out]).argmax(-1)).all()


def test_image_input_nchw_accepted(zoo):
    """NCHW input (the reference's layout) is transposed to NHWC."""
    _, tcfg, jparams = zoo["resnet50"]
    tarch = tget(tcfg, "cpu")
    tparams = jax_to_torch_params(jparams)
    x = _inputs("resnet50")["input"]
    a = tarch.apply(tparams, {"input": torch.from_numpy(x)})["logits"]
    b = tarch.apply(tparams, {"input": torch.from_numpy(x.transpose(0, 3, 1, 2).copy())})["logits"]
    assert torch.equal(a, b)


def test_init_draws_from_generator():
    """`init` takes an explicit torch.Generator: the same seed gives the
    same params, another seed others; shapes and dtypes are the JAX
    package's."""
    jcfg, tcfg = _configs(*BERT)
    tarch = tget(tcfg, "cpu")
    a = tarch.init(torch.Generator().manual_seed(3))
    b = tarch.init(torch.Generator().manual_seed(3))
    c = tarch.init(torch.Generator().manual_seed(4))
    jshapes = jax.eval_shape(jget(jcfg).init, jax.random.PRNGKey(0))
    assert set(a) == set(jshapes)
    for k, v in jshapes.items():
        assert tuple(a[k].shape) == v.shape and a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["embed/word"], c["embed/word"])
