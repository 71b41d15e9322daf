"""DenseNet-121 (32x32, 10 classes) against the JAX package on the CPU,
in bf16 and int8, and the densenet_tpu repository entry through the port's
zoo backend. Weights from the JAX package's `init` (built once: it
compiles per shape, ~20 s), inputs from numpy with a seed; the JAX side
runs its Pallas quant-matmul in interpret mode. Tolerances stated at each
test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import _close, _configs, quantized_pair
from tests.torch_parity import jax_to_torch_params, to_np
from tpuserve.models import layers as jlayers
from tpuserve.models.registry import get_architecture as jget
from tpuserve.quant import core as jcore
from tpuserve_torch import fixtures
from tpuserve_torch.engine.jax_backend import JaxBackend
from tpuserve_torch.models.registry import get_architecture as tget
from tpuserve_torch.quant.core import QTensor
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.utils.tensor import Tensor

DENSENET = ("densenet121", [{"name": "data_0", "shape": [-1, 32, 32, 3], "data_type": "FLOAT32"}],
            [{"name": "logits", "shape": [-1, 10], "data_type": "FLOAT32"}], {})
# bf16 through 120 conv layers (measured on this seed: 0.55% bf16, 0 int8,
# of the logits' max |.|); the int8 codes are shared, so only bf16 rounding
# differs
DENSENET_REL = 5e-2


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
    monkeypatch.setattr(jlayers, "qmatmul",
                        lambda x, qt, use_pallas=None: jcore.qmatmul(x, qt, use_pallas=True))


@pytest.fixture(scope="module")
def densenet():
    jcfg, tcfg = _configs(*DENSENET)
    jparams = jax.jit(jget(jcfg).init)(jax.random.PRNGKey(0))
    x = np.random.default_rng(11).normal(size=(3, 32, 32, 3)).astype(np.float32)
    return jcfg, tcfg, jparams, x


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_densenet121_matches_jax(densenet, weights):
    """Stem (7x7/2 SAME: the odd row after), 3x3/2 SAME max-pool, dense
    blocks, transitions, the f32 spatial mean and the head (int8: on the
    quant-matmul; K 1024 in groups of 128) against the JAX forward; top-1
    equal on every row."""
    jcfg, tcfg, jparams, x = densenet
    jarch, tarch = jget(jcfg), tget(tcfg, "cpu")
    if weights == "bf16":
        tparams = jax_to_torch_params(jparams)
    else:
        jparams, tparams = quantized_pair(jparams, 8, tarch.quant_predicate)
        assert isinstance(tparams["head/kernel"], QTensor)
        assert tparams["head/kernel"].group_size == 128
    ref = np.asarray(jax.jit(jarch.apply)(jparams, {"data_0": jnp.asarray(x)})["logits"])
    got = to_np(tarch.apply(tparams, {"data_0": torch.from_numpy(x)})["logits"])
    _close(got, ref, DENSENET_REL, f"densenet121 {weights}")
    assert (got.argmax(-1) == ref.argmax(-1)).all()


def test_reference_layout_in_and_out(densenet):
    """NCHW input is transposed; a 4-D declared output gives the reference's
    [B, C, 1, 1] logits."""
    _, tcfg, jparams, x = densenet
    d = tcfg.to_dict()
    d["inputs"][0]["shape"] = [-1, 3, 32, 32]
    d["outputs"][0]["shape"] = [-1, 10, 1, 1]
    tarch = tget(ModelConfig.from_dict(d), "cpu")
    tparams = jax_to_torch_params(jparams)
    nchw = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    got = tarch.apply(tparams, {"data_0": nchw})["logits"]
    flat = tget(tcfg, "cpu").apply(tparams, {"data_0": torch.from_numpy(x)})["logits"]
    assert tuple(got.shape) == (3, 10, 1, 1)
    assert torch.equal(got[:, :, 0, 0], flat)


def test_densenet_tpu_entry_through_backend(tmp_path, densenet):
    """The densenet_tpu entry (its config and labels from
    create_image_model_repo_entry, cut here to 32x32 and 10 classes) with
    params.npz: loaded and int8-quantized by the zoo backend, a batch of 3
    padded to the bucket of 4, the padding cut off; equal to the
    architecture's forward of the same quantized params on the same rows."""
    _, tcfg, jparams, x = densenet
    vdir = fixtures.create_image_model_repo_entry(str(tmp_path), num_classes=10)
    with open(os.path.join(vdir, "config.json")) as fh:
        cfg = json.load(fh)
    cfg["inputs"][0]["shape"] = [-1, 32, 32, 3]
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    np.savez(os.path.join(vdir, "params.npz"),
             **{k: np.asarray(v.astype(jnp.float32)) for k, v in jparams.items()})
    config = ModelConfig.from_file(os.path.join(vdir, "config.json"))
    be = JaxBackend(vdir, config, device="cpu")
    be.load()
    assert isinstance(be.params["head/kernel"], QTensor) and be.params["head/kernel"].bits == 8
    assert be.memory_usage_bytes() > 0
    out = be.infer([Tensor.from_numpy("data_0", x)])
    assert [t.name for t in out] == ["logits"] and out[0].shape == (3, 10)
    padded = np.concatenate([x, np.zeros_like(x[:1])])
    want = to_np(tget(config, "cpu").apply(be.params, {"data_0": torch.from_numpy(padded)})
                 ["logits"])[:3]
    np.testing.assert_array_equal(out[0].numpy(), want)
    with open(os.path.join(vdir, "labels.txt")) as fh:
        assert fh.read().splitlines()[:2] == ["class_0", "class_1"]
