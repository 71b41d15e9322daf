"""Shared helpers for the tests that hold tpuserve_torch against tpuserve.

Data crosses between the two packages as numpy arrays only: the JAX side is
taken to numpy here and handed to tpuserve_torch.interop.
"""

import json
import os

import numpy as np
import torch

from tpuserve.quant.core import QExperts as JQExperts
from tpuserve.quant.core import QTensor as JQTensor
from tpuserve_torch import interop

# A config on the kernel path that stays fast on the CPU: head_dim 128 (the
# decode kernels' width) and (n_kv_heads*head_dim)/2 % 128 == 0 (packed int4).
SMALL = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
             head_dim=128, ffn_dim=512)


def jax_tree_to_numpy(params) -> dict:
    """JAX param dict (arrays, QTensors and QExperts) -> the numpy form
    interop takes."""
    out = {}
    for name, v in params.items():
        if isinstance(v, (JQTensor, JQExperts)):
            out[name] = dict(q=np.asarray(v.q), scale=np.asarray(v.scale), bits=v.bits,
                             group_size=v.group_size, orig_shape=v.orig_shape,
                             act_bits=v.act_bits, act_fp8=v.act_fp8)
        else:
            out[name] = np.asarray(v)
    return out


def jax_to_torch_params(params, device="cpu") -> dict:
    return interop.params_from_numpy(jax_tree_to_numpy(params), device)


def jax_qt_to_torch(qt, device="cpu"):
    return jax_to_torch_params({"w": qt}, device)["w"]


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def numpy_weights(seed=0):
    """Float weights with a wide enough spread that greedy margins dwarf the
    two packages' rounding differences."""
    rng = np.random.default_rng(seed)
    d, f, v = SMALL["dim"], SMALL["ffn_dim"], SMALL["vocab_size"]
    qd = SMALL["n_heads"] * SMALL["head_dim"]
    kvd = SMALL["n_kv_heads"] * SMALL["head_dim"]

    def n(*shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    w = {"embed/weight": n(v, d, std=1.0),
         "final_norm/scale": np.ones((d,), np.float32),
         "lm_head/kernel": n(d, v, std=4.0 / np.sqrt(d))}
    for l in range(SMALL["n_layers"]):
        pre = f"layers.{l}"
        w[f"{pre}/attn_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/mlp_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/wq/kernel"] = n(d, qd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wk/kernel"] = n(d, kvd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wv/kernel"] = n(d, kvd, std=1.0 / np.sqrt(d))
        w[f"{pre}/wo/kernel"] = n(qd, d, std=1.0 / np.sqrt(qd))
        w[f"{pre}/w_gate/kernel"] = n(d, f, std=1.0 / np.sqrt(d))
        w[f"{pre}/w_up/kernel"] = n(d, f, std=1.0 / np.sqrt(d))
        w[f"{pre}/w_down/kernel"] = n(f, d, std=1.0 / np.sqrt(f))
    return w


def write_model(root, name, cfg, seed=0):
    """One version dir holding config.json and a model.safetensors written
    from a numpy seed. The spread of the weights makes greedy margins far
    larger than the two packages' rounding differences."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d, f, v = SMALL["dim"], SMALL["ffn_dim"], SMALL["vocab_size"]
    qd = SMALL["n_heads"] * SMALL["head_dim"]
    kvd = SMALL["n_kv_heads"] * SMALL["head_dim"]

    def n(*shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    # A bf16 model hands out bf16 logits, and with a Gaussian head the top
    # two of a step fall within one bf16 step of each other at ~1 step in
    # 10, where the packages' rounding differences decide the argmax. So
    # the head is the embedding under a permutation: the residual stream
    # carries the fed token e_t, whose logit for token perm^-1(t) is ~16
    # while the rest are ~N(0, 1) plus what the layers add. Greedy decoding
    # walks a token chain with margins of many bf16 steps.
    emb = n(v, d, std=1.0)
    perm = rng.permutation(v)
    w = {"embed/weight": emb, "final_norm/scale": np.ones((d,), np.float32),
         "lm_head/kernel": np.ascontiguousarray(emb[perm].T / np.sqrt(d))}
    for l in range(SMALL["n_layers"]):
        pre = f"layers.{l}"
        w[f"{pre}/attn_norm/scale"] = np.ones((d,), np.float32)
        w[f"{pre}/mlp_norm/scale"] = np.ones((d,), np.float32)
        for nm, shape in (("wq", (d, qd)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                          ("w_gate", (d, f)), ("w_up", (d, f))):
            w[f"{pre}/{nm}/kernel"] = n(*shape, std=1.0 / np.sqrt(d))
        w[f"{pre}/wo/kernel"] = n(qd, d, std=1.0 / np.sqrt(qd))
        w[f"{pre}/w_down/kernel"] = n(f, d, std=1.0 / np.sqrt(f))
    vdir = os.path.join(root, name, "1")
    os.makedirs(vdir)
    with open(os.path.join(vdir, "config.json"), "w") as fh:
        json.dump(cfg, fh)
    save_file(w, os.path.join(vdir, "model.safetensors"))
    return vdir
