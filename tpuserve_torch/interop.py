"""Carry weights and cache state into the port from numpy, and back.

The tests take the JAX package's parameters and caches to numpy (the
JAX -> numpy half) and hand them here, so the port never sees JAX. Byte
formats are shared (split-half int4 packing, head-major scales), so arrays
cross unchanged. The JAX package's stacked pipeline params
(stack_layer_params' output) cross alike and become a rank's stage block
(`stage_block_from_numpy`); `params_to_numpy` is the way back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tpuserve_torch.models.llama import KVCache
from tpuserve_torch.quant.core import QExperts, QTensor
from tpuserve_torch.serving.paged_kv import PagedKVCache
from tpuserve_torch.utils.device import resolve_device

_QT_KEYS = {"q", "scale", "bits", "group_size", "orig_shape"}


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """numpy array (including ml_dtypes bfloat16) -> torch tensor on device."""
    device = resolve_device(device)
    arr = np.array(arr, copy=True, order="C")  # own, writable, contiguous
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Mapping[str, object], device="cuda") -> Dict[str, object]:
    """Flat param dict of numpy arrays -> torch. A QTensor entry is a dict
    with q, scale, bits, group_size, orig_shape and optionally act_bits and
    act_fp8; one whose orig_shape has three dims or more (E, K, N; a stacked
    pipeline layer's L, K, N or L, E, K, N) is a QExperts."""
    out: Dict[str, object] = {}
    for name, v in tree.items():
        if isinstance(v, Mapping):
            missing = _QT_KEYS - set(v)
            if missing:
                raise ValueError(f"{name}: QTensor entry lacks {sorted(missing)}")
            cls = QExperts if len(v["orig_shape"]) >= 3 else QTensor
            out[name] = cls(
                q=tensor_from_numpy(v["q"], device),
                scale=tensor_from_numpy(v["scale"], device),
                bits=int(v["bits"]), group_size=int(v["group_size"]),
                orig_shape=tuple(int(d) for d in v["orig_shape"]),
                act_bits=int(v.get("act_bits", 0)), act_fp8=bool(v.get("act_fp8", False)))
        else:
            out[name] = tensor_from_numpy(v, device)
    return out


def kv_cache_from_numpy(k, v, k_scale: Optional[np.ndarray] = None,
                        v_scale: Optional[np.ndarray] = None, device="cuda") -> KVCache:
    """Cache state (k/v flat [n_layers, S, L, W or W/2] or 5D [n_layers, S,
    L, Hkv, hd], head-major scales [n_layers, S, Hkv, L] or None) -> KVCache
    of the same layout."""
    if np.asarray(k).ndim not in (4, 5):
        raise ValueError("a cache is [n_layers, S, L, W] or [n_layers, S, L, Hkv, hd]")
    return KVCache(
        k=tensor_from_numpy(k, device), v=tensor_from_numpy(v, device),
        k_scale=None if k_scale is None else tensor_from_numpy(k_scale, device),
        v_scale=None if v_scale is None else tensor_from_numpy(v_scale, device))


def paged_cache_from_numpy(k, v, k_scale: Optional[np.ndarray] = None,
                           v_scale: Optional[np.ndarray] = None, device="cuda") -> PagedKVCache:
    """Paged pool state -> PagedKVCache. k/v are flat pools [n_layers,
    n_pages, ps, W or W/2] or 5D [n_layers, n_pages, ps, Hkv, hd] (the same
    bytes: the head dims are merged); scale pools [n_layers, n_pages,
    pad8(Hkv), ps] f32 or None."""
    k, v = np.asarray(k), np.asarray(v)
    if k.ndim == 5:
        k, v = (a.reshape(a.shape[:3] + (-1,)) for a in (k, v))
    if k.ndim != 4:
        raise ValueError("paged pools are [n_layers, n_pages, ps, W] (or 5D)")
    return PagedKVCache(
        k=tensor_from_numpy(k, device), v=tensor_from_numpy(v, device),
        k_scale=None if k_scale is None else tensor_from_numpy(k_scale, device),
        v_scale=None if v_scale is None else tensor_from_numpy(v_scale, device))


def params_to_numpy(params: Mapping[str, object]) -> Dict[str, object]:
    """The port's param dict (tensors, QTensors, QExperts; flat or stacked)
    -> the numpy form params_from_numpy takes (bf16 as ml_dtypes' bfloat16
    where numpy has it, else float32)."""
    def arr(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            try:
                import ml_dtypes

                return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            except ImportError:
                return t.to(torch.float32).numpy()
        return t.numpy()

    out: Dict[str, object] = {}
    for name, v in params.items():
        if isinstance(v, (QTensor, QExperts)):
            out[name] = dict(q=arr(v.q), scale=arr(v.scale), bits=v.bits,
                             group_size=v.group_size, orig_shape=tuple(v.orig_shape),
                             act_bits=v.act_bits, act_fp8=v.act_fp8)
        else:
            out[name] = arr(v)
    return out


def stage_block_from_numpy(tree: Mapping[str, object], mesh, device="cuda") -> Dict[str, object]:
    """The JAX package's stacked pipeline params as numpy (the output of its
    stack_layer_params, tp-regrouped where the mesh has tp > 1) -> this
    rank's stage block on `mesh` (parallel/pipeline.place_pipeline_params:
    its layers, cut over tp, and the shared params whole)."""
    from tpuserve_torch.parallel.pipeline import place_pipeline_params

    return place_pipeline_params(params_from_numpy(tree, device), mesh)
