"""The `platform: jax` graph backend: checkpointed model-zoo architectures
run eagerly in PyTorch on the card (port of tpuserve/engine/jax_backend.py).

The module keeps the JAX package's name because configs say
`"platform": "jax"`; it imports no JAX. Reference counterpart: the ONNX
Runtime backend (model.cpp:825-1035 load, :1158-1328 infer).

- The architecture comes from the registry (models/registry.py); its
  `apply` runs the zoo's layers on the device, every quantized linear on
  the Hopper quant-matmul.
- Weights load from model.safetensors (read by the port's own reader,
  utils/checkpoint.py) or params.npz, move to the device and are quantized
  there (INT8/INT4 weight-only per config.quantization, with the
  architecture's quant_predicate). An orbax `checkpoint/` directory is
  refused: the port cannot read it.
- A dynamic batch dim is padded to the next power of two (capped at
  max_batch_size), the JAX backend's padded shapes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuserve_torch.engine.backend import Backend, register_backend
from tpuserve_torch.models.registry import get_architecture
from tpuserve_torch.quant.core import QExperts, QTensor, quantize_param_tree
from tpuserve_torch.repository.repo import ModelType
from tpuserve_torch.utils.checkpoint import read_safetensors
from tpuserve_torch.utils.device import resolve_device
from tpuserve_torch.utils.dtypes import DataType
from tpuserve_torch.utils.errors import BackendError
from tpuserve_torch.utils.tensor import Tensor

_QUANT_BITS = {"int8": 8, "int4": 4}


def load_checkpoint(model_dir: str) -> Dict[str, torch.Tensor]:
    """Flat param dict (CPU tensors) from the version directory:
    model.safetensors (primary) or params.npz. An orbax `checkpoint/`
    directory raises: the port has no orbax reader."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    npz = os.path.join(model_dir, "params.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            return {k: torch.from_numpy(np.array(data[k])) for k in data.files}
    if os.path.isdir(os.path.join(model_dir, "checkpoint")):
        raise BackendError(
            f"{model_dir}/checkpoint is an orbax checkpoint, which tpuserve_torch cannot "
            "read; save the weights as model.safetensors or params.npz")
    raise BackendError(
        f"no checkpoint found in {model_dir} (model.safetensors / params.npz / checkpoint/)"
    )


def param_bytes(params: Dict) -> int:
    return sum(p.nbytes if isinstance(p, (QTensor, QExperts)) else p.numel() * p.element_size()
               for p in params.values())


def _bucket(n: int, max_batch: int) -> int:
    """Next power-of-two bucket ≥ n (capped)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_batch, n)) if max_batch > 0 else b


def prepare_inputs(config, inputs: List[Tensor], device) -> Tuple[Dict[str, torch.Tensor],
                                                                   Optional[int]]:
    """Tensors -> a dict of device tensors; a dynamic batch dim is padded
    with zeros to a power-of-two bucket. Returns (batch, the original batch
    or None when nothing was padded)."""
    batch: Dict[str, torch.Tensor] = {}
    orig_batch: Optional[int] = None
    for t in inputs:
        decl = config.input_config(t.name)
        arr = t.numpy()
        if decl is not None and decl.shape and decl.shape[0] == -1:
            n = arr.shape[0]
            b = _bucket(n, config.max_batch_size)
            if b != n:
                arr = np.pad(arr, [(0, b - n)] + [(0, 0)] * (arr.ndim - 1))
                orig_batch = n
        batch[t.name] = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)
    return batch, orig_batch


def output_tensors(config, outputs: Dict[str, torch.Tensor], names: List[str],
                   orig_batch: Optional[int]) -> List[Tensor]:
    """Device outputs -> Tensors, the padding cut off, each cast to its
    declared dtype."""
    declared = {t.name: t for t in config.outputs}
    result: List[Tensor] = []
    for name in names:
        v = outputs[name]
        if orig_batch is not None:
            v = v[:orig_batch]
        if v.dtype == torch.bfloat16:
            v = v.float()
        arr = v.cpu().numpy()
        decl = declared.get(name)
        dtype = decl.data_type if decl else DataType.from_np(arr.dtype)
        if dtype.np_dtype is not None and arr.dtype != dtype.np_dtype:
            arr = arr.astype(dtype.np_dtype)
        result.append(Tensor(name=name, dtype=dtype, shape=arr.shape, data=arr))
    return result


def warmup_inputs(config, device) -> Dict[str, torch.Tensor]:
    """Zeros at the declared input shapes, batch bucket 1."""
    return {t.name: torch.from_numpy(np.zeros([1 if d == -1 else d for d in t.shape],
                                              t.data_type.np_dtype or np.float32)).to(device)
            for t in config.inputs}


@register_backend(ModelType.JAX)
class JaxBackend(Backend):
    def __init__(self, model_dir: str, config, device="cuda"):
        super().__init__(model_dir, config, device)
        self.params = None
        self._arch = None
        self._param_bytes = 0

    # ------------------------------------------------------------------
    def load(self) -> None:
        dev = resolve_device(self.device)
        self._arch = get_architecture(self.config, dev)
        raw = {k: v.to(dev) for k, v in load_checkpoint(self.model_dir).items()}

        qcfg = self.config.quantization
        bits = _QUANT_BITS.get(qcfg.weights)
        if bits is not None:
            raw = quantize_param_tree(
                raw,
                bits=bits,
                group_size=qcfg.group_size,
                predicate=self._arch.quant_predicate,
                act_bits=8 if qcfg.activations == "int8" else 0,
                act_fp8=qcfg.activations == "fp8",
            )
        self.params = raw
        self._param_bytes = param_bytes(raw)

    def warmup(self) -> None:
        """One forward at the config-declared shapes (batch bucket 1)."""
        if self._arch is None or not self.config.inputs:
            return
        with torch.inference_mode():
            self._arch.apply(self.params, warmup_inputs(self.config, self._arch.device))
        if self._arch.device.type == "cuda":
            torch.cuda.synchronize(self._arch.device)

    def unload(self) -> None:
        self.params = None
        self._arch = None

    def memory_usage_bytes(self) -> int:
        return self._param_bytes

    # ------------------------------------------------------------------
    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        if self._arch is None:
            raise BackendError("model not loaded")
        batch, padded = prepare_inputs(self.config, inputs, self._arch.device)
        with torch.inference_mode():
            outputs = self._arch.apply(self.params, batch)
        return output_tensors(self.config, outputs, list(outputs), padded)
