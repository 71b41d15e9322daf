"""Backend interface and registry (PyTorch port of tpuserve/engine/backend.py).

Reference counterpart: `ModelImpl`'s per-type dispatch switches
(model.cpp:514-540 Load, :575-600 Infer, :620-645 Unload). Backends are
classes in a registry keyed by `ModelType`. The port registers only the LLM
backend so far; every other model type loads as an UnsupportedBackend that
raises UnsupportedError until it is ported.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional, Type

from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.repository.repo import ModelType
from tpuserve_torch.utils.errors import UnsupportedError
from tpuserve_torch.utils.tensor import Tensor


class Backend(abc.ABC):
    """One loaded model instance's execution engine, on `device`."""

    def __init__(self, model_dir: str, config: ModelConfig, device="cuda"):
        self.model_dir = model_dir
        self.config = config
        self.device = device

    @abc.abstractmethod
    def load(self) -> None:
        """Materialize weights on the device."""

    @abc.abstractmethod
    def unload(self) -> None:
        """Release device memory."""

    @abc.abstractmethod
    def infer(self, inputs: List[Tensor]) -> List[Tensor]:
        """Synchronous inference on named tensors."""

    def warmup(self) -> None:
        """Optional: run once before the first request."""

    def memory_usage_bytes(self) -> int:
        return 0

    def metadata_extras(self) -> Dict:
        return {}


class UnsupportedBackend(Backend):
    """≙ the reference's stub backends returning 'not implemented'."""

    def __init__(self, model_dir: str, config: ModelConfig, kind: str, device="cuda"):
        super().__init__(model_dir, config, device)
        self.kind = kind

    def load(self) -> None:
        raise UnsupportedError(
            f"backend '{self.kind}' is not ported to tpuserve_torch yet; supported: llm")

    def unload(self) -> None:  # pragma: no cover
        pass

    def infer(self, inputs: List[Tensor]) -> List[Tensor]:  # pragma: no cover
        raise UnsupportedError(f"backend '{self.kind}' is not supported")


_REGISTRY: Dict[ModelType, Type[Backend]] = {}


def register_backend(mtype: ModelType):
    def deco(cls: Type[Backend]):
        _REGISTRY[mtype] = cls
        return cls

    return deco


def get_backend_class(mtype: ModelType) -> Optional[Type[Backend]]:
    _ensure_builtins()
    return _REGISTRY.get(mtype)


def create_backend(mtype: ModelType, model_dir: str, config: ModelConfig,
                   device="cuda") -> Backend:
    _ensure_builtins()
    cls = _REGISTRY.get(mtype)
    if cls is None:
        return UnsupportedBackend(model_dir, config, mtype.value, device)
    return cls(model_dir, config, device)


_LOADED = False


def _ensure_builtins() -> None:
    """Import built-in backends lazily to avoid import cycles."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from tpuserve_torch.engine import llm_backend  # noqa: F401
