"""Architecture registry for the graph backend (PyTorch port of
tpuserve/models/registry.py).

Each architecture is an (init, apply) pair over a flat param dict,
selected by the config's `architecture` field; checkpoints carry only the
weights. `apply` runs eagerly on the device its params lie on.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict

import torch

from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.utils.device import resolve_device
from tpuserve_torch.utils.errors import InvalidArgumentError


class Architecture(abc.ABC):
    """A servable model family. `device` is where `init` puts its params and
    `apply` its inputs ("cuda" unless the caller asks for the CPU)."""

    name: str = ""

    def __init__(self, config: ModelConfig, device="cuda"):
        self.config = config
        self.params_cfg = dict(config.model_params)
        self.device = resolve_device(device)

    @abc.abstractmethod
    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Random-init a flat param dict on `self.device`, drawn from
        `generator` (tests, fixtures and chip_smoke; the JAX PRNG cannot be
        reproduced, so parity tests carry JAX's weights across instead)."""

    @abc.abstractmethod
    def apply(self, params: Dict, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Forward pass: named inputs -> named outputs."""

    def quant_predicate(self, name: str, arr) -> bool:
        """Which params are weight-quantizable (2-D matmul weights)."""
        return arr.dim() == 2 and name.endswith("kernel")

    def _normal(self, generator: torch.Generator, shape, std: float,
                dtype=torch.bfloat16) -> torch.Tensor:
        """std * N(0, 1) of `shape`, drawn on the generator's device in f32."""
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x * std).to(dtype).to(self.device)


_REGISTRY: Dict[str, Callable[..., Architecture]] = {}


def register_architecture(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_architecture(config: ModelConfig, device="cuda") -> Architecture:
    _ensure_builtins()
    name = (config.architecture or "").lower()
    if not name:
        raise InvalidArgumentError(
            f"model '{config.name}' config has no 'architecture' field; "
            f"known: {sorted(_REGISTRY)}"
        )
    cls = _REGISTRY.get(name)
    if cls is None:
        raise InvalidArgumentError(
            f"unknown architecture '{name}'; known: {sorted(_REGISTRY)}"
        )
    return cls(config, device)


def known_architectures():
    _ensure_builtins()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_builtins() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from tpuserve_torch.models import bert, densenet, llama, mlp, resnet  # noqa: F401
