"""Versioned filesystem model repository.

Reference counterpart: `ModelRepository`
(inference_engine/src/model_repository.cpp) — scans `repo/<name>/<version>/`
two levels deep (:18-66), detects model type by marker file (:161-178), and
resolves the latest version by descending numeric sort (:45-53, 180-187).

Differences by design:
- `get_config` actually parses config.json (the reference's hardcodes IO
  names, model_repository.cpp:131-156 — SURVEY.md §2 row 9).
- Version resolution lives HERE only; the server asks the repository instead
  of re-implementing string sorts (fixes §2c.5's "10" < "9" divergence —
  numeric versions sort numerically, non-numeric fall back to lexicographic).
- Same live-rescan semantics: `scan()` re-walks the filesystem so `/models`
  reflects on-disk changes (≙ inference_bridge.cpp:456).
"""

from __future__ import annotations

import enum
import os
import threading
from typing import Dict, List, Optional

from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.utils.errors import ModelNotFoundError


class ModelType(enum.Enum):
    """Backend platforms. JAX (the model zoo, run by the port in PyTorch),
    LLM, ONNX and PyTorch (TorchScript) have backends in the port; the others
    are recognized (reference: model_repository.cpp:161-178 marker files)
    and reported, and rejected at load with a clear error."""

    UNKNOWN = "unknown"
    JAX = "jax"  # flax params under jax.jit
    LLM = "llm"  # quantized LLM with continuous batching
    ONNX = "onnx"
    TENSORFLOW = "tensorflow"
    TENSORRT = "tensorrt"
    PYTORCH = "pytorch"
    CUSTOM = "custom"

    @classmethod
    def from_platform(cls, platform: str) -> "ModelType":
        p = platform.strip().lower()
        if not p:
            return cls.UNKNOWN
        if p in ("jax", "flax", "xla"):
            return cls.JAX
        if p in ("llm", "llama", "transformer_llm"):
            return cls.LLM
        if "onnx" in p:
            return cls.ONNX
        if "tensorrt" in p or p == "plan":
            return cls.TENSORRT
        if "tensorflow" in p or p in ("tf", "savedmodel"):
            return cls.TENSORFLOW
        if "torch" in p or p == "pt":
            return cls.PYTORCH
        if p == "custom":
            return cls.CUSTOM
        return cls.UNKNOWN


# marker file -> type, checked in order (≙ model_repository.cpp:161-178)
_MARKERS = [
    ("model.safetensors", ModelType.JAX),
    ("params.msgpack", ModelType.JAX),
    ("checkpoint", ModelType.JAX),  # orbax checkpoint directory
    ("model.onnx", ModelType.ONNX),
    ("saved_model.pb", ModelType.TENSORFLOW),
    ("model.plan", ModelType.TENSORRT),
    ("model.pt", ModelType.PYTORCH),
]


def _version_sort_key(v: str):
    """Numeric versions order numerically; non-numeric sort after, lexically
    (reference: descending numeric with string fallback,
    model_repository.cpp:45-53)."""
    try:
        return (1, int(v), "")
    except ValueError:
        return (0, 0, v)


class ModelRepository:
    """Thread-safe scanner over `repository_path/<model>/<version>/`.

    When the native runtime (libtpuserve.so, native/src/repository.cpp)
    loads, the filesystem walk runs there (bindings/native.py); otherwise a
    pure-Python walk with the same semantics. TPUSERVE_NATIVE=0 keeps the
    Python walk, as in the JAX package.
    """

    def __init__(self, repository_path: str):
        self._path = os.path.abspath(repository_path)
        self._lock = threading.Lock()
        self._models: Dict[str, List[str]] = {}  # name -> versions (desc)
        self._native = None
        if os.environ.get("TPUSERVE_NATIVE", "1") != "0":
            try:
                from tpuserve_torch.bindings import native

                if native.available():
                    self._native = native.NativeRepository(self._path)
            except Exception:
                self._native = None
        self.scan()

    @property
    def uses_native(self) -> bool:
        return self._native is not None

    # ------------------------------------------------------------------
    @property
    def path(self) -> str:
        return self._path

    def scan(self) -> Dict[str, List[str]]:
        """Re-walk the repository. A model directory counts if at least one
        version subdirectory contains a recognized marker file or a
        config.json (≙ ScanRepository, model_repository.cpp:18-66)."""
        if self._native is not None:
            found = {k: list(v) for k, v in self._native.scan().items()}
            with self._lock:
                self._models = found
            return dict(found)
        found: Dict[str, List[str]] = {}
        if os.path.isdir(self._path):
            for name in sorted(os.listdir(self._path)):
                model_dir = os.path.join(self._path, name)
                if not os.path.isdir(model_dir):
                    continue
                versions = []
                for ver in os.listdir(model_dir):
                    vdir = os.path.join(model_dir, ver)
                    if os.path.isdir(vdir) and self._version_valid(vdir):
                        versions.append(ver)
                if versions:
                    versions.sort(key=_version_sort_key, reverse=True)
                    found[name] = versions
        with self._lock:
            self._models = found
        return dict(found)

    @staticmethod
    def _version_valid(vdir: str) -> bool:
        for marker, _ in _MARKERS:
            if os.path.exists(os.path.join(vdir, marker)):
                return True
        return os.path.exists(os.path.join(vdir, "config.json"))

    # ------------------------------------------------------------------
    def get_model_names(self, rescan: bool = True) -> List[str]:
        if rescan:
            self.scan()
        with self._lock:
            return sorted(self._models.keys())

    def has_model(self, name: str, version: Optional[str] = None) -> bool:
        with self._lock:
            if name not in self._models:
                has = False
            else:
                has = version is None or version in self._models[name]
        if not has:  # maybe added since last scan — live semantics
            self.scan()
            with self._lock:
                if name not in self._models:
                    return False
                return version is None or version in self._models[name]
        return True

    def get_versions(self, name: str) -> List[str]:
        self.scan()  # live semantics: new versions appear without restart
        with self._lock:
            if name not in self._models:
                raise ModelNotFoundError(f"model '{name}' not found in repository")
            return list(self._models[name])

    def get_latest_version(self, name: str) -> str:
        """Highest numeric version (≙ GetLatestVersion,
        model_repository.cpp:180-187)."""
        return self.get_versions(name)[0]

    def resolve_version(self, name: str, version: Optional[str]) -> str:
        """Empty/None version -> latest. The ONE place version resolution
        happens (the reference does it 4 ways — SURVEY.md §2c.5)."""
        if version:
            if not self.has_model(name, version):
                raise ModelNotFoundError(f"model '{name}' version '{version}' not found")
            return version
        return self.get_latest_version(name)

    def get_model_path(self, name: str, version: Optional[str] = None) -> str:
        version = self.resolve_version(name, version)
        return os.path.join(self._path, name, version)

    # ------------------------------------------------------------------
    def detect_model_type(self, name: str, version: Optional[str] = None) -> ModelType:
        vdir = self.get_model_path(name, version)
        cfg_platform = None
        cfg_path = os.path.join(vdir, "config.json")
        if os.path.exists(cfg_path):
            try:
                cfg = ModelConfig.from_file(cfg_path)
                if cfg.platform:
                    cfg_platform = ModelType.from_platform(cfg.platform)
            except Exception:
                cfg_platform = None
        if cfg_platform is not None and cfg_platform != ModelType.UNKNOWN:
            return cfg_platform
        for marker, mtype in _MARKERS:
            if os.path.exists(os.path.join(vdir, marker)):
                return mtype
        return ModelType.UNKNOWN

    def get_config(self, name: str, version: Optional[str] = None) -> ModelConfig:
        """Parse the model's config.json for real (contrast:
        model_repository.cpp:131-156 'Simplified parsing')."""
        version = self.resolve_version(name, version)
        vdir = os.path.join(self._path, name, version)
        cfg_path = os.path.join(vdir, "config.json")
        if os.path.exists(cfg_path):
            cfg = ModelConfig.from_file(cfg_path)
            cfg.version = version
        else:
            cfg = ModelConfig(name=name, version=version)
        if not cfg.platform:
            cfg.platform = self.detect_model_type(name, version).value
        return cfg

    def to_dict(self) -> Dict[str, List[str]]:
        self.scan()
        with self._lock:
            return {k: list(v) for k, v in self._models.items()}
