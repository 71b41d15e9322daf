"""InferenceManager — async model lifecycle with a state machine (PyTorch
port of tpuserve/engine/manager.py).

Reference counterpart: `inference::InferenceManager`
(inference_manager.cpp/.h) — 4 worker threads, task queue + condvar,
ModelState machine, sync+async load/unload with callbacks, lock-free
inference (model shared_ptr copied under lock, Infer outside it), last-error
tracking, JSON status. The reference compiled this class but BYPASSED it on
the serving path (the C bridge rolled its own map — SURVEY.md §2 row 10);
here the manager IS the single serving path for REST, gRPC, and the native
bridge alike.

Deliberate fixes over the reference:
- Models are keyed by (name, version) everywhere — the bridge's name-only
  map meant one version at a time and IsModelLoaded ignoring its version
  argument (SURVEY.md §2c.1). `is_model_loaded(name)` with no version means
  "any version", matching the Go layer's observable behavior.
- State transition guards identical in spirit to inference_manager.cpp:291-316
  (can't load while LOADING/UNLOADING, can't unload while LOADING, ERROR
  permits reload).
"""

from __future__ import annotations

import enum
import json
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tpuserve_torch.engine.model import Model
from tpuserve_torch.repository.config import ModelConfig
from tpuserve_torch.repository.repo import ModelRepository
from tpuserve_torch.utils.errors import (
    ModelAlreadyLoadedError,
    ModelNotFoundError,
    ModelNotLoadedError,
    TpuServeError,
)
from tpuserve_torch.utils.tensor import Tensor


class ModelState(enum.Enum):
    """≙ ModelState (inference_manager.h:22-29)."""

    UNAVAILABLE = "UNAVAILABLE"
    UNLOADED = "UNLOADED"
    LOADING = "LOADING"
    LOADED = "LOADED"
    UNLOADING = "UNLOADING"
    ERROR = "ERROR"


_Key = Tuple[str, str]  # (name, version)


class InferenceManager:
    """`device` ("cuda" unless the caller asks for the CPU) is where every
    model this manager loads runs; there is no fallback to the CPU."""

    def __init__(self, repository_path: str, num_workers: int = 4, device="cuda"):
        from tpuserve_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        self.repository = ModelRepository(repository_path)
        self._lock = threading.RLock()
        self._models: Dict[_Key, Model] = {}
        self._states: Dict[_Key, ModelState] = {}
        self._last_error: Optional[str] = None
        self._tasks: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._workers: List[threading.Thread] = []
        self._shutdown = False
        for i in range(num_workers):
            t = threading.Thread(target=self._worker, name=f"tpuserve-torch-worker-{i}",
                                 daemon=True)
            t.start()
            self._workers.append(t)

    # ------------------------------------------------------------------ workers
    def _worker(self) -> None:
        """≙ WorkerThreadFunc (inference_manager.cpp:119-177)."""
        while True:
            task = self._tasks.get()
            if task is None:
                return
            try:
                task()
            except Exception:  # task functions record their own errors
                pass

    def shutdown(self) -> None:
        """Join workers and unload everything (≙ inference_manager.cpp:91-114)."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        for _ in self._workers:
            self._tasks.put(None)
        for t in self._workers:
            t.join(timeout=30)
        with self._lock:
            keys = list(self._models.keys())
        for key in keys:
            try:
                self._do_unload(key)
            except TpuServeError:
                pass

    # ------------------------------------------------------------------ helpers
    def _resolve(self, name: str, version: Optional[str]) -> _Key:
        ver = self.repository.resolve_version(name, version or None)
        return (name, ver)

    def _set_error(self, msg: str) -> None:
        with self._lock:
            self._last_error = msg

    @property
    def last_error(self) -> Optional[str]:
        with self._lock:
            return self._last_error

    # ------------------------------------------------------------------ state
    def get_model_state(self, name: str, version: Optional[str] = None) -> ModelState:
        try:
            key = self._resolve(name, version)
        except ModelNotFoundError:
            return ModelState.UNAVAILABLE
        with self._lock:
            return self._states.get(key, ModelState.UNLOADED)

    def is_model_loaded(self, name: str, version: Optional[str] = None) -> bool:
        with self._lock:
            if version:
                return self._states.get((name, version)) == ModelState.LOADED
            return any(
                k[0] == name and st == ModelState.LOADED for k, st in self._states.items()
            )

    def list_models(self) -> List[Dict]:
        """Repository contents with live states (live-rescan semantics,
        ≙ InferenceListModels -> ScanRepository, inference_bridge.cpp:456)."""
        out = []
        for name, versions in sorted(self.repository.to_dict().items()):
            for ver in versions:
                with self._lock:
                    state = self._states.get((name, ver), ModelState.UNLOADED)
                out.append({"name": name, "version": ver, "state": state.value})
        return out

    def loaded_models(self) -> List[Model]:
        with self._lock:
            return [
                m
                for (k, m) in self._models.items()
                if self._states.get(k) == ModelState.LOADED
            ]

    # ------------------------------------------------------------------ load
    def load_model(self, name: str, version: Optional[str] = None) -> Model:
        """Synchronous load (≙ LoadModel, inference_manager.cpp:218-231)."""
        key = self._begin_load(name, version)
        return self._do_load(key)

    def load_model_async(
        self, name: str, version: Optional[str] = None, callback: Optional[Callable] = None
    ) -> Tuple[str, str]:
        """Queue a load; callback(success: bool, error: Optional[str])
        (≙ LoadModelAsync, inference_manager.cpp:241-273)."""
        key = self._begin_load(name, version)

        def task():
            try:
                self._do_load(key)
                if callback:
                    callback(True, None)
            except Exception as e:
                if callback:
                    callback(False, str(e))

        self._tasks.put(task)
        return key

    def _begin_load(self, name: str, version: Optional[str]) -> _Key:
        key = self._resolve(name, version)  # raises ModelNotFoundError
        with self._lock:
            state = self._states.get(key, ModelState.UNLOADED)
            if state == ModelState.LOADED:
                raise ModelAlreadyLoadedError(f"Model {key[0]}:{key[1]} already loaded")
            if state in (ModelState.LOADING, ModelState.UNLOADING):
                raise TpuServeError(f"Model {key[0]}:{key[1]} is busy ({state.value})")
            self._states[key] = ModelState.LOADING
        return key

    def _do_load(self, key: _Key) -> Model:
        """≙ LoadModelInternal (inference_manager.cpp:283-390)."""
        name, version = key
        try:
            model_dir = self.repository.get_model_path(name, version)
            mtype = self.repository.detect_model_type(name, version)
            config = self.repository.get_config(name, version)
            model = Model(model_dir, mtype, config, self.device)
            model.load()
        except Exception as e:
            self._set_error(str(e))
            with self._lock:
                self._states[key] = ModelState.ERROR
            raise
        with self._lock:
            self._models[key] = model
            self._states[key] = ModelState.LOADED
        return model

    # ------------------------------------------------------------------ unload
    def unload_model(self, name: str, version: Optional[str] = None) -> None:
        key = self._begin_unload(name, version)
        self._do_unload(key)

    def unload_model_async(
        self, name: str, version: Optional[str] = None, callback: Optional[Callable] = None
    ) -> Tuple[str, str]:
        key = self._begin_unload(name, version)

        def task():
            try:
                self._do_unload(key)
                if callback:
                    callback(True, None)
            except Exception as e:
                if callback:
                    callback(False, str(e))

        self._tasks.put(task)
        return key

    def _begin_unload(self, name: str, version: Optional[str]) -> _Key:
        with self._lock:
            key = self._find_loaded_key(name, version)
            state = self._states.get(key, ModelState.UNLOADED)
            if state != ModelState.LOADED:
                if state in (ModelState.LOADING, ModelState.UNLOADING):
                    raise TpuServeError(f"Model {key[0]}:{key[1]} is busy ({state.value})")
                raise ModelNotLoadedError(f"Model {name} is not loaded")
            self._states[key] = ModelState.UNLOADING
        return key

    def _find_loaded_key(self, name: str, version: Optional[str]) -> _Key:
        """Empty version targets the loaded version of `name` (there may be
        several; pick highest) — fixing the reference's quirk 4 where the
        check and the unload used different versions (SURVEY.md §2c.4)."""
        if version:
            return (name, version)
        candidates = [
            k for k, st in self._states.items() if k[0] == name and st == ModelState.LOADED
        ]
        if not candidates:
            return (name, "")
        # numeric-desc like the repository tier (version "10" beats "9";
        # a plain string sort would pick "9" — reference quirk SURVEY §2c.5)
        from tpuserve_torch.repository.repo import _version_sort_key

        return sorted(candidates, key=lambda k: _version_sort_key(k[1]), reverse=True)[0]

    def _do_unload(self, key: _Key) -> None:
        with self._lock:
            model = self._models.pop(key, None)
        try:
            if model is not None:
                model.unload()
        finally:
            with self._lock:
                self._states[key] = ModelState.UNLOADED

    # ------------------------------------------------------------------ infer
    def get_model(self, name: str, version: Optional[str] = None) -> Model:
        with self._lock:
            key = self._find_loaded_key(name, version)
            model = self._models.get(key)
            if model is None or self._states.get(key) != ModelState.LOADED:
                raise ModelNotLoadedError(f"Model {name} is not loaded")
            return model

    def run_inference(
        self, name: str, inputs: List[Tensor], version: Optional[str] = None
    ) -> List[Tensor]:
        """Model reference grabbed under the lock, inference outside it —
        concurrent inference is lock-free (≙ RunInference,
        inference_manager.cpp:674-707)."""
        model = self.get_model(name, version)
        return model.infer(inputs)

    # ------------------------------------------------------------------ status
    def get_model_status(self, name: str, version: Optional[str] = None) -> Dict:
        """Structured status (the reference hand-rolls JSON with manual
        escaping, inference_manager.cpp:580-628; we return a dict)."""
        try:
            key = self._resolve(name, version)
        except ModelNotFoundError:
            return {"name": name, "version": version or "", "state": ModelState.UNAVAILABLE.value}
        with self._lock:
            state = self._states.get(key, ModelState.UNLOADED)
            model = self._models.get(key)
        status = {"name": key[0], "version": key[1], "state": state.value}
        if model is not None and state == ModelState.LOADED:
            status["metadata"] = model.metadata().to_dict()
            status["stats"] = model.get_stats()
        if state == ModelState.ERROR and self.last_error:
            status["error"] = self.last_error
        return status

    def status_json(self) -> str:
        all_status = [
            self.get_model_status(m["name"], m["version"]) for m in self.list_models()
        ]
        return json.dumps({"models": all_status})
