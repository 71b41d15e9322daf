"""ctypes binding to the native runtime libtpuserve.so (PyTorch port of
tpuserve/bindings/native.py: the same classes and functions over the same
C API, native/include/tpuserve_c.h).

The library holds the repository scanner, the model lifecycle state
machine and the paged-KV page allocator, built from native/src/*.cpp:
`cmake -B native/build -G Ninja native && ninja -C native/build`
(scripts/build_native.sh), or `g++ -O2 -std=c++17 -shared -fPIC -Inative/include
native/src/*.cpp -o native/build/libtpuserve.so`. It is looked for at
TPUSERVE_NATIVE_LIB, then native/build/libtpuserve.so under the repository
root, then libtpuserve.so on the loader's path; the first that loads is kept
for the process (`reset()` forgets it). Where none loads, the callers
(repository/repo.py, serving/paged_kv.py) keep their Python paths, which
have the same semantics, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Dict, List, Optional

_LIB = None
_LIB_TRIED = False
_LOCK = threading.Lock()

_STATE_NAMES = {
    0: "UNAVAILABLE",
    1: "UNLOADED",
    2: "LOADING",
    3: "LOADED",
    4: "UNLOADING",
    5: "ERROR",
}


def _candidate_paths() -> List[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return [
        os.environ.get("TPUSERVE_NATIVE_LIB", ""),
        os.path.join(here, "native", "build", "libtpuserve.so"),
        "libtpuserve.so",
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    with _LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        for path in _candidate_paths():
            if not path:
                continue
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            _configure(lib)
            _LIB = lib
            break
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.TsRepositoryCreate.restype = c.c_void_p
    lib.TsRepositoryCreate.argtypes = [c.c_char_p]
    lib.TsRepositoryDestroy.argtypes = [c.c_void_p]
    lib.TsRepositoryScan.restype = c.c_int
    lib.TsRepositoryScan.argtypes = [c.c_void_p]
    lib.TsRepositoryListJson.restype = c.c_void_p  # manual free
    lib.TsRepositoryListJson.argtypes = [c.c_void_p]
    lib.TsRepositoryLatestVersion.restype = c.c_void_p
    lib.TsRepositoryLatestVersion.argtypes = [c.c_void_p, c.c_char_p]
    lib.TsRepositoryHasModel.restype = c.c_int
    lib.TsRepositoryHasModel.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
    lib.TsRepositoryModelType.restype = c.c_void_p
    lib.TsRepositoryModelType.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]

    lib.TsLifecycleCreate.restype = c.c_void_p
    lib.TsLifecycleDestroy.argtypes = [c.c_void_p]
    for fn in ("TsLifecycleBeginLoad", "TsLifecycleBeginUnload"):
        getattr(lib, fn).restype = c.c_int
        getattr(lib, fn).argtypes = [c.c_void_p, c.c_char_p, c.POINTER(c.c_int)]
    lib.TsLifecycleFinishLoad.restype = c.c_int
    lib.TsLifecycleFinishLoad.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.TsLifecycleFinishUnload.restype = c.c_int
    lib.TsLifecycleFinishUnload.argtypes = [c.c_void_p, c.c_char_p]
    lib.TsLifecycleGetState.restype = c.c_int
    lib.TsLifecycleGetState.argtypes = [c.c_void_p, c.c_char_p]
    lib.TsLifecycleRecordInference.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.TsLifecycleRecordError.argtypes = [c.c_void_p, c.c_char_p]
    lib.TsLifecycleStatsJson.restype = c.c_void_p
    lib.TsLifecycleStatsJson.argtypes = [c.c_void_p, c.c_char_p]

    lib.TsKvAllocatorCreate.restype = c.c_void_p
    lib.TsKvAllocatorCreate.argtypes = [c.c_int32, c.c_int32]
    lib.TsKvAllocatorDestroy.argtypes = [c.c_void_p]
    lib.TsKvAllocatorEnsure.restype = c.c_int
    lib.TsKvAllocatorEnsure.argtypes = [c.c_void_p, c.c_int64, c.c_int32]
    lib.TsKvAllocatorRelease.restype = c.c_int
    lib.TsKvAllocatorRelease.argtypes = [c.c_void_p, c.c_int64]
    lib.TsKvAllocatorPageTable.restype = c.c_int32
    lib.TsKvAllocatorPageTable.argtypes = [c.c_void_p, c.c_int64, c.POINTER(c.c_int32), c.c_int32]
    lib.TsKvAllocatorFreePages.restype = c.c_int32
    lib.TsKvAllocatorFreePages.argtypes = [c.c_void_p]
    lib.TsKvAllocatorTotalPages.restype = c.c_int32
    lib.TsKvAllocatorTotalPages.argtypes = [c.c_void_p]

    lib.TsFreeString.argtypes = [c.c_void_p]
    lib.TsVersion.restype = c.c_char_p


def reset() -> None:
    """Forget the loaded library (or the failed search), so that the next
    call searches the candidate paths again."""
    global _LIB, _LIB_TRIED
    with _LOCK:
        _LIB, _LIB_TRIED = None, False


def available() -> bool:
    return _load() is not None


def version() -> Optional[str]:
    lib = _load()
    return lib.TsVersion().decode() if lib else None


def _take_string(lib, ptr) -> Optional[str]:
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.TsFreeString(ptr)


class NativeRepository:
    """Native filesystem scanner (≙ reference ModelRepository via bridge)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libtpuserve.so not available")
        self._lib = lib
        self._h = lib.TsRepositoryCreate(path.encode())
        if not self._h:
            raise RuntimeError(f"failed to create native repository for {path}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.TsRepositoryDestroy(self._h)
            self._h = None

    def scan(self) -> Dict[str, List[str]]:
        self._lib.TsRepositoryScan(self._h)
        data = _take_string(self._lib, self._lib.TsRepositoryListJson(self._h))
        return json.loads(data) if data else {}

    def latest_version(self, model: str) -> Optional[str]:
        return _take_string(self._lib, self._lib.TsRepositoryLatestVersion(self._h, model.encode()))

    def has_model(self, model: str, version: Optional[str] = None) -> bool:
        v = version.encode() if version else None
        return bool(self._lib.TsRepositoryHasModel(self._h, model.encode(), v))

    def model_type(self, model: str, version: Optional[str] = None) -> str:
        v = version.encode() if version else None
        return _take_string(self._lib, self._lib.TsRepositoryModelType(self._h, model.encode(), v)) or "unknown"


class NativeLifecycle:
    """Native state machine + stats registry."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libtpuserve.so not available")
        self._lib = lib
        self._h = lib.TsLifecycleCreate()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.TsLifecycleDestroy(self._h)
            self._h = None

    def begin_load(self, key: str) -> tuple:
        err = ctypes.c_int(0)
        rc = self._lib.TsLifecycleBeginLoad(self._h, key.encode(), ctypes.byref(err))
        return rc == 0, _STATE_NAMES.get(err.value, "UNKNOWN")

    def finish_load(self, key: str, success: bool) -> bool:
        return self._lib.TsLifecycleFinishLoad(self._h, key.encode(), int(success)) == 0

    def begin_unload(self, key: str) -> tuple:
        err = ctypes.c_int(0)
        rc = self._lib.TsLifecycleBeginUnload(self._h, key.encode(), ctypes.byref(err))
        return rc == 0, _STATE_NAMES.get(err.value, "UNKNOWN")

    def finish_unload(self, key: str) -> bool:
        return self._lib.TsLifecycleFinishUnload(self._h, key.encode()) == 0

    def get_state(self, key: str) -> str:
        return _STATE_NAMES[self._lib.TsLifecycleGetState(self._h, key.encode())]

    def record_inference(self, key: str, duration_ns: int) -> None:
        self._lib.TsLifecycleRecordInference(self._h, key.encode(), duration_ns)

    def record_error(self, key: str) -> None:
        self._lib.TsLifecycleRecordError(self._h, key.encode())

    def stats(self, key: str) -> Dict:
        data = _take_string(self._lib, self._lib.TsLifecycleStatsJson(self._h, key.encode()))
        return json.loads(data) if data else {}


class NativeKvAllocator:
    """Paged KV bookkeeping (free list + per-sequence page chains)."""

    def __init__(self, num_pages: int, page_size: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("libtpuserve.so not available")
        self._lib = lib
        self._h = lib.TsKvAllocatorCreate(num_pages, page_size)
        if not self._h:
            raise ValueError("invalid allocator parameters")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.TsKvAllocatorDestroy(self._h)
            self._h = None

    def ensure(self, seq_id: int, num_tokens: int) -> bool:
        """Grow seq's chain to cover num_tokens; False = pages exhausted."""
        rc = self._lib.TsKvAllocatorEnsure(self._h, seq_id, num_tokens)
        if rc == 0:
            return True
        if rc == 4:  # TS_EXHAUSTED
            return False
        raise RuntimeError(f"kv allocator error {rc}")

    def release(self, seq_id: int) -> bool:
        return self._lib.TsKvAllocatorRelease(self._h, seq_id) == 0

    def page_table(self, seq_id: int) -> Optional[List[int]]:
        n = self._lib.TsKvAllocatorPageTable(self._h, seq_id, None, 0)
        if n < 0:
            return None
        buf = (ctypes.c_int32 * n)()
        self._lib.TsKvAllocatorPageTable(self._h, seq_id, buf, n)
        return list(buf)

    @property
    def free_pages(self) -> int:
        return self._lib.TsKvAllocatorFreePages(self._h)

    @property
    def total_pages(self) -> int:
        return self._lib.TsKvAllocatorTotalPages(self._h)
