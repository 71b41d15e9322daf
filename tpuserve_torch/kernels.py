"""Build and bind the port's CUDA kernels.

The sources under `tpuserve_torch/csrc/` are plain CUDA C++ with a C
interface. `build()` compiles each `.cu` file with its own `nvcc` process
(all started together) for `sm_90a`, links the objects into one shared
library and `lib()` loads it with ctypes. The build runs at first use, never
at import, into `build/tpuserve_torch/` at the repository root; the library
name carries a hash of the sources and flags, so an edited source is
rebuilt. Processes that start together (the ranks of a sharded model) take
turns: the check-and-build holds an exclusive lock on a file in the build
directory, so one of them compiles and the others find its library.

Every wrapper allocates its outputs with torch, launches on PyTorch's
current stream and raises through `check()` when the C function returns a
CUDA error (a refused launch never runs, so it must be caught here).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# the decode-attention kernels' instances are spread over several units
# (each head_dim and form), so that the parallel nvcc runs finish together
SOURCES = ("vector_add.cu", "quant_matmul.cu", "decode_attention_hopper.cu",
           "decode_attention_hopper_paged.cu", "decode_attention_hopper_paged_hd256.cu",
           "decode_attention_hopper_hd256.cu", "decode_attention_hopper_hd256_all.cu",
           "decode_attention_grouped_hopper.cu", "decode_attention_grouped_hopper_hd256.cu",
           "attention_probes.cu", "unpack_probes.cu")
HEADERS = ("common.cuh", "attention_common.cuh", "attention_hopper.cuh", "attention_core.cuh",
           "attention_grouped.cuh", "hopper.cuh")
# The longest unit keeps its priority and the others run niced, so that they
# fill the cores it leaves (on an 8-core H100 machine it took 112 s among
# ten others, the rest done by 83 s)
LONGEST = "quant_matmul.cu"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# exported C functions -> argument types (pointers and the stream as void*)
_SIGNATURES = {
    "tpuserve_vector_add": [_P, _P, _P, _LL, _I, _I, _P],
    "tpuserve_quant_matmul_bf16": [_P] * 6 + [_I] * 11 + [_P],
    "tpuserve_quant_matmul_a8": [_P] * 7 + [_I] * 10 + [_P],
    "tpuserve_quantize_rows": [_P] * 3 + [_I] * 3 + [_P, _I, _P],
    "tpuserve_stage_x": [_P] * 3 + [_I] * 3 + [_P],
    "tpuserve_split_x": [_P] * 3 + [_I] * 3 + [_P],
    "tpuserve_decode_attention_core": [_P] * 10 + [_I] * 19 + [_P],
    "tpuserve_decode_attention_grouped_hopper": [_P] * 9 + [_LL] * 3 + [_I] * 13 + [_P],
    "tpuserve_probe_colsum": [_P] * 3 + [_LL] * 2 + [_I] * 3 + [_P],
    "tpuserve_probe_dot_only": [_P] * 4 + [_I] * 4 + [_P],
    "tpuserve_probe_colsum_strided": [_P] * 4 + [_LL] * 4 + [_I] * 9 + [_P],
    "tpuserve_unpack_probe": [_P] * 3 + [_LL] + [_I] * 3 + [_LL, _I, _P],
}


@dataclasses.dataclass
class BuildInfo:
    path: str
    seconds: float       # 0.0 when the library was already built
    log: Dict[str, str]  # per source: nvcc's output (ptxas register/smem report)
    # per source: seconds from the start of the build to its nvcc's exit
    source_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpuserve_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _build_lock(out_dir: Path):
    """An exclusive lock across processes (flock on a file in out_dir)."""
    with open(out_dir / ".build.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build(force: bool = False) -> BuildInfo:
    """Compile (if needed) and return where the library is and what nvcc said."""
    global _info
    with _lock:
        if _info is not None and not force:
            return _info
        out_dir = BUILD_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        so = out_dir / f"libtpuserve_torch_{_digest()}.so"
        with _build_lock(out_dir):
            if so.exists() and not force:
                _info = BuildInfo(str(so), 0.0, {})
                return _info
            _info = _compile(out_dir, so)
            return _info


def _compile(out_dir: Path, so: Path) -> BuildInfo:
    """Every source through its own nvcc, all at once, then the link (run
    under the build lock)."""
    nvcc = _nvcc()
    nice = shutil.which("nice")
    t0 = time.monotonic()
    procs = []
    for name in SOURCES:
        obj = out_dir / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name), "-o", str(obj)]
        if nice and name != LONGEST:
            cmd = [nice, "-n", "5"] + cmd
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log: Dict[str, str] = {}
    done: Dict[str, float] = {}

    def drain(name, proc):   # each nvcc's output, and when it exited
        log[name] = proc.communicate()[0]
        done[name] = round(time.monotonic() - t0, 1)

    readers = [threading.Thread(target=drain, args=(name, proc)) for name, _, proc in procs]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    failed: List[str] = [name for name, _, proc in procs if proc.returncode != 0]
    if failed:
        detail = "\n".join(f"--- {n}\n{log[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    tmp = out_dir / f"{so.name}.tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp)]
        + [str(obj) for _, obj, _ in procs] + ["-ldl"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    return BuildInfo(str(so), time.monotonic() - t0, log, done)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        info = build()
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(info.path)
                for fn, argtypes in _SIGNATURES.items():
                    getattr(handle, fn).argtypes = argtypes
                    getattr(handle, fn).restype = ctypes.c_int
                handle.tpuserve_cuda_error_string.argtypes = [ctypes.c_int]
                handle.tpuserve_cuda_error_string.restype = ctypes.c_char_p
                _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        msg = lib().tpuserve_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def sm_count(device) -> int:
    """Streaming multiprocessors of the card (cached)."""
    import torch

    idx = torch.device(device).index or 0
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


_SMS: Dict[int, int] = {}


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as an integer handle."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
