"""Device smoke test: a hand-written CUDA elementwise-add kernel.

Reference counterpart: the `addVectors` CUDA kernel + `VectorAdd` host
wrapper (inference_engine/src/cuda_utils.cu:10-15, 59-150), ported to the
TPU as tpuserve/device/smoke.py::_add_kernel and back to CUDA here
(csrc/vector_add.cu). It proves that nvcc, the kernel library and the card
all work. A CPU tensor takes the plain version (`a + b`).
"""

from __future__ import annotations

import torch

# the dtypes the JAX vector_add adds with x64 off; the kernel's dtype code
# is the index
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int16, torch.int8,
          torch.uint8)
VECTOR, SCALAR = 0, 1  # the kernel's routes: 16-byte vectors after a scalar head, or scalars

launches = 0  # CUDA kernel launches (the plain version does not count)


def vector_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def route(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> int:
    """VECTOR when a, b and out share one alignment modulo 16 bytes, else SCALAR."""
    mis = a.data_ptr() % 16
    return VECTOR if b.data_ptr() % 16 == mis and out.data_ptr() % 16 == mis else SCALAR


def _out_like(a: torch.Tensor) -> torch.Tensor:
    """An empty tensor like `a` whose address has a's alignment modulo 16,
    so that an offset view such as a[1:] + b[1:] keeps the vector route."""
    shift = (a.data_ptr() % 16) // a.element_size()
    if shift == 0:
        return torch.empty_like(a)
    buf = torch.empty(a.numel() + 16 // a.element_size(), dtype=a.dtype, device=a.device)
    return buf[shift:shift + a.numel()]


def vector_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a + b of two 1-D tensors of any length and one dtype of
    DTYPES (integers wrap; a float sum is correctly rounded)."""
    global launches
    if a.shape != b.shape or a.dim() != 1:
        raise ValueError("vector_add expects two 1-D tensors of equal length")
    if a.dtype not in DTYPES or b.dtype not in DTYPES:
        names = ", ".join(str(d).replace("torch.", "") for d in DTYPES)
        raise ValueError(f"vector_add takes {names}; got {a.dtype} and {b.dtype}")
    if a.dtype != b.dtype:
        raise ValueError(f"vector_add: a and b must share one dtype, got {a.dtype} and {b.dtype}")
    if not a.is_cuda:
        if b.is_cuda:
            raise ValueError("vector_add: a and b must be on one device")
        return vector_add_plain(a, b)
    if b.device != a.device:
        raise ValueError("vector_add: a and b must be on one device")
    from tpuserve_torch import kernels

    a, b = a.contiguous(), b.contiguous()
    out = _out_like(a)
    rc = kernels.lib().tpuserve_vector_add(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                           a.numel(), DTYPES.index(a.dtype), route(a, b, out),
                                           kernels.stream_of(a))
    kernels.check(rc, "vector_add")
    launches += 1
    return out


def run_smoke_test(n: int = 1_000_000, device: str = "cuda") -> bool:
    """1M-element vector add with verification (reference:
    test/cuda_test.cpp:38-58 runs exactly this on the GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_smoke_test: no CUDA device (pass device='cpu' for the CPU)")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    a = torch.randn(n, generator=g, device=dev)
    b = torch.randn(n, generator=g, device=dev)
    out = vector_add(a, b)
    return bool(torch.allclose(out, a + b, atol=1e-5))
