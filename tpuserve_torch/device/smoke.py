"""Device smoke test: a hand-written CUDA elementwise-add kernel.

Reference counterpart: the `addVectors` CUDA kernel + `VectorAdd` host
wrapper (inference_engine/src/cuda_utils.cu:10-15, 59-150), ported to the
TPU as tpuserve/device/smoke.py::_add_kernel and back to CUDA here
(csrc/vector_add.cu). It proves that nvcc, the kernel library and the card
all work. A CPU tensor takes the plain version (`a + b`).
"""

from __future__ import annotations

import torch

launches = 0  # CUDA kernel launches (the plain version does not count)


def vector_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def vector_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a + b of two float32 1-D tensors of any length."""
    global launches
    if a.shape != b.shape or a.dim() != 1:
        raise ValueError("vector_add expects two 1-D tensors of equal length")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("vector_add expects float32 tensors")
    if not a.is_cuda:
        if b.is_cuda:
            raise ValueError("vector_add: a and b must be on one device")
        return vector_add_plain(a, b)
    if b.device != a.device:
        raise ValueError("vector_add: a and b must be on one device")
    from tpuserve_torch import kernels

    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    rc = kernels.lib().tpuserve_vector_add(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                           a.numel(), kernels.stream_of(a))
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
