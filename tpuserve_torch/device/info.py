"""Card discovery and telemetry through torch.cuda.

Reference counterpart: inference_engine/src/cuda_utils.cu (namespace
inference::cuda) — IsCudaAvailable/GetDeviceCount/GetDeviceInfo/GetMemoryInfo
via the CUDA runtime, surfaced over REST at /cuda, /devices, /gpu/memory
(server/main.go:134-187). With no card present, the registry is empty.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class DeviceInfo:
    device_id: int
    platform: str          # "gpu"
    device_kind: str       # e.g. "NVIDIA H100 80GB HBM3"
    compute_capability: str
    multiprocessors: int
    total_memory_bytes: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def describe(self) -> str:
        """Human-readable one-liner (reference: cuda::GetDeviceInfo returns
        "<name> (Compute Capability X.Y)", cuda_utils.cu:41-57)."""
        return (f"Device {self.device_id}: {self.device_kind} "
                f"(Compute Capability {self.compute_capability})")


@dataclasses.dataclass
class MemoryInfo:
    device_id: int
    total_bytes: int
    used_bytes: int
    free_bytes: int

    @property
    def used_percent(self) -> float:
        return 100.0 * self.used_bytes / self.total_bytes if self.total_bytes else 0.0

    def to_dict(self) -> dict:
        mb = 1024.0 * 1024.0
        return {
            "device_id": self.device_id,
            "total_mb": round(self.total_bytes / mb, 2),
            "used_mb": round(self.used_bytes / mb, 2),
            "free_mb": round(self.free_bytes / mb, 2),
            "used_percent": round(self.used_percent, 2),
        }


def is_gpu_available() -> bool:
    """True when a CUDA card backs this process (reference:
    cuda::IsCudaAvailable, cuda_utils.cu:17-28)."""
    return torch.cuda.is_available()


def platform_name() -> str:
    return "gpu" if is_gpu_available() else "cpu"


def get_device_count() -> int:
    return torch.cuda.device_count() if is_gpu_available() else 0


def _check_id(device_id: int) -> None:
    n = get_device_count()
    if device_id < 0 or device_id >= n:
        raise IndexError(f"invalid device id {device_id} (have {n})")


def get_device_info(device_id: int) -> DeviceInfo:
    _check_id(device_id)
    props = torch.cuda.get_device_properties(device_id)
    return DeviceInfo(
        device_id=device_id,
        platform="gpu",
        device_kind=props.name,
        compute_capability=f"{props.major}.{props.minor}",
        multiprocessors=props.multi_processor_count,
        total_memory_bytes=props.total_memory,
    )


def get_memory_info(device_id: int) -> MemoryInfo:
    """Per-card memory telemetry (reference: cuda::GetMemoryInfo via
    cudaMemGetInfo, cuda_utils.cu:152-176)."""
    _check_id(device_id)
    free, total = torch.cuda.mem_get_info(device_id)
    return MemoryInfo(device_id=device_id, total_bytes=int(total),
                      used_bytes=int(total - free), free_bytes=int(free))


def all_device_infos() -> List[DeviceInfo]:
    return [get_device_info(i) for i in range(get_device_count())]


def all_memory_infos() -> List[MemoryInfo]:
    return [get_memory_info(i) for i in range(get_device_count())]
