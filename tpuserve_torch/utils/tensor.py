"""Named, typed, shaped tensors at the API boundary.

Reference counterpart: `inference::Tensor` (inference_engine/src/model.cpp:30-436,
include/model.h:93-126) — a CPU byte buffer plus an optional GPU buffer with
explicit toGPU/toCPU transfers.

Here a `Tensor` wraps a numpy array or a torch tensor without copying;
`numpy()` brings it to the host. There is no separate byte-buffer tier
(fixing the reference's ~5 copies per request, SURVEY.md §2c.8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import numpy as np

from tpuserve_torch.utils.dtypes import DataType, byte_size


@dataclass
class Tensor:
    """A named tensor. `data` may be a numpy array, a torch tensor, or None
    (metadata-only, e.g. declared outputs before inference)."""

    name: str
    dtype: DataType
    shape: Tuple[int, ...]
    data: Any = None

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)

    # ------------------------------------------------------------------
    @classmethod
    def from_numpy(cls, name: str, arr: np.ndarray) -> "Tensor":
        arr = np.asarray(arr)
        return cls(name=name, dtype=DataType.from_np(arr.dtype), shape=arr.shape, data=arr)

    @classmethod
    def from_list(cls, name: str, values, dtype: DataType, shape: Sequence[int]) -> "Tensor":
        """Build from a (possibly nested) list as delivered by the JSON API
        (reference: server/main.go:500-571 convertToFloat32Array)."""
        np_dt = dtype.np_dtype
        if np_dt is None:
            raise ValueError(f"dtype {dtype.value} has no numpy mapping")
        arr = np.asarray(values, dtype=np_dt).reshape([int(d) for d in shape])
        return cls(name=name, dtype=dtype, shape=arr.shape, data=arr)

    # ------------------------------------------------------------------
    @property
    def element_count(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return byte_size(self.dtype, self.shape)

    def numpy(self) -> np.ndarray:
        """Host-side view (device→host transfer if needed)."""
        if self.data is None:
            raise ValueError(f"tensor '{self.name}' has no data")
        data = self.data
        if hasattr(data, "detach"):  # torch tensor
            data = data.detach().cpu().numpy()
        return np.asarray(data)

    def tolist(self):
        arr = self.numpy()
        if arr.dtype.kind not in "OUS" and arr.dtype.itemsize < 4 and arr.dtype.kind == "f":
            arr = arr.astype(np.float32)  # bf16/fp16 are not JSON-native
        return arr.tolist()

    def validate_against(self, expected_shape: Sequence[int]) -> bool:
        """Shape check with -1 = dynamic dim (reference: model.cpp:779-789)."""
        if len(self.shape) != len(expected_shape):
            return False
        for got, exp in zip(self.shape, expected_shape):
            if int(exp) != -1 and got != int(exp):
                return False
        return True

    def __repr__(self) -> str:
        return f"Tensor({self.name!r}, {self.dtype.value}, shape={self.shape})"
