"""Data-type registry.

Covers every dtype the reference's tensor layer declares
(reference: inference_engine/include/model.h:46-56 — FLOAT32, INT32, INT64,
UINT8, INT8, STRING, BOOL, FP16, UNKNOWN) plus the TPU-native types the
quantized serving path needs: BFLOAT16, FP8 (e4m3/e5m2), INT4, FLOAT64,
INT16, UINT16/32/64.

Unlike the reference — which defines 9 dtypes but only ever moves FLOAT32
end-to-end (SURVEY.md §2c.6) — every non-string dtype here has a working
numpy and JAX mapping and is usable on the wire and in kernels.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

try:  # ml_dtypes ships with jax
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
    _FP8_E4M3 = np.dtype(ml_dtypes.float8_e4m3fn)
    _FP8_E5M2 = np.dtype(ml_dtypes.float8_e5m2)
    _INT4 = np.dtype(ml_dtypes.int4)
except ImportError:  # pragma: no cover - ml_dtypes is a jax dependency
    _BF16 = _FP8_E4M3 = _FP8_E5M2 = _INT4 = None


class DataType(enum.Enum):
    """Wire/tensor data types. Values are the canonical string names used in
    config.json `data_type` fields and the REST/gRPC APIs."""

    INVALID = "INVALID"
    BOOL = "BOOL"
    UINT8 = "UINT8"
    UINT16 = "UINT16"
    UINT32 = "UINT32"
    UINT64 = "UINT64"
    INT4 = "INT4"
    INT8 = "INT8"
    INT16 = "INT16"
    INT32 = "INT32"
    INT64 = "INT64"
    FP8E4M3 = "FP8E4M3"
    FP8E5M2 = "FP8E5M2"
    FP16 = "FP16"
    BF16 = "BF16"
    FP32 = "FP32"
    FP64 = "FP64"
    STRING = "STRING"

    # ------------------------------------------------------------------
    @property
    def bits(self) -> int:
        return _BITS[self]

    @property
    def bytes(self) -> float:
        """Bytes per element (0.5 for INT4). STRING/INVALID -> 0."""
        return _BITS[self] / 8.0

    @property
    def np_dtype(self) -> Optional[np.dtype]:
        return _NP.get(self)

    @property
    def is_floating(self) -> bool:
        return self in _FLOATING

    @property
    def is_quantized(self) -> bool:
        return self in (DataType.INT4, DataType.INT8, DataType.FP8E4M3, DataType.FP8E5M2)

    # ------------------------------------------------------------------
    @classmethod
    def from_string(cls, s: str) -> "DataType":
        """Parse a config/API dtype string. Accepts the reference's spellings
        (FLOAT32, FP16, ... — server/main.go:816-837) and common aliases."""
        key = s.strip().upper().replace("TYPE_", "")
        alias = _ALIASES.get(key)
        if alias is not None:
            return alias
        try:
            return cls(key)
        except ValueError:
            return cls.INVALID

    @classmethod
    def from_np(cls, dt) -> "DataType":
        dt = np.dtype(dt)
        for k, v in _NP.items():
            if v is not None and v == dt:
                return k
        return cls.INVALID


_BITS = {
    DataType.INVALID: 0,
    DataType.BOOL: 8,
    DataType.UINT8: 8,
    DataType.UINT16: 16,
    DataType.UINT32: 32,
    DataType.UINT64: 64,
    DataType.INT4: 4,
    DataType.INT8: 8,
    DataType.INT16: 16,
    DataType.INT32: 32,
    DataType.INT64: 64,
    DataType.FP8E4M3: 8,
    DataType.FP8E5M2: 8,
    DataType.FP16: 16,
    DataType.BF16: 16,
    DataType.FP32: 32,
    DataType.FP64: 64,
    DataType.STRING: 0,
}

_NP = {
    DataType.BOOL: np.dtype(np.bool_),
    DataType.UINT8: np.dtype(np.uint8),
    DataType.UINT16: np.dtype(np.uint16),
    DataType.UINT32: np.dtype(np.uint32),
    DataType.UINT64: np.dtype(np.uint64),
    DataType.INT4: _INT4,
    DataType.INT8: np.dtype(np.int8),
    DataType.INT16: np.dtype(np.int16),
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FP8E4M3: _FP8_E4M3,
    DataType.FP8E5M2: _FP8_E5M2,
    DataType.FP16: np.dtype(np.float16),
    DataType.BF16: _BF16,
    DataType.FP32: np.dtype(np.float32),
    DataType.FP64: np.dtype(np.float64),
}

_FLOATING = {
    DataType.FP8E4M3,
    DataType.FP8E5M2,
    DataType.FP16,
    DataType.BF16,
    DataType.FP32,
    DataType.FP64,
}

_ALIASES = {
    "FLOAT32": DataType.FP32,
    "FLOAT": DataType.FP32,
    "F32": DataType.FP32,
    "FLOAT64": DataType.FP64,
    "DOUBLE": DataType.FP64,
    "F64": DataType.FP64,
    "FLOAT16": DataType.FP16,
    "HALF": DataType.FP16,
    "F16": DataType.FP16,
    "BFLOAT16": DataType.BF16,
    "BF16": DataType.BF16,
    "FP8": DataType.FP8E4M3,
    "FLOAT8_E4M3": DataType.FP8E4M3,
    "FLOAT8_E5M2": DataType.FP8E5M2,
    "INT4": DataType.INT4,
    "UNKNOWN": DataType.INVALID,
}


def byte_size(dtype: DataType, shape) -> int:
    """Total byte size of a tensor (reference: Tensor::ByteSize,
    model.cpp:59-91). INT4 packs two elements per byte, rounded up."""
    n = 1
    for d in shape:
        n *= int(d)
    return int(np.ceil(n * dtype.bytes))
