"""Error types for the serving engine.

The reference propagates errors as malloc'd C strings through every layer
(inference_bridge.h:18, `GetLastError` model.h:165). Single-process design
lets us use real exception types; the API layers map them to HTTP/gRPC codes.
"""

from __future__ import annotations


class TpuServeError(Exception):
    """Base class; `status` is the HTTP status the REST layer should emit."""

    status = 500


class ModelNotFoundError(TpuServeError):
    status = 404


class ModelNotLoadedError(TpuServeError):
    status = 400


class ModelAlreadyLoadedError(TpuServeError):
    status = 409


class InvalidArgumentError(TpuServeError):
    status = 400


class ValidationError(InvalidArgumentError):
    pass


class BackendError(TpuServeError):
    status = 500


class ResourceExhaustedError(TpuServeError):
    status = 429


class UnsupportedError(TpuServeError):
    status = 501
