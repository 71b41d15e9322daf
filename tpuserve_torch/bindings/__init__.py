"""Bindings to the native runtime (native/): `native`, over ctypes."""
