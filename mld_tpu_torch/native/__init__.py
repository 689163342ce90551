"""The C++ input pipeline (``loader.cc``), bound with ctypes.

``get_native_loader()`` builds and loads the library on demand and returns
None when no toolchain can build it; the data module then keeps the numpy
collator, whose batches are the same, and logs why.
"""
from .batch_loader import NativeBatchLoader, build_error, get_native_loader

__all__ = ["NativeBatchLoader", "build_error", "get_native_loader"]
