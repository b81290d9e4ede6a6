"""The native host runtime of the port (counterpart of
ctts_tpu/runtime/__init__.py): the C++ engine binding, built from this
directory's sources by make at first use."""

from ctts_tpu_torch.runtime.native import NativeEngine, native_available

__all__ = ["NativeEngine", "native_available"]
