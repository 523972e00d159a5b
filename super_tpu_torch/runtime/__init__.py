"""Native host runtime: the C++ frame loader (loader.py)."""

from super_tpu_torch.runtime.loader import (  # noqa: F401
    NativeSequenceLoader,
    native_available,
    native_toolchain,
)
