"""Native (C++/OpenMP) host kernels, built on first use and loaded via
ctypes; numpy fallbacks when no compiler is available."""

from .build import get_scorer_lib, set_native_threads

__all__ = ["get_scorer_lib", "set_native_threads"]
