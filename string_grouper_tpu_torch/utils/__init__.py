from .profiling import PhaseTimings

__all__ = ["PhaseTimings"]
