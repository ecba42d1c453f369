"""Per-phase wall times of a fit (``StringGrouper.timings``)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator


@dataclass
class PhaseTimings:
    """Wall-clock seconds per pipeline phase of the most recent fit.

    ``seconds`` holds numbers only (float walls plus int counters such as
    ``match.rounds``)."""

    seconds: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def reset(self) -> None:
        self.seconds.clear()

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        body = ", ".join(
            f"{k}={v}" if isinstance(v, int) else f"{k}={v:.3f}s"
            for k, v in self.seconds.items()
        )
        return f"PhaseTimings({body})"
