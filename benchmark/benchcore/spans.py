"""The harness's host spans around its calls into the program's layers.

``Spans.span(name)`` opens ``torch.profiler.record_function("bench.<name>")``,
which a traced window records beside the device operations, and adds the
span's host-clock seconds to ``totals[name]`` and one to ``counts[name]``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Spans:
    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextmanager
    def span(self, name: str):
        import torch

        with torch.profiler.record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
                self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def mean_ms(self, name: str) -> float | None:
        n = self.counts.get(name, 0)
        return 1e3 * self.totals[name] / n if n else None
