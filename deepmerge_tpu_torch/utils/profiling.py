"""Per-phase wall-clock timing.

The reference's only observability is tqdm bar text and ``time.time()`` ETA
prints (``Train_SMT.py:302-307,345-349``); here every pipeline phase
(extract / score / merge / train-step) is timed explicitly. Device timing
of the port's kernels is CUDA events and ``torch.profiler`` (see
``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Timings:
    seconds: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] += dt
        self.counts[name] += 1

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}x" for k, v in self.seconds.items()
        )


@contextlib.contextmanager
def phase_timer(timings: Timings, name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        # record even when the phase raises — the wall-clock was consumed,
        # and error-path summaries should show where it went
        timings.add(name, time.perf_counter() - t0)
