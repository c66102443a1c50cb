"""Per-phase timing, optional ``torch.profiler`` traces, and device timing
helpers.

The reference's only observability is tqdm bar text and ``time.time()`` ETA
prints (``Train_SMT.py:302-307,345-349``); here every pipeline phase
(extract / score / merge / train-step) is timed explicitly, and a phase can
write a ``torch.profiler`` trace. ``sync_time`` and ``rep_probe`` time one
call on the device (port of ``deepmerge_tpu/utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


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


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase_timer(timings: Timings, name: str, trace_dir: str | None = None):
    """Time the phase into ``timings`` (also when it raises); with
    ``trace_dir``, record it with ``torch.profiler`` (the CPU, and the card
    where one is in use) and write a Chrome trace
    ``<trace_dir>/<name>.pt.trace.json``."""
    ctx = contextlib.nullcontext()
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        ctx = profile(activities=acts)
    t0 = time.perf_counter()
    try:
        with ctx as prof:
            yield
    finally:
        # record even when the phase raises — the wall-clock was consumed,
        # and error-path summaries should show where it went
        timings.add(name, time.perf_counter() - t0)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"{name}.pt.trace.json"))


def sync_time(fn, *args, iters: int = 3) -> float:
    """Host wall ms of one call of ``fn(*args)``, the device synchronized
    before and after (a warm-up call first): the time a caller waits,
    launch overhead included."""
    fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters * 1000


def rep_probe(make_body, *args, k: int = 16) -> float:
    """Per-call ms of ``make_body(i, *args)`` as the slope between K and 2K
    repetitions in one timed loop each, which cancels the fixed cost of
    the call and its synchronization. Eager PyTorch hoists nothing out of
    the loop, so the body need not depend on ``i``; it may."""

    def loop(reps):
        def run(*a):
            for i in range(reps):
                make_body(i, *a)
        return run

    return (sync_time(loop(2 * k), *args) - sync_time(loop(k), *args)) / k
