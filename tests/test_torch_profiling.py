"""The PyTorch port's profiling helpers (``utils/profiling.py``) on the CPU:
``phase_timer`` with and without a ``torch.profiler`` trace (the time
recorded when the phase raises too), ``sync_time`` and ``rep_probe``. The
times are host-clock readings of the CPU and are held only loosely (a
sleep of known length)."""

import json
import os
import time

import pytest
import torch

from deepmerge_tpu_torch.utils.profiling import (
    Timings,
    phase_timer,
    rep_probe,
    sync_time,
)


def test_phase_timer_records_and_traces(tmp_path):
    t = Timings()
    with phase_timer(t, "plain"):
        time.sleep(0.01)
    trace_dir = str(tmp_path / "traces")
    with phase_timer(t, "traced", trace_dir=trace_dir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.counts == {"plain": 1, "traced": 1}
    assert t.seconds["plain"] >= 0.01
    path = os.path.join(trace_dir, "traced.pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert "plain" in t.summary() and "traced" in t.summary()


def test_phase_timer_records_when_the_phase_raises(tmp_path):
    t = Timings()
    with pytest.raises(KeyError):
        with phase_timer(t, "boom", trace_dir=str(tmp_path)):
            time.sleep(0.005)
            raise KeyError("x")
    assert t.counts["boom"] == 1 and t.seconds["boom"] >= 0.005


def test_sync_time_and_rep_probe(monkeypatch):
    """On a fake clock that each call of the body advances by 2 ms and
    each reading of it by 2.5 ms (the overhead of a timed loop): ``sync_time`` reads the
    body plus overhead, ``rep_probe``'s slope the body alone."""
    from deepmerge_tpu_torch.utils import profiling

    clock, calls = [0.0], []

    def perf_counter():
        clock[0] += 0.0025
        return clock[0]

    def body(*args):
        calls.append(args)
        clock[0] += 0.002

    monkeypatch.setattr(profiling.time, "perf_counter", perf_counter)
    ms = sync_time(body, 1, 2, iters=4)
    assert len(calls) == 5 and calls[0] == (1, 2)  # a warm-up, then 4
    assert ms == pytest.approx(2.0 + 2.5 / 4)
    calls.clear()
    slope = rep_probe(lambda i, x: body(i, x), 7, k=4)
    # one warm-up of each loop, then 3 timed runs of 4 and of 8 bodies
    assert len(calls) == 4 * 4 + 4 * 8
    assert {c[1] for c in calls} == {7}
    assert [c[0] for c in calls[:4]] == [0, 1, 2, 3]
    assert slope == pytest.approx(2.0)
