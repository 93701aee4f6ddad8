"""The device trace of a ``--trace 1`` run and the arithmetic on it.

``torch.profiler`` records the card's activity (kernels and copies) over
the measured window.  Its timestamps are put on the host's
``perf_counter_ns`` clock by two markers: at the window's open and close
the host reads its clock and at once launches a short ``torch.cuda._sleep``
kernel on an idle card, whose start in the trace is that reading plus a
launch delay of microseconds.  Spans recorded on the host then say what
the host was doing in each idle gap of the device.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
Interval = Tuple[int, int]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Interval], t0: int, t1: int) -> List[Interval]:
    return [(max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1]


def length_ns(intervals: Iterable[Interval]) -> int:
    return sum(e - s for s, e in union(intervals))


class DeviceTrace:
    """Context manager: the card's activity while open, as
    ``(name, start_ns, end_ns)`` on the host clock (:attr:`kernels`)."""

    def __init__(self):
        self.kernels: List[Tuple[str, int, int]] = []
        self._marks: List[int] = []

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self._marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark()
        return self

    def __exit__(self, *exc) -> None:
        self._mark()
        time.sleep(0.05)  # the profiler keeps only activity that ends inside its window
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        events = [e for e in self._prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
        marks = sorted(e.start_ns() for e in events if MARKER in e.name())
        if len(marks) < 2:
            raise RuntimeError(f"the device trace kept {len(marks)} of its 2 clock markers; "
                               f"{len(events)} device records in all")
        # first and last marker: the window's open and close
        offset = ((marks[0] - self._marks[0]) + (marks[-1] - self._marks[-1])) // 2
        self.kernels = [(e.name(), e.start_ns() - offset, e.start_ns() - offset + e.duration_ns())
                        for e in events if MARKER not in e.name()]


def busy(kernels, t0: int, t1: int) -> List[Interval]:
    return union(clip(((s, e) for _, s, e in kernels), t0, t1))


def breakdown(kernels, spans: Dict[str, List[Interval]], t0: int, t1: int) -> dict:
    """The device operations that took most time in ``[t0, t1]`` and the
    device's idle time by the innermost host span it fell in ("loop"
    outside every span), ten each, in seconds."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in kernels:
        if e > t0 and s < t1:
            by_name[name[:160]] += (min(e, t1) - max(s, t0)) / 1e9
    gaps, prev = [], t0
    for s, e in busy(kernels, t0, t1):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    sorted_spans = {n: sorted(iv) for n, iv in spans.items() if iv}
    starts = {n: [a for a, _ in iv] for n, iv in sorted_spans.items()}
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        mid, label, best = (s + e) // 2, "loop", None
        for n, iv in sorted_spans.items():
            i = bisect.bisect_right(starts[n], mid) - 1
            if i >= 0 and iv[i][1] >= mid and (best is None or iv[i][1] - iv[i][0] < best):
                label, best = n, iv[i][1] - iv[i][0]
        idle[label] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(idle)}
