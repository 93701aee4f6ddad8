"""Spans and counters recorded from the benchmark's side, around the calls
into each layer of the program (the program records none of its own).

A span is a (start, end) pair of ``time.perf_counter_ns`` readings on the
host.  :meth:`Spans.wrap` replaces a bound method or a module function by
one that records its span and, if asked, hands its result to a callback,
which is how the benchmark keeps what the timed path produced for the
comparison that decides ``correct``.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple


class Spans:
    def __init__(self):
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.perf_counter_ns()))

    def wrap(self, obj, attr: str, name: str,
             keep: Optional[Callable] = None) -> None:
        """Record a span ``name`` around every call of ``obj.attr``; with
        ``keep``, pass each result to it."""
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            t0 = time.perf_counter_ns()
            out = fn(*args, **kw)
            self.spans[name].append((t0, time.perf_counter_ns()))
            if keep is not None:
                keep(out)
            return out

        setattr(obj, attr, timed)

    def within(self, name: str, t0: int, t1: int) -> List[Tuple[int, int]]:
        """The spans ``name`` that lie inside ``[t0, t1]``."""
        return [(a, b) for a, b in self.spans.get(name, []) if a >= t0 and b <= t1]
