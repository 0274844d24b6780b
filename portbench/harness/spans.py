"""Spans and counters that the pipelines record around their calls into
the program's layers.

With tracing off (``--trace 0``) a span is a bare ``with`` block: it adds
no synchronisation, so the end-to-end metrics are taken as the program
runs.  With tracing on, each span synchronises the card before it starts
and when it ends (so a layer's device work lands in its own span), is
named in the profiler's trace (``record_function``) and records its
seconds on the host clock."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Recorder:
    def __init__(self, traced: bool, sync=None):
        self.traced = traced
        self.sync = sync or (lambda: None)
        self.spans = defaultdict(list)     # name -> [seconds]
        self.counters = defaultdict(list)  # name -> [value]

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.traced:
            yield
            return
        self.sync()
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.spans[name].append(time.perf_counter() - t0)

    def count(self, name: str, value) -> None:
        self.counters[name].append(value)

    def clear(self) -> None:
        """Forget what set-up recorded: the metrics read the window's."""
        self.spans.clear()
        self.counters.clear()


def mean_ms(spans: dict, name: str) -> float | None:
    """Mean milliseconds of the window's spans of ``name`` (None: none)."""
    got = spans.get(name)
    return 1e3 * sum(got) / len(got) if got else None
