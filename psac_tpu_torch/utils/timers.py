"""The port's tracer: named spans and counters, recorded where the work
runs (grown from ``psac_tpu/utils/timers.py``'s ``SectionTimer``).

``call(name, device)`` opens the root span of one public call
(``encode_and_shard``, ``construct_device``,
``construct_suffix_tree_device``, ``DeviceSuffixArray.materialize``,
``DESA.bulk_locate``, ``build_gsa_device``, ``build_gsa_from_file``,
``construct_gst_device``), ``span(name, device, **attrs)`` one of its phases,
and ``count(name, value)`` adds to a counter of the innermost open span
(``current()`` is None where none is open, so a count that costs a
reduction is made only then);
``readback()`` counts one device-to-host read that waits for the card.
Names are ``psac.<layer>.<phase>``.  A record holds its name, an id, its
parent's and its root's ids, the thread and the mesh shard (None off a
mesh's worker threads), the host start and end (``perf_counter_ns``), the
attributes and the counters, and for a span whose ``device`` is a CUDA
device its device milliseconds: two CUDA events recorded on that device's
current stream at entry and exit.  The events are read only after a
readback the program makes anyway (``readback()``), or when the records
are taken (``records()``), so a span adds no synchronisation.

The tracer is on for every span while ``torch.profiler`` records, and for
the spans of every public call while ``PSAC_TIMER`` is set (read at each
call, as the JAX package reads it): a phase span is on where a span is
open in its thread.  Off, ``span`` and ``call`` return one shared null
context and ``count`` returns at once.  While the profiler records, each
span also opens a FUNCTION-scope record function of its name, which puts
it on the profiler's host timeline, on the clock of the device events,
and not on the device's timeline.  ``Mesh.run`` hands the caller's open
span to its worker threads (``adopt``), so a shard's spans nest under the
caller's and carry the shard.

Records stay in memory, the newest ``MAX_RECORDS``: ``records()`` takes
them, ``clear()`` drops them, and ``totals(recs, roots, last)`` sums the
spans and counters of the last calls.

``SectionTimer`` is the ``PSAC_TIMER=1`` exporter of a build's sections,
``[timer] [label] name: ms`` on stderr as the JAX package prints them:
each section a span from one ``end_section`` to the next, its ms the
device ms where it ran on a card (the host's elsewhere).  A line is
printed once its section's events have completed, at the latest at
``summary()``, which waits for them and prints the totals by name.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import threading
import time
from collections import deque

import torch

#: the records kept: a traced benchmark window makes some 10^4
MAX_RECORDS = 1 << 17

_profiling = torch._C._autograd._profiler_enabled
_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_ids = itertools.count(1)
_lock = threading.Lock()
_store: deque = deque(maxlen=MAX_RECORDS)
_pending: list = []  # closed spans whose device events are not read yet


class _Thread(threading.local):
    def __init__(self):
        self.stack = []    # open spans, innermost last
        self.shard = None


_tls = _Thread()


def timers_enabled() -> bool:
    """Whether ``PSAC_TIMER`` is set (read at each call)."""
    return os.environ.get("PSAC_TIMER", "0") not in ("", "0", "false")


class _Off:
    """The shared null span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class Span:
    """One span: a context manager, and its record once closed."""

    __slots__ = ("name", "attrs", "counts", "id", "parent", "root", "thread",
                 "shard", "t0", "t1", "device_ms", "_dev", "_ev", "_rf")

    def __init__(self, name: str, device=None, attrs=None):
        self.name = name
        self.attrs = attrs or {}
        self.counts = {}
        self.device_ms = None
        self._dev = None
        if device is not None:
            dev = torch.device(device)
            if dev.type == "cuda":
                self._dev = dev
        self._ev = self._rf = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def ms(self) -> float | None:
        """Device ms where the span ran on a card, else host ms; None
        while its events are unread."""
        return self.host_ms if self._dev is None else self.device_ms

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a readback's counts)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _tls.stack
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent else None
        self.root = parent.root if parent else self.id
        self.thread = threading.current_thread().name
        self.shard = _tls.shard
        if _RecordFunction is not None and _profiling():
            self._rf = _RecordFunction(self.name)
            self._rf.__enter__()
        if self._dev is not None:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record(torch.cuda.current_stream(self._dev))
        self.t0 = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        """Close the span and keep its record; spans left open inside it
        (an exception's, a section timer's) are dropped first."""
        stack = _tls.stack
        if not any(s is self for s in stack):
            return  # dropped by an enclosing span
        while stack[-1] is not self:
            stack.pop()._drop()
        stack.pop()
        self.t1 = time.perf_counter_ns()
        if self._ev is not None:
            self._ev[1].record(torch.cuda.current_stream(self._dev))
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        with _lock:
            _store.append(self)
            if self._ev is not None:
                _pending.append(self)

    def _drop(self) -> None:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._ev = None


def span(name: str, device=None, **attrs):
    """A phase of a public call, timed on ``device``'s stream when that is
    a CUDA device; on where a span is open in this thread or the profiler
    records."""
    if not (_tls.stack or _profiling()):
        return OFF
    return Span(name, device, attrs)


def call(name: str, device=None, **attrs):
    """The root span of a public call; on while the profiler records or
    ``PSAC_TIMER`` is set (and inside another open span)."""
    if not (_tls.stack or _profiling() or timers_enabled()):
        return OFF
    return Span(name, device, attrs)


def count(name: str, value=1) -> None:
    """Add ``value`` to counter ``name`` of this thread's innermost open
    span.  A 0-d tensor (a count made on the card) is added on its device
    and read only when the records are taken, so counting adds no
    readback."""
    stack = _tls.stack
    if not stack:
        return
    with _lock:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + value


def readback(n: int = 1) -> None:
    """Count ``n`` device-to-host reads that waited for the card, and read
    the events they finished."""
    count("readbacks", n)
    if _pending:
        _settle(False)


def _settle(wait: bool) -> None:
    """Read the device ms of the closed spans whose end event has
    completed (``wait``: of all of them, waiting for each)."""
    with _lock:
        keep = []
        for s in _pending:
            start, end = s._ev
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append(s)
                continue
            s.device_ms = start.elapsed_time(end)
            s._ev = None
        _pending[:] = keep


def records() -> list:
    """The kept records, oldest first, their device ms and counts read."""
    _settle(True)
    with _lock:
        recs = list(_store)
        for r in recs:
            for k, v in r.counts.items():
                if isinstance(v, torch.Tensor):
                    r.counts[k] = int(v)
    return recs


def clear() -> None:
    with _lock:
        _store.clear()
        _pending.clear()


def current():
    """This thread's innermost open span (None: none), for ``adopt``."""
    stack = _tls.stack
    return stack[-1] if stack else None


class _Adopted:
    __slots__ = ("parent", "shard", "saved")

    def __init__(self, parent, shard):
        self.parent, self.shard = parent, shard

    def __enter__(self):
        self.saved = (_tls.stack, _tls.shard)
        _tls.stack, _tls.shard = [self.parent], self.shard
        return self

    def __exit__(self, *exc):
        for s in reversed(_tls.stack[1:]):
            s._drop()
        _tls.stack, _tls.shard = self.saved
        return False


def adopt(parent, shard: int):
    """In a mesh's worker thread: the spans opened inside nest under
    ``parent``, a span of the thread that handed the work over (None: the
    tracer stays off), and carry ``shard``."""
    return OFF if parent is None else _Adopted(parent, shard)


@dataclasses.dataclass
class Totals:
    """The spans and counters of some public calls, summed by name."""

    calls: int
    host_ms: dict
    device_ms: dict
    counts: dict
    on_device: bool   # every call's root span carries device time

    def total(self, name: str, clock: str) -> float | None:
        """The ms of the spans ``name`` on the ``host`` or ``device`` clock
        (0 where none ran); None without calls, or for the device clock of
        calls that carry no device time."""
        if not self.calls or (clock == "device" and not self.on_device):
            return None
        return (self.device_ms if clock == "device" else
                self.host_ms).get(name, 0.0)

    def count(self, name: str) -> int | None:
        return self.counts.get(name, 0) if self.calls else None


def totals(recs, roots, last: int | None = None) -> Totals:
    """Sum the records of the last ``last`` calls (all: None) of each root
    span named in ``roots`` (a name, or several)."""
    names = {roots} if isinstance(roots, str) else set(roots)
    picked = []
    for name in names:
        of = [r for r in recs if r.name == name and r.id == r.root]
        picked += of if last is None else of[max(0, len(of) - last):]
    ids = {r.id for r in picked}
    host, dev, cnt = {}, {}, {}
    for r in recs:
        if r.root not in ids:
            continue
        host[r.name] = host.get(r.name, 0.0) + (r.t1 - r.t0) / 1e6
        if r.device_ms is not None:
            dev[r.name] = dev.get(r.name, 0.0) + r.device_ms
        for k, v in r.counts.items():
            cnt[k] = cnt.get(k, 0) + v
    return Totals(calls=len(picked), host_ms=host, device_ms=dev, counts=cnt,
                  on_device=bool(picked) and all(r.device_ms is not None
                                                 for r in picked))


class SectionTimer:
    """Named sections of a build with an aggregate summary (the JAX
    package's ``[timer]`` lines), each a span of this tracer."""

    def __init__(self, label: str = "", enabled: bool | None = None,
                 stream=None, device=None):
        self.enabled = timers_enabled() if enabled is None else enabled
        self.label = label
        self.stream = stream or sys.stderr
        self.device = device
        self._lines = deque()   # (text, closed section or None), unprinted
        self._done = []         # closed sections
        self._open = self._begin()

    def _begin(self):
        return Span(f"psac.timer.{self.label or 'sections'}", self.device,
                    {}).__enter__() if self.enabled else None

    def end_section(self, name: str) -> None:
        """Close the current section under ``name`` and open the next."""
        if not self.enabled:
            return
        sec = self._open
        sec.set(section=name)
        sec.close()
        self._done.append(sec)
        self._lines.append((name, sec))
        self._open = self._begin()
        self._flush()

    def info(self, msg: str) -> None:
        if self.enabled:
            self._lines.append((msg, None))
            self._flush()

    def summary(self) -> None:
        """Drop the open section, print every line (waiting for their
        events) and the totals by name."""
        if not self.enabled:
            return
        stack = _tls.stack
        if any(s is self._open for s in stack):
            while True:
                s = stack.pop()
                s._drop()
                if s is self._open:
                    break
        self._open = None
        self._flush(wait=True)
        tot, cnt = {}, {}
        for s in self._done:
            name = s.attrs["section"]
            tot[name] = tot.get(name, 0.0) + s.ms
            cnt[name] = cnt.get(name, 0) + 1
        if tot:
            self._print(f"---- summary ({sum(tot.values()):.2f} ms total)")
            for name, t in sorted(tot.items(), key=lambda kv: -kv[1]):
                self._print(f"  {name}: {t:.2f} ms x{cnt[name]}")

    def _flush(self, wait: bool = False) -> None:
        if wait:
            _settle(True)
        elif _pending:
            _settle(False)
        while self._lines:
            text, sec = self._lines[0]
            if sec is not None:
                if sec.ms is None:
                    return
                text = f"{text}: {sec.ms:.2f} ms"
            self._lines.popleft()
            self._print(text)

    def _print(self, msg: str) -> None:
        pfx = f" [{self.label}]" if self.label else ""
        print(f"[timer]{pfx} {msg}", file=self.stream, flush=True)
