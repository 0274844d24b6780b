"""Reading the profiler's trace of the window.

``from_profiler`` turns a finished ``torch.profiler.profile`` into plain
events; everything after it works on plain events, so a test can give it
a synthetic trace.  An event is ``(name, start_ns, end_ns)``; device
events are every kernel, copy and set the card ran, host events the
operations and ``record_function`` spans of the thread that ran the
window."""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    device: list            # [(name, start_ns, end_ns)]
    host: list              # [(name, start_ns, end_ns)], window's thread
    window: tuple           # (start_ns, end_ns) of the window's span


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def from_profiler(prof, spans=()) -> Trace:
    """The window's events.  The profiler also puts each
    ``record_function`` span (``spans``, and the window's) on the device's
    timeline as an annotation: those are not work, and are left out."""
    spans = set(spans) | {WINDOW}
    events = prof.profiler.kineto_results.events()
    device, host = [], defaultdict(list)
    window, window_tid = None, None
    for ev in events:
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if "CUDA" in str(ev.device_type()):
            if name not in spans:
                device.append((name, start, end))
            continue
        tid = ev.start_thread_id()
        host[tid].append((name, start, end))
        if name == WINDOW:
            window, window_tid = (start, end), tid
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(device=device, host=host[window_tid], window=window)


def busy_intervals(device: list, lo: int, hi: int) -> list:
    """The union of the device events' intervals, clipped to [lo, hi]."""
    out = []
    for _, s, e in sorted(device, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which the card ran anything."""
    return sum(e - s for s, e in busy_intervals(tr.device, *tr.window)) / 1e9


def idle_pct(tr: Trace) -> float:
    lo, hi = tr.window
    return 100.0 * (1.0 - busy_s(tr) * 1e9 / (hi - lo))


def gaps(tr: Trace) -> list:
    """The idle stretches of the window: [(start_ns, end_ns)]."""
    lo, hi = tr.window
    out, t = [], lo
    for s, e in busy_intervals(tr.device, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters (``void ns::f<...>(int*, ...)`` -> ``ns::f``)."""
    if name.startswith("void "):
        name = name[5:]
    elif "::" not in name:  # a copy or a set, not a kernel
        return name
    while True:
        cut = re.sub(r"<[^<>]*>", "", name)
        if cut == name:
            break
        name = cut
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i]
    return name


def device_ops(tr: Trace, top: int = 10) -> list:
    """[[name, seconds]]: the device operations that took most time,
    summed by short name."""
    tot = defaultdict(int)
    lo, hi = tr.window
    for name, s, e in tr.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            tot[short_name(name)] += e - s
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], ns / 1e9] for name, ns in best]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds]]: the window's idle time summed
    by the host's span and innermost operation at each gap's middle
    (``span > op``), the largest first."""
    host = sorted(tr.host, key=lambda x: (x[1], -x[2]))
    tot = defaultdict(int)
    stack, i = [], 0
    for s, e in sorted(gaps(tr), key=lambda g: g[0] + g[1]):
        mid = (s + e) // 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        names = [h[0] for h in stack if h[0] != WINDOW]
        key = " > ".join(dict.fromkeys([names[0], names[-1]])) if names \
            else "between spans"
        tot[key] += e - s
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[k[:120], ns / 1e9] for k, ns in best]


def kernel_seconds(tr: Trace, pattern: str) -> tuple[int, float]:
    """(launches, seconds) of the device events whose name holds
    ``pattern``, inside the window."""
    lo, hi = tr.window
    n, ns = 0, 0
    for name, s, e in tr.device:
        if pattern in name and s >= lo and e <= hi:
            n += 1
            ns += e - s
    return n, ns / 1e9
