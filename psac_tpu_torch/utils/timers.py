"""Named wall-clock sections of a build (port of ``psac_tpu/utils/timers.py``).

The host-driven construction loop ends each section at one of its scalar
readbacks, which wait for the device, so a section's wall time is the
device work queued in it.  Enable with ``PSAC_TIMER=1`` (or
``SectionTimer(enabled=True)``); lines go to stderr as
``[timer] [label] name: ms``, and ``summary`` prints the totals by name.
"""

from __future__ import annotations

import os
import sys
import time


def timers_enabled() -> bool:
    return os.environ.get("PSAC_TIMER", "0") not in ("", "0", "false")


class SectionTimer:
    """Named wall-clock sections with an aggregate summary."""

    def __init__(self, label: str = "", enabled: bool | None = None,
                 stream=None):
        self.enabled = timers_enabled() if enabled is None else enabled
        self.label = label
        self.stream = stream or sys.stderr
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._t0 = time.perf_counter()

    def end_section(self, name: str) -> float:
        """Close the current section under ``name``; returns its seconds."""
        now = time.perf_counter()
        dt = now - self._t0
        self._t0 = now
        if self.enabled:
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._print(f"{name}: {dt * 1000:.2f} ms")
        return dt

    def info(self, msg: str) -> None:
        if self.enabled:
            self._print(msg)

    def summary(self) -> None:
        if self.enabled and self.totals:
            total = sum(self.totals.values())
            self._print(f"---- summary ({total * 1000:.2f} ms total)")
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
                self._print(f"  {name}: {t * 1000:.2f} ms x{self.counts[name]}")

    def _print(self, msg: str) -> None:
        pfx = f" [{self.label}]" if self.label else ""
        print(f"[timer]{pfx} {msg}", file=self.stream, flush=True)
