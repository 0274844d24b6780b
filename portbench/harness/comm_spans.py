"""The program's spans of a build across processes, as rank 0 recorded
them (``psac_tpu_torch.utils.timers``): each collective of a mesh that
spans processes is a ``psac.comm`` span (``parallel/mesh.py``, with the
counter ``comm_bytes``), under the build's ``psac.stage``,
``psac.construct`` and ``psac.st`` calls."""

from __future__ import annotations

ROOTS = ("psac.stage", "psac.construct", "psac.st")


def comm_spans(run) -> list | None:
    """The ``psac.comm`` records under the window's builds (the last calls
    of each root, one a build); None on an untraced run, on a program
    without the tracer or without such spans (one that does not span its
    collectives)."""
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records
    except ImportError:
        return None
    recs = records()
    builds = len(run.units)
    ids = set()
    for name in ROOTS:
        of = [r.id for r in recs if r.name == name and r.id == r.root]
        ids.update(of[max(0, len(of) - builds):])
    spans = [r for r in recs if r.root in ids and r.name == "psac.comm"]
    return spans or None


def device_ms(spans) -> float | None:
    """The spans' device ms summed; None where one carries none."""
    if any(r.device_ms is None for r in spans):
        return None
    return sum(r.device_ms for r in spans)
