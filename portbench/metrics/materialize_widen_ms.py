"""materialize_widen_ms: host milliseconds a build spends widening the host
SA and LCP to int64 (``DeviceSuffixArray.materialize``), from the
program's ``psac.materialize.widen`` spans
(``psac_tpu_torch.utils.timers``): the traced window's total over its
builds."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.materialize", len(run.units)).total(
        "psac.materialize.widen", "host")
    return None if ms is None else ms / len(run.units)
