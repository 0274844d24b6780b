"""stage_copy_ms: host milliseconds a build spends copying the text's
read-only bytes to a writable host array
(``parallel/staging.py::_stage``), from the program's ``psac.stage.copy``
spans (``psac_tpu_torch.utils.timers``): the traced window's total over
its builds."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.stage", len(run.units)).total(
        "psac.stage.copy", "host")
    return None if ms is None else ms / len(run.units)
