"""stage_upload_ms: host milliseconds a build spends uploading the bytes into
the zeroed device buffer (``parallel/staging.py::_stage``: the pageable
copy and the write), from the program's ``psac.stage.upload`` spans
(``psac_tpu_torch.utils.timers``): the traced window's total over its
builds."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.stage", len(run.units)).total(
        "psac.stage.upload", "host")
    return None if ms is None else ms / len(run.units)
