"""encode_join_ms: host milliseconds a batch spends on the patterns' lengths
and their byte join (``DESA.encode_patterns``), from the program's
``psac.locate.encode.join`` spans (``psac_tpu_torch.utils.timers``): the
traced window's total over its batches."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.locate", len(run.units)).total(
        "psac.locate.encode.join", "host")
    return None if ms is None else ms / len(run.units)
