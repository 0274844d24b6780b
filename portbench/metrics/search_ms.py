"""search_ms: device milliseconds a batch spends in the search (the TLDT
sample search, K7 and the verification; no readback), from the program's
``psac.locate.search`` spans (``psac_tpu_torch.utils.timers``): the traced
window's total over its batches.  None where the spans carry no device
time (off the card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.locate", len(run.units)).total(
        "psac.locate.search", "device")
    return None if ms is None else ms / len(run.units)
