"""init_ms: device milliseconds a build spends in the k-mer init (K9, the key
sort, K10, the rebucket and its counters' readback), from the program's
``psac.construct.init`` spans (``psac_tpu_torch.utils.timers``): the
traced window's total over its builds.  None where the spans carry no
device time (off the card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.construct", len(run.units)).total(
        "psac.construct.init", "device")
    return None if ms is None else ms / len(run.units)
