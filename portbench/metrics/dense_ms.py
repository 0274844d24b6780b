"""dense_ms: device milliseconds a build spends in the dense L-pling steps
(each step's sort, rebucket and counters' readback; its resolve apart),
from the program's ``psac.construct.dense`` spans
(``psac_tpu_torch.utils.timers``): the traced window's total over its
builds.  None where the spans carry no device time (off the card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.construct", len(run.units)).total(
        "psac.construct.dense", "device")
    return None if ms is None else ms / len(run.units)
