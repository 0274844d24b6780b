"""tail_ms: device milliseconds a build spends in the sparse tail (entry,
steps and their readbacks, recompaction; 0 where the dense steps finished
every suffix), from the program's ``psac.construct.tail`` spans
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
        "psac.construct.tail", "device")
    return None if ms is None else ms / len(run.units)
