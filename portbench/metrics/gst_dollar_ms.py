"""gst_dollar_ms: device milliseconds a build spends on the generalized suffix
tree's ``$``-edges (their run ends, slot 0), from the program's
``psac.gst.dollar`` spans under its ``psac.gst`` calls
(``psac_tpu_torch.utils.timers``): the traced window's total over its
builds. None where the program has no such calls (it does not span them) or
their spans carry no device time (off the card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.gst", len(run.units)).total(
        "psac.gst.dollar", "device")
    return None if ms is None else ms / len(run.units)
