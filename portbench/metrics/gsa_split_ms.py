"""gsa_split_ms: device milliseconds a build spends on the separator drop on
the card and the readback of the separators' positions, from the program's
``psac.gsa.split`` spans under its ``psac.gsa`` calls
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
    ms = totals(records(), "psac.gsa", len(run.units)).total(
        "psac.gsa.split", "device")
    return None if ms is None else ms / len(run.units)
