"""gsa_tiefix_ms: device milliseconds a build spends on the tie-fix, the full
lengths of identical whole suffixes, from the program's ``psac.gsa.tiefix``
spans under its ``psac.gsa`` calls (``psac_tpu_torch.utils.timers``): the
traced window's total over its builds. None where the program has no such
calls (it does not span them) or their spans carry no device time (off the
card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.gsa", len(run.units)).total(
        "psac.gsa.tiefix", "device")
    return None if ms is None else ms / len(run.units)
