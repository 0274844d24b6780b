"""st_ansv_ms: device milliseconds a build spends in the suffix tree's ANSV
pass (``models/suffix_tree.py::_parent_nsv``), from the program's
``psac.st.ansv`` spans (``psac_tpu_torch.utils.timers``): the traced
window's total over its builds.  None where the spans carry no device time
(off the card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.st", len(run.units)).total(
        "psac.st.ansv", "device")
    return None if ms is None else ms / len(run.units)
