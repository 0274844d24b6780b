"""readbacks_per_build: device-to-host reads that wait for the card in a
build (staging's histogram, construction's counters, the tree's overflow
count), from the ``readbacks`` counters of the program's ``psac.stage``,
``psac.construct`` and ``psac.st`` calls
(``psac_tpu_torch.utils.timers``): the traced window's total over its
builds."""

ROOTS = ("psac.stage", "psac.construct", "psac.st")


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without counters of its own
        return None
    n = totals(records(), ROOTS, len(run.units)).count("readbacks")
    return None if n is None else n / len(run.units)
