"""locate_pps: patterns answered in every batch completed in the window,
over the window's seconds."""

from portbench.harness.stats import rate


def read(run):
    work = [u["patterns"] for u in run.units if "patterns" in u]
    return rate(work, run.window_s) if work else None
