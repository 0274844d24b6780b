"""build_mbps: input bytes (10^6) of every build completed in the window,
over the window's seconds."""

from portbench.harness.stats import rate


def read(run):
    work = [u["bytes"] for u in run.units if "bytes" in u]
    return rate(work, run.window_s) / 1e6 if work else None
