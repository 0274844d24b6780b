"""locate_p95_ms: the 95th percentile of the latency of every batch of
the window, each from the call to its ranges being on the host."""

from portbench.harness.stats import p95


def read(run):
    lat = [u["latency_s"] for u in run.units if "patterns" in u]
    return p95(lat) * 1e3 if lat else None
