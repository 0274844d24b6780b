"""device_idle_pct.gsa: the share of the traced window of read-set builds
(GSA, GLCP and GST) in which the card ran no kernel, copy or set
(``torch.profiler``)."""

from portbench.harness.trace import idle_pct


def read(run):
    if run.trace is None or not run.trace.device or not any(
            "bytes" in u for u in run.units):
        return None
    return idle_pct(run.trace)
