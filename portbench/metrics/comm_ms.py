"""comm_ms: device milliseconds a build across processes spends in the
mesh's collectives on card 0, waits for the other ranks included, from
the program's ``psac.comm`` spans (``parallel/mesh.py``): the traced
window's total over its builds.  None without such spans or where they
carry no device time."""

from portbench.harness.comm_spans import comm_spans, device_ms


def read(run):
    spans = comm_spans(run)
    ms = None if spans is None else device_ms(spans)
    return None if ms is None else ms / len(run.units)
