"""comm_calls_per_build: collectives a build across processes makes on
rank 0 (each one signature check and one exchange), the program's
``psac.comm`` spans over the traced window's builds.  None without such
spans."""

from portbench.harness.comm_spans import comm_spans


def read(run):
    spans = comm_spans(run)
    return None if spans is None else len(spans) / len(run.units)
