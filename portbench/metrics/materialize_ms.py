"""materialize_ms: mean milliseconds a build spends in
``DeviceSuffixArray.materialize`` (copies to the host, int64 arrays),
from the benchmark's ``materialize`` span."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "materialize")
