"""encode_ms: mean milliseconds a batch spends in ``DESA.encode_patterns``
(the host's encoding of the patterns), from the benchmark's ``encode``
span around that method of the run's DESA."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "encode")
