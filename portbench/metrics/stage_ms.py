"""stage_ms: mean milliseconds a build spends in IO and staging
(``encode_and_shard``: the bytes up, the histogram, the codes), from the
benchmark's ``stage`` span."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "stage")
