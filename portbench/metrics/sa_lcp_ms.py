"""sa_lcp_ms: mean milliseconds a build spends in ``construct_device``
(the host driver, the k-mer init, the dense steps, the resolve, the
tail), from the benchmark's ``sa_lcp`` span."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "sa_lcp")
