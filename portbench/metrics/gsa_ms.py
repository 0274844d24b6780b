"""gsa_ms: mean milliseconds a build spends in ``build_gsa_device`` (the
buffer's staging, the separator drop on the card, eos, the construction,
the tie-fix), from the benchmark's ``gsa`` span."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "gsa")
