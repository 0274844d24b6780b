"""gst_ms: mean milliseconds a build spends in ``construct_gst_device``
(the tree's ANSV pass, the edge characters, the ``$``-edges, the table's
scatter), from the benchmark's ``gst`` span."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "gst")
