"""st_ms: mean milliseconds a build spends in
``construct_suffix_tree_device`` (the tree's ANSV pass, the edge
characters, the table's scatter), from the benchmark's ``st`` span."""

from portbench.harness.spans import mean_ms


def read(run):
    return mean_ms(run.spans, "st")
