"""mesh_st_ms: device milliseconds a build across processes spends in
``construct_suffix_tree_device`` on card 0 (rank 0's shard: the ANSV
across shards on K5 and K8, the routed node edges), from the program's
``psac.st`` call spans (``psac_tpu_torch.utils.timers``): the traced
window's total over its builds.  None where the spans carry no device
time."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.st", len(run.units)).total("psac.st",
                                                             "device")
    return None if ms is None else ms / len(run.units)
