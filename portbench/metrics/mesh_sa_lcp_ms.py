"""mesh_sa_lcp_ms: device milliseconds a build across processes spends in
``construct_device`` on card 0 (rank 0's shard: the k-mer init, the
sample sort's exchanges, the routed resolve, the tail), from the
program's ``psac.construct`` call spans (``psac_tpu_torch.utils.timers``):
the traced window's total over its builds.  None where the spans carry no
device time (a program that times a mesh's driver spans on no card)."""


def read(run):
    if run.trace is None or not run.units:
        return None
    try:
        from psac_tpu_torch.utils.timers import records, totals
    except ImportError:  # a program without spans of its own
        return None
    ms = totals(records(), "psac.construct", len(run.units)).total(
        "psac.construct", "device")
    return None if ms is None else ms / len(run.units)
