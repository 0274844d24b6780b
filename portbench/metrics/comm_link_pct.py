"""comm_link_pct: the bytes rank 0 sends to the other processes (the
counter ``comm_bytes`` of the program's ``psac.comm`` spans) over the
device seconds of those spans, as a share of card 0's one-direction peak
to the other cards (``LINK_PEAK_BYTES_S``).  The spans' time includes the
waits for the other ranks, so the share cannot pass 100%.  None without
such spans or where they carry no device time."""

from portbench.harness.comm_spans import comm_spans, device_ms

#: card 0's bandwidth to the other three cards, one direction, in bytes a
#: second: ``nvidia-smi nvlink -s`` on the four-card H100 80GB HBM3 host
#: reads 18 active NVLink links of 26.562 GB/s on every card (``nvidia-smi
#: topo -m`` does not run there), 18 x 26.562 GB/s
LINK_PEAK_BYTES_S = 18 * 26.562e9


def read(run):
    spans = comm_spans(run)
    ms = None if spans is None else device_ms(spans)
    if not ms:
        return None
    sent = sum(r.counts.get("comm_bytes", 0) for r in spans)
    return 100.0 * sent / (ms / 1e3) / LINK_PEAK_BYTES_S
