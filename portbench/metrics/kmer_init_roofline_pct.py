"""kmer_init_roofline_pct: the k-mer init's share of its roofline, K9
(``kmer_pack``) and K10 (``kmer_heads``, ``csrc/kmer_init.cu``) together:
the byte bound of every init in the traced window over the device time
of those kernels, found in the trace by name.

The bound is ``harness.bounds``' copy of ``chip_smoke.py::kmer_bound``
at the build's padded N, with int32 codes and indexes, the LCP on, and
DNA's k-mer words: sigma 4 takes 3 bits a character, so two int32 words
of 10 characters, (10, 10)."""

from portbench.harness.bounds import kmer_heads_bound, kmer_pack_bound
from portbench.harness.trace import kernel_seconds

KS = (10, 10)


def read(run):
    if run.trace is None or not run.facts.get("N"):
        return None
    n9, s9 = kernel_seconds(run.trace, "pack_kernel")
    n10, s10 = kernel_seconds(run.trace, "heads_kernel")
    if not (n9 and n10):
        return None
    N = run.facts["N"]
    least = n9 * kmer_pack_bound(N, KS) + n10 * kmer_heads_bound(N, KS)
    return 100.0 * least / (s9 + s10)
