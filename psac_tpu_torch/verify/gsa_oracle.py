"""Host oracles for the generalized suffix array and its LCP.

``gsa_oracle`` sorts the suffixes of a small string set directly (each
suffix ends at its own string's end; ties in position order).
``gsa_oracle_native`` gives the same arrays for large sets at the cost of
one native SA-IS + Kasai run, with no device code: the strings are joined
by a NUL byte (below every character; the port rejects NUL in its input),
so a suffix that is a proper prefix of another sorts first as with a
virtual ``$``; separator rows are dropped, positions mapped to the flat
text, the LCP capped by both suffixes' remaining lengths, and each run of
identical whole suffixes (which the joined text orders by what follows the
separator) reordered by position.
"""

from __future__ import annotations

import numpy as np

from psac_tpu_torch import native


def gsa_oracle(parts) -> tuple[np.ndarray, np.ndarray]:
    """(GSA, GLCP) of a list of non-empty byte strings by direct sorting."""
    flat = b"".join(parts)
    lens = np.array([len(x) for x in parts], np.int64)
    n = len(flat)
    eos = np.repeat(np.cumsum(lens), lens)
    sa = np.array(sorted(range(n), key=lambda i: (flat[i:eos[i]], i)),
                  np.int64)
    lcp = np.zeros(n, np.int64)
    for j in range(1, n):
        a = flat[sa[j - 1]:eos[sa[j - 1]]]
        b = flat[sa[j]:eos[sa[j]]]
        k = 0
        while k < len(a) and k < len(b) and a[k] == b[k]:
            k += 1
        lcp[j] = k
    return sa, lcp


def gsa_oracle_native(flat: bytes, lens) -> tuple[np.ndarray, np.ndarray]:
    """(GSA, GLCP) of the string set with separator-free flat text ``flat``
    and per-string lengths ``lens`` (all positive), as int64 arrays."""
    lens = np.asarray(lens, np.int64)
    m, n = len(lens), len(flat)
    tarr = np.frombuffer(flat, np.uint8)
    if n and tarr.min() == 0:
        raise ValueError("the strings must not contain NUL bytes")
    ends = np.cumsum(lens)
    # joined text: string j occupies [starts[j] + j, ends[j] + j), then a NUL
    sid = np.repeat(np.arange(m), lens)            # string of flat position
    joined = np.zeros(n + m, np.uint8)
    joined[np.arange(n) + sid] = tarr
    jsa = native.suffix_array(joined)
    jlcp = native.lcp_array(joined, jsa)
    # the m separator suffixes sort first (NUL is below every character)
    jsa, jlcp = jsa[m:], jlcp[m:]
    # flat position = joined position - separators before it
    sep_before = np.cumsum(joined == 0) - (joined == 0)
    sa = jsa - sep_before[jsa]
    rem = np.repeat(ends, lens)[sa] - sa
    lcp = np.minimum(jlcp, rem)
    lcp[1:] = np.minimum(lcp[1:], rem[:-1])
    if n:
        lcp[0] = 0
    # runs of identical whole suffixes: row g continues its run when the
    # capped LCP is the full length of both suffixes
    same = np.zeros(n, bool)
    same[1:] = (lcp[1:] == rem[1:]) & (lcp[1:] == rem[:-1])
    in_run = same.copy()
    in_run[:-1] |= same[1:]
    rows = np.nonzero(in_run)[0]
    if len(rows):
        run_id = np.cumsum(~same)[rows]
        order = np.lexsort((sa[rows], run_id))
        sa[rows] = sa[rows][order]
    return sa, lcp
