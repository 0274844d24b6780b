"""The comparison that decides ``correct`` in the locate cells: the
half-open SA range ``[l, r)`` of every pattern of every batch the window
answered, against the range the plain reference finds in its own suffix
array of the text (``suffix_array`` beside this file): the rows whose
suffixes begin with the pattern, by binary search over each row's packed
first ``m`` characters.  A pattern that does not occur may have any empty
range.  The number compared is the count of patterns answered wrong or not
at all; its limit is 0, since the configuration guarantees exact ranges.

The control (``control``) puts the reference in the program's place with
one guarantee broken: each pattern answered by its first
``CONTROL_PREFIX`` characters only, the depth of a top-level k-mer table
without the search below it."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import suffix_array as ref_sa

CONTROL_PREFIX = 12
CHUNK = 1 << 22  # patterns a search call


def _bound(keys, q, lo, hi, upper: bool):
    """Per query, the first row in [lo, hi) whose key is above (upper) or
    at least (lower) q: a binary search with bounds of its own."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) // 2
        k = keys[mid.clamp(max=keys.shape[0] - 1)]
        go_right = (k <= q) if upper else (k < q)
        lo = torch.where(live & go_right, mid + 1, lo)
        hi = torch.where(live & ~go_right, mid, hi)
    return lo


def _ranges(text: bytes, patterns: np.ndarray, device, prefix=None):
    """(P, 2) int64 reference ranges of the (P, m) uint8 patterns, each by
    its first ``prefix`` characters where given.  The characters are
    taken in chunks that pack into an int64; rows sharing a pattern's
    earlier chunks are sorted by the next, so each chunk narrows the
    range by two binary searches."""
    t = ref_sa.text_tensor(text, device)
    codes, sigma = ref_sa.encode(t)
    sa, levels = ref_sa.suffix_array(codes, sigma)
    del levels
    m = patterns.shape[1] if prefix is None else prefix
    bits = ref_sa.bits_for(sigma)
    w = 63 // bits
    # the patterns' codes by the text's alphabet (an absent byte: -1)
    present = torch.bincount(t.to(torch.int32), minlength=256) > 0
    lut = torch.where(present, torch.cumsum(present.to(torch.int64), 0), -1)
    n = codes.shape[0]
    keys = [ref_sa.prefix_keys(ref_sa._shifted(codes, j), sigma,
                               min(w, m - j))[sa] for j in range(0, m, w)]
    del sa
    out = np.empty((patterns.shape[0], 2), np.int64)
    for lo_q in range(0, patterns.shape[0], CHUNK):
        c = lut[torch.from_numpy(patterns[lo_q:lo_q + CHUNK, :m])
                .to(device).long()]
        lo = torch.zeros(c.shape[0], dtype=torch.int64, device=device)
        hi = torch.full_like(lo, n)
        for j, kj in zip(range(0, m, w), keys):
            q = torch.zeros_like(lo)
            for i in range(j, min(j + w, m)):
                q = (q << bits) | c[:, i].clamp(min=0)
            lo, hi = (_bound(kj, q, lo, hi, upper=False),
                      _bound(kj, q, lo, hi, upper=True))
        hi = torch.where((c < 0).any(1), lo, hi)
        out[lo_q:lo_q + CHUNK, 0] = lo.cpu().numpy()
        out[lo_q:lo_q + CHUNK, 1] = hi.cpu().numpy()
    return out


def _wrong(got: np.ndarray, want: np.ndarray) -> int:
    """Patterns of one batch answered wrong (all of them when the batch's
    answers are not one range a pattern)."""
    if got.shape != want.shape:
        return want.shape[0]
    empty = want[:, 1] <= want[:, 0]
    ok = np.where(empty, got[:, 1] <= got[:, 0], (got == want).all(1))
    return int((~ok).sum())


def check(inputs: dict, outputs: dict, device) -> tuple[list[dict], int]:
    """(checks, failed): the count of patterns answered wrong, with its
    limit, and the same count as the failed requests."""
    pats = inputs["patterns"]
    used = outputs["batches"]
    want = _ranges(inputs["text"], pats[used].reshape(-1, pats.shape[2]),
                   device).reshape(len(used), pats.shape[1], 2)
    wrong = sum(_wrong(np.asarray(got), want[i])
                for i, got in enumerate(outputs["ranges"]))
    return [{"name": "patterns_wrong", "value": wrong, "limit": 0}], wrong


def control(inputs: dict, pipeline_outputs: set, device) -> dict:
    """Every batch of the pool answered by its patterns' first
    ``CONTROL_PREFIX`` characters."""
    pats = inputs["patterns"]
    got = _ranges(inputs["text"], pats.reshape(-1, pats.shape[2]), device,
                  prefix=CONTROL_PREFIX).reshape(pats.shape[0],
                                                 pats.shape[1], 2)
    return {"batches": list(range(pats.shape[0])), "ranges": list(got)}
