"""Plain suffix array and LCP array of a byte text, by prefix doubling.

Independent of the program under test: plain PyTorch (it runs on the card
or the CPU), written from the textbook method, importing nothing of the
port.  The text's suffixes are ranked by their first ``k0`` characters
(packed into one int64 key, 0 past the end of the text), then by pairs of
ranks at doubling distances, a full sort each round, until every rank is
distinct.  The LCP of each pair of neighbouring rows comes from the kept
rank arrays by lifting (largest distance first), then character by
character below the first distance.

Codes: each byte present in the text gets its rank among the present
bytes, 1..sigma; 0 is the end of the text."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def text_tensor(text: bytes, device) -> torch.Tensor:
    """The text's bytes as a uint8 tensor on ``device`` (read only: the
    host view shares the ``bytes``' memory)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.frombuffer(text, np.uint8)).to(device)


def encode(text: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(codes int32, sigma) of a uint8 text on any device."""
    present = torch.bincount(text.to(torch.int32), minlength=256) > 0
    rank = torch.cumsum(present.to(torch.int32), 0) * present
    return rank[text.long()].to(torch.int32), int(present.sum())


def bits_for(sigma: int) -> int:
    return max(1, int(sigma).bit_length())


def _rank_sorted(keys_sorted: torch.Tensor) -> torch.Tensor:
    """1-based dense ranks of sorted keys (equal keys, equal ranks)."""
    new = torch.ones_like(keys_sorted, dtype=torch.int32)
    new[1:] = (keys_sorted[1:] != keys_sorted[:-1]).to(torch.int32)
    return torch.cumsum(new, 0, dtype=torch.int32)


def _shifted(x: torch.Tensor, h: int) -> torch.Tensor:
    """x[i + h], 0 past the end."""
    out = torch.zeros_like(x)
    if h < x.shape[0]:
        out[:x.shape[0] - h] = x[h:]
    return out


def prefix_keys(codes: torch.Tensor, sigma: int, k: int) -> torch.Tensor:
    """int64 key of each suffix's first k characters (bits_for(sigma) * k
    <= 63 bits), 0 past the end: keys order as the k-prefixes do."""
    bits = bits_for(sigma)
    if bits * k > 63:
        raise ValueError(f"{k} characters of {bits} bits exceed an int64")
    key = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for j in range(k):
        key = (key << bits) | _shifted(codes, j).to(torch.int64)
    return key


def suffix_array(codes: torch.Tensor, sigma: int, depth: int | None = None):
    """(sa int64, levels): the suffix array, and [(h, rank)] with rank the
    int32 rank of every suffix's h-prefix (equal iff the prefixes are).
    With ``depth``, stop once the prefixes of that many characters are
    sorted and leave ties in text order (the control's broken guarantee:
    suffixes sorted by a bounded prefix only)."""
    n = codes.shape[0]
    k0 = 63 // bits_for(sigma)
    if depth is not None:
        k0 = min(k0, depth)
    keys, sa = torch.sort(prefix_keys(codes, sigma, k0), stable=True)
    rank_sorted = _rank_sorted(keys)
    del keys
    rank = torch.empty(n, dtype=torch.int32, device=codes.device)
    rank[sa] = rank_sorted
    levels, h = [(k0, rank)], k0
    while int(rank_sorted[-1]) < n and (depth is None or h < depth):
        del rank_sorted
        key = (rank.to(torch.int64) << 32) | _shifted(rank, h).to(torch.int64)
        keys, sa = torch.sort(key, stable=True)
        del key
        rank_sorted = _rank_sorted(keys)
        del keys
        rank = torch.empty(n, dtype=torch.int32, device=codes.device)
        rank[sa] = rank_sorted
        h *= 2
        levels.append((h, rank))
    return sa, levels


def lcp_array(codes: torch.Tensor, sa: torch.Tensor, levels: list,
              cap: int | None = None) -> torch.Tensor:
    """int32 LCP of each row with the row before it (0 at row 0), from the
    rank arrays of ``suffix_array`` (at most ``cap`` where given)."""
    n = codes.shape[0]
    a, b = sa[:-1], sa[1:]
    lcp = torch.zeros(n - 1, dtype=torch.int64, device=codes.device)

    def at(x, i):  # x[i], 0 past the end
        return torch.where(i < n, x[i.clamp(max=n - 1)], 0)

    for h, rank in reversed(levels):
        same = at(rank, a + lcp) == at(rank, b + lcp)
        lcp += h * same
    k0 = levels[0][0]
    live = torch.ones_like(lcp, dtype=torch.bool)
    for _ in range(k0 - 1):
        ca, cb = at(codes, a + lcp), at(codes, b + lcp)
        live &= (ca == cb) & (ca != 0)
        lcp += live
    if cap is not None:
        lcp.clamp_(max=cap)
    out = torch.zeros(n, dtype=torch.int32, device=codes.device)
    out[1:] = lcp.to(torch.int32)
    return out
