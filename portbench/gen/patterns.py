"""Batches of patterns drawn from the seed, by ``mkpattern``'s rule
(psac ``src/mkpattern.cpp``): substrings of ``length`` characters at
uniform random positions of the text, so that every pattern occurs.

Parameters (the traffic file's ``patterns``): ``batch`` patterns a batch,
``length``, and ``batches_per_s``: the pool holds
ceil(seconds x batches_per_s) + 1 distinct batches (the first warms up),
so that no batch repeats in a window while the program answers fewer
than ``batches_per_s`` batches a second.  Drawn on ``device``, so the
pool's size costs set-up little besides its host lists."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.suffix_array import text_tensor


def pool_size(params: dict, seconds: float) -> int:
    return math.ceil(seconds * float(params["batches_per_s"])) + 1


def make(params: dict, text: bytes, seed: int, device, seconds: float):
    """(matrix, batches): the (batches, batch, length) uint8 patterns, and
    each batch as a list of ``bytes``, as a pattern file's lines read."""
    m, B = int(params["length"]), int(params["batch"])
    nb = pool_size(params, seconds)
    n = len(text)
    g = torch.Generator(device=device)
    # the text's generator took the seed; the patterns take their own
    g.manual_seed(seed ^ 0x5DEECE66D)
    t = text_tensor(text, device)
    pos = torch.randint(0, n - m + 1, (nb, B), generator=g, device=device)
    mat = t[pos[..., None] + torch.arange(m, device=device)]
    mat = mat.cpu().numpy()
    del t, pos
    rows = np.empty((nb, B, m + 1), np.uint8)
    rows[..., :m] = mat
    rows[..., m] = ord("\n")
    batches = []
    for b in range(nb):
        lines = rows[b].tobytes().split(b"\n")
        lines.pop()
        batches.append(lines)
    return mat, batches
