"""A text made from the seed: ``copies`` copies of one iid uniform base
over ``alphabet``, concatenated with no separator, each copy with its own
point substitutions at ``sub_rate`` of its positions (each substituted
character moved to another letter).  One copy and no substitutions is an
iid uniform text.

Parameters (the traffic file's ``text``): ``n``, ``alphabet``, ``copies``
(default 1), ``sub_rate`` (default 0).  Made on ``device`` with a
``torch.Generator`` seeded with the run's seed, in a few large calls, and
handed to the program as host ``bytes``."""

from __future__ import annotations

import numpy as np
import torch


def make(params: dict, seed: int, device) -> bytes:
    n = int(params["n"])
    alphabet = params["alphabet"].encode()
    copies = int(params.get("copies", 1))
    if n % copies:
        raise ValueError(f"n = {n} is not a whole number of {copies} copies")
    base_n = n // copies
    a = len(alphabet)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    base = torch.randint(0, a, (base_n,), dtype=torch.uint8, generator=g,
                         device=device)
    codes = base.repeat(copies)
    del base
    subs = round(float(params.get("sub_rate", 0.0)) * base_n)
    if subs:
        # each copy's substitutions at positions of its own; a position
        # drawn twice moves by the sum of its shifts (integer adds, so the
        # result does not depend on the order of the card's atomics)
        at = torch.randint(0, base_n, (copies, subs), generator=g,
                           device=device)
        at += torch.arange(copies, device=device)[:, None] * base_n
        by = torch.randint(1, a, (copies * subs,), dtype=torch.int32,
                           generator=g, device=device)
        shift = torch.zeros(n, dtype=torch.int32, device=device)
        shift.index_add_(0, at.reshape(-1), by)
        codes = ((codes.to(torch.int32) + shift) % a).to(torch.uint8)
        del shift
    lut = torch.tensor(np.frombuffer(alphabet, np.uint8), device=device)
    return lut[codes.long()].cpu().numpy().tobytes()
