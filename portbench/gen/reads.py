"""A sequencing read set made from the seed: one iid uniform genome of
``genome`` characters over ``alphabet``, and ``n // read_length`` reads of
``read_length`` characters from it, each from a uniform start, each
reverse-complemented with probability ``revcomp`` (the alphabet read
backwards: A<->T, C<->G for ACGT), each character then substituted with
probability ``sub_rate`` (moved to another letter).  No quality values, no
paired-end links, no ``N``.  Each read is followed by a newline, as a
``gsac -f`` input file holds them.

Parameters (the traffic file's ``text``): ``n`` (the read characters, cut
down to whole reads), ``read_length``, ``genome``, ``alphabet``,
``revcomp`` (default 0), ``sub_rate`` (default 0).  Made on ``device``
with a ``torch.Generator`` seeded with the run's seed, in a few large
calls, and handed to the program as host ``bytes``."""

from __future__ import annotations

import numpy as np
import torch


def make(params: dict, seed: int, device) -> bytes:
    length = int(params["read_length"])
    count = int(params["n"]) // length
    glen = int(params["genome"])
    alphabet = params["alphabet"].encode()
    a = len(alphabet)
    if glen < length or count < 1:
        raise ValueError(f"no read of {length} from a genome of {glen}")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    genome = torch.randint(0, a, (glen,), dtype=torch.uint8, generator=g,
                           device=device)
    starts = torch.randint(0, glen - length + 1, (count, 1), generator=g,
                           device=device)
    reads = genome[starts + torch.arange(length, device=device)]
    del genome, starts
    rc = torch.rand(count, 1, generator=g, device=device) < \
        float(params.get("revcomp", 0.0))
    reads = torch.where(rc, (a - 1 - reads).flip(1), reads)
    del rc
    rate = float(params.get("sub_rate", 0.0))
    if rate:
        sub = torch.rand(count, length, generator=g, device=device) < rate
        by = torch.randint(1, a, (count, length), dtype=torch.uint8,
                           generator=g, device=device)
        reads = torch.where(sub, (reads + by) % a, reads)
        del sub, by
    lut = torch.tensor(np.frombuffer(alphabet, np.uint8), device=device)
    out = torch.full((count, length + 1), ord("\n"), dtype=torch.uint8,
                     device=device)
    out[:, :length] = lut[reads.long()]
    return out.cpu().numpy().tobytes()
