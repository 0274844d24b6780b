"""Single-device forms of the mesh collectives
(port of ``psac_tpu/parallel/collectives.py`` at p = 1).

With one shard there is no neighbour: halos are pure fill, the global
prefix-max is a local ``cummax``, and the doubling shift is a slice with
zero fill.  The shift distance is a host integer here (the construction
loop runs on the host), so no clamped dynamic slice is needed.
"""

from __future__ import annotations

import torch


def halo_from_right(x: torch.Tensor, count: int, fill=0) -> torch.Tensor:
    """The ``count`` elements right of the (only) shard: all ``fill``."""
    return torch.full((count,), fill, dtype=x.dtype, device=x.device)


def halo_from_left(x: torch.Tensor, count: int, fill=0) -> torch.Tensor:
    """The ``count`` elements left of the (only) shard: all ``fill``."""
    return torch.full((count,), fill, dtype=x.dtype, device=x.device)


def prev_of(x: torch.Tensor, fill=-1) -> torch.Tensor:
    """out[i] = x[i-1], ``fill`` at i = 0."""
    return torch.cat([halo_from_left(x, 1, fill), x[:-1]])


_CUMMAX_ROW = 1024


def global_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix max, as a two-level blocked scan: ``torch.cummax``
    over rows of 1024, then over the row maxima.  (One ``torch.cummax`` over
    a long 1-D CUDA tensor runs its scan on few threads: 58 ms at 2^26 on an
    H100, 69% of the SA+LCP device time.)"""
    n = x.shape[0]
    rows = -(-n // _CUMMAX_ROW)
    lowest = torch.iinfo(x.dtype).min
    xp = torch.cat([x, x.new_full((rows * _CUMMAX_ROW - n,), lowest)])
    part = torch.cummax(xp.view(rows, _CUMMAX_ROW), dim=1).values
    carry = torch.cummax(part[:, -1], dim=0).values
    carry = torch.cat([carry.new_full((1,), lowest), carry[:-1]])
    return torch.maximum(part, carry[:, None]).view(-1)[:n]


def global_shift_left_dyn(x: torch.Tensor, d: int) -> torch.Tensor:
    """out[g] = x[g + d], 0 past the end (d >= 0)."""
    s = x.shape[0]
    if d >= s:
        return torch.zeros_like(x)
    return torch.cat([x[d:], torch.zeros(d, dtype=x.dtype, device=x.device)])
