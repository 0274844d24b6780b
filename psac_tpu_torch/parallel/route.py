"""Record routing at p = 1 (port of the single-shard branch of
``psac_tpu/parallel/route.py::route_scatter``).

With one shard every record is already at its owner, so the JAX
``route_apply`` is a local gather, written inline by its callers, and
``route_scatter`` is an indexed write in which invalid records land on one
extra drop slot (JAX drops out-of-range scatter indices; torch raises,
hence the explicit slot).
"""

from __future__ import annotations

import torch


def route_scatter(dest_idx, values: tuple, targets: tuple, valid,
                  width: int = 1, slots=None) -> tuple:
    """targets[k][dest_idx[j] * width + slots[j]] = values[k][j] where
    ``valid``; returns new target tensors (inputs are left untouched)."""
    tgt_len = targets[0].shape[0]
    loc = dest_idx.to(torch.int64)
    if width > 1:
        loc = loc * width + slots.to(torch.int64)
    loc = torch.where(valid, loc, tgt_len)
    outs = []
    for tgt, v in zip(targets, values):
        padded = torch.cat([tgt, tgt.new_zeros(1)])
        padded[loc] = v.to(tgt.dtype)
        outs.append(padded[:tgt_len])
    return tuple(outs)
