"""Record routing at p = 1 (port of the single-shard branches of
``psac_tpu/parallel/route.py::route_apply`` and ``route_scatter``).

With one shard every record is already at its owner: ``route_apply`` is a
local call of the answer function, and ``route_scatter`` is an indexed
write (or, with ``combine``, a reducing scatter) in which invalid records
land on one extra drop slot (JAX drops out-of-range scatter indices; torch
raises, hence the explicit slot).
"""

from __future__ import annotations

import torch


def route_apply(payloads: tuple, answer_fn, skip=None) -> tuple:
    """Apply ``answer_fn(payloads, valid)`` at the owner, which is here:
    ``valid`` is False for the records that ``skip`` marks (they are
    resolved by the caller and their answers are ignored)."""
    m = payloads[0].shape[0]
    valid = torch.ones(m, dtype=torch.bool, device=payloads[0].device) \
        if skip is None else ~skip
    return answer_fn(tuple(payloads), valid)


_REDUCE = {"min": "amin", "max": "amax"}


def route_scatter(dest_idx, values: tuple, targets: tuple, valid,
                  width: int = 1, slots=None,
                  combine: tuple | None = None) -> tuple:
    """targets[k][dest_idx[j] * width + slots[j]] = values[k][j] where
    ``valid``; returns new target tensors (inputs are left untouched).

    ``combine`` selects per target how records that meet in one place are
    merged, with each other and with the value already there: ``"set"``
    (the default; the places must then be distinct, since an indexed write
    with repeated indices is unordered on CUDA), ``"min"`` or ``"max"``
    (a reducing scatter: the GST's ``$``-edge child ranges)."""
    tgt_len = targets[0].shape[0]
    loc = dest_idx.to(torch.int64)
    if width > 1:
        loc = loc * width + slots.to(torch.int64)
    loc = torch.where(valid, loc, tgt_len)
    outs = []
    for tgt, v, how in zip(targets, values,
                           combine or ("set",) * len(targets)):
        padded = torch.cat([tgt, tgt.new_zeros(1)])
        if how == "set":
            padded[loc] = v.to(tgt.dtype)
        else:
            padded.scatter_reduce_(0, loc, v.to(tgt.dtype), _REDUCE[how],
                                   include_self=True)
        outs.append(padded[:tgt_len])
    return tuple(outs)
