"""Blocked per-element previous-smaller-value engine (port of
``psac_tpu/ops/bansv.py``): K5 ``block_psv`` as a hand-written CUDA kernel
(``psac_tpu_torch/csrc/bansv.cu``) with the JAX formula in torch beside it
as its plain version, and the match types built on it.

The three reference match types reduce to two primitive arrays plus one
grouped head table (see the JAX module for the proof sketch):

  * ``nearest_sm(i)``  = PSV(i)  = last j < i with x[j] <  x[i]
  * ``nearest_eq(i)``  = PSEV(i) = last j < i with x[j] <= x[i]
  * ``furthest_eq(i)`` = H[i] if H[i] != i else H[PSV(i)]

where ``H[t]`` is the least index of t's (PSV, value) group, the head of
its visible equal run.  Right-side matches are left-side matches of the
reversed array (the caller flips).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.ansv import NEAREST_EQ, NEAREST_SM
from psac_tpu_torch.parallel.collectives import global_cummax
from psac_tpu_torch.parallel.sort import lex_perm

B = 256          # block width of the plain version (the JAX ``B``)
_BC = 512        # blocks per chunk of the plain all-pairs stage
_QDIV = 64       # distant-block resolve chunk = max(s // _QDIV, _QMIN)
_QMIN = 2048
KERNEL_BLOCK = 256  # B of csrc/bansv.cu: the minima hierarchy's width
KERNEL_TILE = 256   # TILE of csrc/bansv.cu: a window is two such tiles


def _cmp(a, b, strict: bool):
    return (a < b) if strict else (a <= b)


def block_psv_plain(x: torch.Tensor, strict: bool) -> torch.Tensor:
    """Plain version of K5: the JAX ``block_psv`` formula.

    x: (s,) int32 or int64.  Returns (s,) int32 indices, -1 where no match.
    """
    s = x.shape[0]
    dev = x.device
    if s == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    inf = torch.iinfo(x.dtype).max
    nb0 = -(-s // B)
    xf = torch.cat([x, x.new_full((nb0 * B - s,), inf)])
    x2 = xf.view(nb0, B)
    offs = torch.arange(B, dtype=torch.int32, device=dev)

    # ---- stage 1: own-block + previous-block all-pairs, in chunks of blocks
    xprev = torch.cat([x2.new_full((1, B), inf), x2[:-1]])
    tri = offs[None, :] < offs[:, None]  # (i, j): j < i
    own_l, prev_l = [], []
    for c0 in range(0, nb0, _BC):
        xc, xp = x2[c0:c0 + _BC], xprev[c0:c0 + _BC]
        q_own = _cmp(xc[:, None, :], xc[:, :, None], strict) & tri
        own_l.append(torch.where(q_own, offs, -1).amax(dim=2))
        q_prev = _cmp(xp[:, None, :], xc[:, :, None], strict)
        prev_l.append(torch.where(q_prev, offs, -1).amax(dim=2))
    own = torch.cat(own_l).view(-1)
    prevb = torch.cat(prev_l).view(-1)

    b_of = torch.arange(nb0 * B, dtype=torch.int64, device=dev) // B
    ans = torch.where(own >= 0, b_of * B + own, -1)
    if nb0 == 1:
        return ans[:s].to(torch.int32)

    # ---- stage 2: target block via block/superblock minima, per superblock
    m0 = x2.amin(dim=1)
    nb1 = -(-nb0 // B)
    m1_2 = torch.cat([m0, m0.new_full((nb1 * B - nb0,), inf)]).view(nb1, B)
    m1 = m1_2.amin(dim=1)
    sb_offs = torch.arange(nb1, dtype=torch.int32, device=dev)
    SB = B * B
    v_sb = torch.cat([xf, xf.new_full((nb1 * SB - nb0 * B,), inf)]).view(
        nb1, SB)
    bb = torch.arange(SB, dtype=torch.int32, device=dev) // B
    tb_l = []
    for g in range(nb1):
        v = v_sb[g]
        q1 = _cmp(m1_2[g][None, :], v[:, None], strict) & \
            (offs[None, :] < bb[:, None])
        t1 = torch.where(q1, offs, -1).amax(dim=1)
        q2 = _cmp(m1[None, :], v[:, None], strict) & (sb_offs[None, :] < g)
        s2 = torch.where(q2, sb_offs, -1).amax(dim=1)
        row2 = m1_2[s2.clamp(0, nb1 - 1)]  # (SB, B)
        t2 = torch.where(_cmp(row2, v[:, None], strict), offs, 0).amax(dim=1)
        tb_l.append(torch.where(t1 >= 0, g * B + t1,
                                torch.where(s2 >= 0, s2.long() * B + t2, -1)))
    tb = torch.cat(tb_l)[:nb0 * B]

    # the previous-block pass already answered targets in block b - 1
    ans = torch.where((ans < 0) & (tb == b_of - 1) & (prevb >= 0),
                      (b_of - 1) * B + prevb, ans)

    # ---- stage 3: distant-block answers, row reads in bounded chunks
    gidx = torch.arange(nb0 * B, device=dev)
    unres = (ans < 0) & (tb >= 0) & (tb != b_of - 1) & (gidx < s)
    rows_of = torch.nonzero(unres).squeeze(1)
    S = nb0 * B
    m_pad = min(S, max(_QMIN, S // _QDIV))
    for c0 in range(0, rows_of.shape[0], m_pad):
        ix = rows_of[c0:c0 + m_pad]
        tc = tb[ix]
        rows = x2[tc]  # (m, B)
        last = torch.where(_cmp(rows, xf[ix][:, None], strict), offs,
                           0).amax(dim=1)
        ans[ix] = tc * B + last
    return ans[:s].to(torch.int32)


def block_psv(x: torch.Tensor, strict: bool) -> torch.Tensor:
    """K5 (replaces ``psac_tpu/ops/bansv.py::block_psv``): see
    ``block_psv_plain`` for the contract."""
    if x.device.type == "cpu":
        return block_psv_plain(x, strict)
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"block_psv: expected int32 or int64, got {x.dtype}")
    cuda_lib.check_cuda("block_psv", x.dtype, x)
    s = x.shape[0]
    if s >= (1 << 31):
        raise ValueError(f"block_psv: length {s} does not fit int32 indices")
    out = torch.empty(s, dtype=torch.int32, device=x.device)
    scratch = torch.empty(max(1, sum(cuda_lib.level_sizes(s, KERNEL_BLOCK))),
                          dtype=x.dtype, device=x.device)
    name = "psac_block_psv_i32" if x.dtype == torch.int32 else \
        "psac_block_psv_i64"
    cuda_lib.launch(name, x.data_ptr(), out.data_ptr(), scratch.data_ptr(), s,
                    int(strict), device=x.device)
    cuda_lib.count_launch(block_psv)
    return out


block_psv.launches = 0


def _run_heads(x: torch.Tensor, psv: torch.Tensor) -> torch.Tensor:
    """H[t] = least index of t's (PSV, value) group (the visible-run head):
    a stable 2-key sort (ties stay in index order, the JAX sort's third
    key) and a segmented broadcast of each group's first index."""
    s = x.shape[0]
    k1 = psv.to(torch.int64) + 1
    perm = lex_perm((k1, x))
    k1s, k2s = k1[perm], x[perm]
    seg = torch.ones(s, dtype=torch.bool, device=x.device)
    seg[1:] = (k1s[1:] != k1s[:-1]) | (k2s[1:] != k2s[:-1])
    gi = torch.arange(s, device=x.device)
    start = global_cummax(torch.where(seg, gi, -1))
    H = torch.empty_like(perm)
    H[perm] = perm[start.clamp(min=0)]
    return H


def nsv_left(x: torch.Tensor, typ: int, psv_fn=block_psv):
    """Left matches of every element of (s,) ``x`` on the block engine.

    Returns (idx, val): int32 indices (-1 = none) and the values there in
    ``x``'s dtype (0 = none).  ``psv_fn`` is K5's wrapper, or its plain
    version when the kernel is being checked."""
    if typ == NEAREST_SM:
        idx = psv_fn(x, True).to(torch.int64)
    elif typ == NEAREST_EQ:
        idx = psv_fn(x, False).to(torch.int64)
    else:  # FURTHEST_EQ
        psv = psv_fn(x, True).to(torch.int64)
        H = _run_heads(x, psv)
        gidx = torch.arange(x.shape[0], device=x.device)
        idx = torch.where(H != gidx, H,
                          torch.where(psv >= 0, H[psv.clamp(min=0)], -1))
    val = torch.where(idx >= 0, x[idx.clamp(min=0)], 0)
    return idx.to(torch.int32), val
