"""The DESA's blind search, K7 (replaces
``psac_tpu/models/desa.py::_blind_search`` with
``psac_tpu/ops/rmq.py::query_arg_rmq``, which XLA fuses on the TPU).

Per pattern, from an inclusive in-slab SA range [l0, r0], walk the virtual
suffix-tree intervals using only the leftmost-argmin RMQ over the slab's
LCP and its left-branching characters Lc (reference desa.hpp:402-527
``find_child`` / ``local_locate_possible``).  ``blind_search`` launches the
hand-written CUDA kernel (``psac_tpu_torch/csrc/blind_search.cu``: one
launch, each pattern walked to its end by a group of lanes that reads
each range minimum's edge parts as 16-byte vectors; the launcher picks
the lanes from the slab's size, and ``launch_shape`` reports them) on CUDA
tensors and raises on what it does not take; given CPU tensors it runs
``blind_search_plain``, the batched torch walk, with the same outputs bit
for bit.
"""

from __future__ import annotations

import ctypes
import os

import torch

from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.bitops import pow2ceil
from psac_tpu_torch.ops.rmq import ArgLocalRMQ, query_arg_rmq
from psac_tpu_torch.parallel.route import route_scatter

I32_MAX = torch.iinfo(torch.int32).max

#: Active-set compaction rungs of the plain walk: batch-width divisors;
#: ``PSAC_DESA_RUNGS="2,8,64"`` sets others at call time (K7 has no rungs
#: and ignores it).
_COMPACT_RUNGS = (2, 8, 64)
#: Plain-walk steps between readbacks of the exit and compaction tests.
_CHECK_EVERY = 4

#: The largest RMQ block the kernel takes.
MAX_BLOCK = 128


def max_steps_for(cap: int) -> int:
    """The walk's hang guard: every inner step strictly shrinks [l, r], so
    2 * cap + 64 steps bound it; it is not the expected exit."""
    return 2 * cap + 64


def rung_widths(M: int) -> list[int]:
    """The widths the plain walk of ``M`` patterns compacts to, one per
    rung (``PSAC_DESA_RUNGS``, read now, else ``_COMPACT_RUNGS``): each
    ``M / divisor`` rounded up to a power of two, at least 256, narrower
    than ``M`` and than the rung before."""
    spec = os.environ.get("PSAC_DESA_RUNGS")
    rungs = tuple(int(v) for v in spec.split(",")) if spec else \
        _COMPACT_RUNGS
    widths = []
    for dv in rungs:
        w = max(256, pow2ceil(-(-M // dv)))
        if w < M and (not widths or w < widths[-1]):
            widths.append(w)
    return widths


def blind_search_plain(pat, lens, l0, r0, need, lcp_slab, lc_slab,
                       rmq: ArgLocalRMQ, cap: int, stats: dict):
    """Plain version of K7: the batched walk in inclusive in-slab
    coordinates, one batched RMQ per step.  Returns the final (l, r)
    (int32), the matched depth q (the LCP's dtype) and each pattern's step
    count (int32).

    The walk is lockstep over the batch.  Once the active count drops to a
    rung's width (``rung_widths``) the state is compacted to that width (a
    1-key sort) and the walk continues there; results are scattered back
    through one drop slot.  ``stats`` counts ``readbacks``."""
    M = l0.shape[0]

    def lcp_at(i):
        return lcp_slab[i.clamp(0, cap - 1)]

    def lc_at(i):
        return lc_slab[i.clamp(0, cap - 1)]

    def rmq_q(lo, hi):
        """Leftmost argmin index in [lo, hi] (the reference's ``minq``)."""
        lo = lo.clamp(0, cap - 1)
        hi = torch.maximum(hi, lo).clamp(0, cap - 1)
        return query_arg_rmq(rmq, lo, hi)

    def step(pat_, m, st):
        l, r, i, q, phase, done, nst = st
        active = ~done
        inner = active & (phase == 0)
        fix = active & (phase == 1)

        c = pat_.gather(1, q.clamp(0, pat_.shape[1] - 1).long()[:, None])[:, 0]
        lcpi = lcp_at(i)
        hit = inner & (lc_at(i) == c)
        adv = inner & ~hit
        l_adv = torch.where(adv, i, l)
        r_hit = torch.where(hit, i - 1, r)
        stop2 = adv & (l_adv == r)
        cont = adv & ~stop2

        # NB: the reference descends with minq only when l+1 < r
        # (desa.hpp:505), losing the split of 2-row intervals; l < r is the
        # correct condition (minq(l+1, r) with l+1 == r is just r).
        fixq = fix & (lcpi == q)
        fix_rmq = fixq & (l < r)

        im = rmq_q(torch.where(cont, l_adv, l) + 1,
                   torch.where(inner, r_hit, r))
        lcp_im = lcp_at(im)
        stay = cont & (l_adv < r) & (lcp_im == q)
        i_in = torch.where(cont, im, i)
        exit_inner = hit | stop2 | (cont & ~stay)

        i_fx = torch.where(fix_rmq, im, torch.where(fixq, l, i))
        q_fx = torch.where(fix_rmq, lcp_im,
                           torch.where(fixq, lcp_at(l), lcpi))
        done_fx = ~((q_fx < m) & (l < r) & (l < i_fx))

        return (torch.where(inner, l_adv, l),
                torch.where(inner, r_hit, r),
                torch.where(inner, i_in, torch.where(fix, i_fx, i)),
                torch.where(fix, q_fx, q),
                torch.where(exit_inner, 1, torch.where(fix, 0, phase)),
                done | (fix & done_fx),
                nst + active.to(torch.int32))

    max_steps = max_steps_for(cap)
    steps = 0

    def n_active(st) -> int:
        stats["readbacks"] += 1
        return int((~st[5]).sum())

    def run(pat_, m, st, widths):
        nonlocal steps
        nxt = widths[0] if widths else 0
        na = n_active(st)
        while na > nxt and steps < max_steps:
            for _ in range(min(_CHECK_EVERY, max_steps - steps)):
                st = step(pat_, m, st)
                steps += 1
            na = n_active(st)
        if not widths or na == 0 or na > nxt:
            return st
        Mw = pat_.shape[0]
        key = torch.where(st[5], I32_MAX,
                          torch.arange(Mw, dtype=torch.int32,
                                       device=pat_.device))
        ks, perm = torch.sort(key)
        ks, perm = ks[:nxt], perm[:nxt]
        valid = ks != I32_MAX
        idxc = torch.where(valid, ks, 0).long()
        stc = run(pat_[idxc], m[idxc],
                  tuple(a[perm] for a in st[:5]) + (~valid, st[6][perm]),
                  widths[1:])
        return route_scatter(idxc, stc, st, valid)

    widths = rung_widths(M)
    i0 = rmq_q(l0 + 1, r0)
    q0 = lcp_at(i0)
    done0 = (~need) | ~((q0 < lens) & (l0 < r0) & (l0 < i0))
    l, r, _, q, _, _, nst = run(
        pat, lens, (l0, r0, i0, q0, torch.zeros_like(l0), done0,
                    torch.zeros_like(l0)), widths)
    return l, r, q, nst


def launch_shape(dtype: torch.dtype, cap: int, B: int) -> dict:
    """The shape of a K7 launch of ``B`` patterns on a slab of ``cap`` rows
    of ``dtype`` values, as the library compiled it: lanes per pattern
    (``group``), ``threads`` per block, the most 16-byte vectors a lane
    loads in one round (``round``) and the ``blocks`` of the grid."""
    out = (ctypes.c_int * 3)()
    cuda_lib.lib().psac_blind_search_shape(cap, int(dtype == torch.int64),
                                           out)
    group, threads, rnd = out
    return dict(group=group, threads=threads, round=rnd,
                blocks=-(-B // (threads // group)))


def blind_search(pat, lens, l0, r0, need, lcp_slab, lc_slab,
                 rmq: ArgLocalRMQ, cap: int, stats: dict):
    """K7: see ``blind_search_plain`` for the contract.  On CUDA tensors one
    launch walks every pattern; ``launches`` counts the launches (a batch
    without a pattern launches nothing)."""
    if lcp_slab.device.type == "cpu":
        return blind_search_plain(pat, lens, l0, r0, need, lcp_slab, lc_slab,
                                  rmq, cap, stats)
    dt = lcp_slab.dtype
    if dt not in (torch.int32, torch.int64):
        raise ValueError(f"blind_search: expected int32 or int64, got {dt}")
    cuda_lib.check_cuda("blind_search", dt, lcp_slab)
    cuda_lib.check_cuda("blind_search", torch.int32, lc_slab)
    cuda_lib.check_cuda("blind_search", torch.int32, lens, l0, r0)
    cuda_lib.check_cuda("blind_search", torch.bool, need)
    B = l0.shape[0]
    if pat.dtype != torch.int32 or pat.dim() != 2 or pat.shape[0] != B or \
            pat.shape[1] < 1 or not pat.is_contiguous() or \
            pat.device != lcp_slab.device:
        raise ValueError("blind_search: expected a contiguous (B, Lmax) "
                         "int32 code matrix on the slab's device")
    dev = lcp_slab.device
    if need.shape[0] != B or lens.device != dev or need.device != dev or \
            lc_slab.device != dev:
        raise ValueError("blind_search: expected CUDA tensors on one device")
    if cap != lcp_slab.shape[0] or lc_slab.shape[0] != cap:
        raise ValueError(f"blind_search: cap {cap} is not the slab's length")
    tab_v, tab_a, block = rmq.tab_v, rmq.tab_a, rmq.block
    if rmq.x.data_ptr() != lcp_slab.data_ptr() or tab_v.dtype != dt or \
            tab_a.dtype != torch.int32 or tab_v.shape != tab_a.shape or \
            not (tab_v.is_contiguous() and tab_a.is_contiguous()) or \
            tab_v.device != lcp_slab.device or \
            tab_a.device != lcp_slab.device or \
            tab_v.shape[1] * block != cap:
        raise ValueError("blind_search: the RMQ is not this slab's")
    if block & (block - 1) or not 0 < block <= MAX_BLOCK:
        raise ValueError(f"blind_search: block {block} is not a power of two "
                         f"up to {MAX_BLOCK}")
    if lcp_slab.data_ptr() % 16 or cap * lcp_slab.element_size() % 16:
        raise ValueError("blind_search: the slab's LCP must start on a "
                         "16-byte boundary and fill whole 16-byte words")
    out_l = torch.empty_like(l0)
    out_r = torch.empty_like(l0)
    out_q = torch.empty(B, dtype=dt, device=l0.device)
    out_steps = torch.empty_like(l0)
    if B == 0:
        return out_l, out_r, out_q, out_steps
    name = "psac_blind_search_i32" if dt == torch.int32 else \
        "psac_blind_search_i64"
    cuda_lib.launch(name, pat.data_ptr(), lens.data_ptr(), l0.data_ptr(),
                    r0.data_ptr(), need.data_ptr(), lcp_slab.data_ptr(),
                    lc_slab.data_ptr(), tab_v.data_ptr(), tab_a.data_ptr(),
                    out_l.data_ptr(), out_r.data_ptr(), out_q.data_ptr(),
                    out_steps.data_ptr(), B, pat.shape[1], cap,
                    tab_v.shape[1], tab_v.shape[0], block,
                    max_steps_for(cap), device=pat.device)
    cuda_lib.count_launch(blind_search)
    return out_l, out_r, out_q, out_steps


blind_search.launches = 0
