"""Tile-spine single-device ANSV (port of ``psac_tpu/ops/tansv.py``) of the
suffix tree's pair: FURTHEST_EQ left, NEAREST_SM right.

  1. **Tile phase (K4)**: per T-element tile, each element's in-tile
     previous smaller, the chain mask (no in-tile previous smaller), the
     run-compressed spine of weak prefix/suffix minima, the next spine
     member, and for FURTHEST_EQ the leftmost in-tile equal after the PSV.
     Hand-written CUDA kernel ``csrc/tansv_tile.cu`` (``tile_side``: a
     doubling min-table per tile in shared memory and fixed-step searches,
     no per-thread loop whose length depends on the data), with the JAX
     formula, over batches of tiles, as its plain version.
  2. **Spine scan (K1)**: left matches over the compacted spines
     (``ops/nsv_scan.py::nsv_scan_spine``, the block engine of K2/K3).
  3. **Combine**: plain tensor indexing (see the JAX module's docstring for
     why the spine closure is exact).

The JAX engine compacts each spine into a stream of a fixed s / 16 rows
(the TPU's SMEM stream) and reports an overflow past it.  Here the streams
are as long as the longer spine (rounded up to CHUNK), so no spine
overflows: K1's work follows the spine.  This is the ``spine`` engine of
``parallel/ansv.py``; the suffix tree's pass runs on the dual scan (K2).
"""

from __future__ import annotations

import torch

from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.nsv_scan import CHUNK, nsv_scan_spine

T = 512       # tile width
I32_INF = torch.iinfo(torch.int32).max
_PLAIN_TILES = 128  # tiles per batch of the plain tile phase: bounds its
# (tiles, T, T) temporaries at 128 MB of int32


def tile_side_plain(a: torch.Tensor, with_eq: bool):
    """Plain version of K4: the JAX ``_tile_side`` formula, batched.

    Returns (psv_g, psv_val, chain, spine, nxt, e_g, h_in), each (s,):
    in-tile PSV as a global index (-1 when none) and its value (0 when
    none), the chain and spine masks, the in-tile position of the next
    spine member at or right of each element (T when none), and — when
    ``with_eq`` — the global index of the leftmost in-tile equal after the
    PSV (I32_INF when none) and the in-tile run head (that equal, else the
    element itself); the last two are None otherwise.
    """
    nt = a.shape[0] // T
    a2 = a.view(nt, T)
    dev = a.device
    j = torch.arange(T, dtype=torch.int32, device=dev)
    tri = j[None, :] < j[:, None]  # (i, j): j < i
    outs = [[] for _ in range(7)]
    for t0 in range(0, nt, _PLAIN_TILES):
        t = a2[t0:t0 + _PLAIN_TILES]
        b = t.shape[0]
        base = (torch.arange(t0, t0 + b, dtype=torch.int32,
                             device=dev) * T)[:, None]
        lt = (t[:, None, :] < t[:, :, None]) & tri
        psv = torch.where(lt, j, -1).amax(dim=2)
        chain = psv < 0
        psv_g = torch.where(chain, -1, base + psv)
        psv_val = torch.where(chain, 0, t.gather(1, psv.clamp(min=0).long()))
        # weak suffix minima: nothing strictly smaller after, in the tile
        sufmin = torch.cummin(t.flip(1), dim=1).values.flip(1)
        suf_excl = torch.cat([sufmin[:, 1:], t.new_full((b, 1), I32_INF)], 1)
        sufvis = t <= suf_excl
        edge = torch.ones((b, 1), dtype=torch.bool, device=dev)
        run_first = torch.cat([edge, t[:, 1:] != t[:, :-1]], dim=1)
        run_last = torch.cat([t[:, :-1] != t[:, 1:], edge], dim=1)
        spine = (chain | sufvis) & (run_first | run_last)
        nxt = torch.cummin(torch.where(spine, j, T).flip(1),
                           dim=1).values.flip(1)
        cols = [psv_g, psv_val, chain, spine, nxt]
        if with_eq:
            eq = (t[:, None, :] == t[:, :, None]) & tri & \
                (j[None, None, :] > psv[:, :, None])
            e = torch.where(eq, j, T).amin(dim=2)
            cols.append(torch.where(e < T, base + e, I32_INF))
            cols.append(base + torch.where(e < T, e, j))
        for acc, col in zip(outs, cols):
            acc.append(col.reshape(-1))
    res = [torch.cat(acc).to(torch.bool if k in (2, 3) else torch.int32)
           if acc else None for k, acc in enumerate(outs)]
    return tuple(res)


def tile_side(a: torch.Tensor, with_eq: bool):
    """K4 (replaces the all-pairs ``psac_tpu/ops/tansv.py::_tile_side``);
    see ``tile_side_plain`` for the contract."""
    if a.device.type == "cpu":
        return tile_side_plain(a, with_eq)
    cuda_lib.check_cuda_int32("tile_side", a)
    s = a.shape[0]
    if s % T:
        raise ValueError(f"tile_side: length {s} is not a multiple of {T}")
    psv_g, psv_val, nxt = (torch.empty_like(a) for _ in range(3))
    chain, spine = (torch.empty(s, dtype=torch.bool, device=a.device)
                    for _ in range(2))
    e_g, h_in = ((torch.empty_like(a), torch.empty_like(a)) if with_eq
                 else (None, None))
    ptrs = [t.data_ptr() if t is not None else None
            for t in (a, psv_g, psv_val, chain, spine, nxt, e_g, h_in)]
    cuda_lib.launch("psac_tansv_tile", *ptrs, s // T, int(with_eq),
                    device=a.device)
    cuda_lib.count_launch(tile_side)
    return psv_g, psv_val, chain, spine, nxt, e_g, h_in


tile_side.launches = 0


def spine_streams(x: torch.Tensor, spine_f: torch.Tensor,
                  spine_n: torch.Tensor):
    """The two spines (of ``x`` and of its reverse) as (index, value)
    streams in index order, both padded with (I32_INF, I32_INF) (inert in
    the scan) to one length: the larger spine rounded up to CHUNK.

    Returns (kf, vf, kn, vn).  The JAX engine scans a fixed s / 16 rows;
    scanning only up to the spine length gives the same answers."""
    pos = [torch.nonzero(sp).squeeze(1) for sp in (spine_f, spine_n)]
    longest = max(p.shape[0] for p in pos)
    m = max(CHUNK, -(-longest // CHUNK) * CHUNK)
    out = []
    for a, p in zip((x, x.flip(0)), pos):
        keys = a.new_full((m,), I32_INF)
        vals = a.new_full((m,), I32_INF)
        keys[:p.shape[0]] = p.to(torch.int32)
        vals[:p.shape[0]] = a[p]
        out += [keys, vals]
    return tuple(out)


def _scatter_back(keys: torch.Tensor, vals_list, s: int):
    """Per-spine-row answers to (s,) tensors, 0 off the spine."""
    pos = torch.where(keys != I32_INF, keys.long(), s)
    outs = []
    for v in vals_list:
        out = v.new_zeros(s + 1)
        out[pos] = v
        outs.append(out[:s])
    return outs


def _onehot_rows(values_list, sel_local: torch.Tensor, fills):
    """r_k[i] = values_k[tile_base(i) + sel_local[i]], ``fills[k]`` where
    sel_local is outside [0, T)."""
    s = sel_local.shape[0]
    tile_base = torch.arange(s, device=sel_local.device) // T * T
    ok = (sel_local >= 0) & (sel_local < T)
    src = tile_base + sel_local.clamp(0, T - 1).long()
    return [torch.where(ok, v[src], fill)
            for v, fill in zip(values_list, fills)]


def tansv_feq_nsm(x: torch.Tensor, side=tile_side, scan=nsv_scan_spine):
    """Both-sides matches of (s,) int32 ``x`` (s a multiple of CHUNK):
    FURTHEST_EQ left and NEAREST_SM right in reversed coordinates.

    Returns (lidx, lval, ridx_r, rval_r): idx = -1 when no match; the
    right side indexes the reversed array.  ``side`` and ``scan`` are the
    tile phase (K4) and the spine scan (K1): the kernel wrappers, or their
    plain versions when the kernels are being checked.
    """
    s = x.shape[0]
    if s % CHUNK or s == 0:
        raise ValueError(f"tansv_feq_nsm: length {s} is not a positive "
                         f"multiple of {CHUNK}")
    xr = x.flip(0)

    psv_g, psv_val, chain_f, spine_f, nxt_f, e_g, h_in = side(x, True)
    npsv_g, npsv_val, chain_n, spine_n, nxt_n, _, _ = side(xr, False)

    kf, vf, kn, vn = spine_streams(x, spine_f, spine_n)
    fi, fv, fh, ni, nv = scan(vf, kf, vn, kn)
    f_scan, fval_scan, h_scan = _scatter_back(kf, (fi, fv, fh), s)
    n_scan, nval_scan = _scatter_back(kn, (ni, nv), s)

    # ---- furthest_eq combine: chain-run interiors read their run last's
    # scan answer (the next spine member); case-3 run heads read H at jstar
    (f_fill,) = _onehot_rows((f_scan,), nxt_f, (-1,))
    f_chain = torch.where(spine_f, f_scan, f_fill)
    fval_chain = torch.where(spine_f, fval_scan, x)  # interiors: case 2, v
    psv_local = torch.where(chain_f, -1, psv_g % T)
    H = torch.where(chain_f, h_scan, h_in)
    (f3,) = _onehot_rows((H,), psv_local, (-1,))
    case2 = e_g != I32_INF
    lidx = torch.where(chain_f, f_chain, torch.where(case2, e_g, f3))
    lval = torch.where(chain_f, fval_chain, torch.where(case2, x, psv_val))
    lval = torch.where(lidx < 0, 0, lval)

    # ---- nearest_sm combine (reversed coordinates)
    n_fill, nval_fill = _onehot_rows((n_scan, nval_scan), nxt_n, (-1, 0))
    n_chain = torch.where(spine_n, n_scan, n_fill)
    nval_chain = torch.where(spine_n, nval_scan, nval_fill)
    ridx_r = torch.where(chain_n, n_chain, npsv_g)
    rval_r = torch.where(chain_n, nval_chain, npsv_val)
    rval_r = torch.where(ridx_r < 0, 0, rval_r)
    return lidx, lval, ridx_r, rval_r
