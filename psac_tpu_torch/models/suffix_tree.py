"""Suffix tree from SA+LCP (port of ``psac_tpu/models/suffix_tree.py``).

The reference's flat representation: one potential internal node per LCP
entry, sigma+1 child slots per node (slot 0 = the ``$`` edge);
``nodes[i][c]`` = id of the child reached from internal node ``i`` by an
edge starting with character ``c``.  Node ids: internal node = its LCP
index (root = 0), leaf for SA row j = ``n + j``.  Parent edges follow the
reference's ``for_each_parent`` (``include/suffix_tree.hpp:44-223``) from
one ANSV pass (FURTHEST_EQ left, NEAREST_SM right), then one character
gather and one (row, slot) scatter into the (N * (sigma+1),) table.
Padding rows (the first N - n) take LCP -1 and emit no edges.

On a mesh of p > 1 shards (JAX ``:71-170, 263-291``) the ANSV pass is
``parallel.ansv.ansv_mesh_local`` (K5 in every shard, the walks for the
routed queries), the edge characters are gathered from the shards that
hold them by ``route_apply``, and the (row, slot) writes go to the rows'
shards by ``route_scatter``; the routing runs at capscale 6 and is redone
without a bound when it overflows.

The generalized suffix tree of a string set (``construct_gst_device``,
``build_gst``) has sigma+2 slots per node: slots 0-1 hold the (min, max)
child-id range of the node's ``$``-edges, slot c+1 the char-c edge, and
edges at root depth are not recorded.  It is one shard function
(``_gst``) for every p, as the tree's (``_st``), with the same capscale
retry.  A build's spans: ``psac.st`` (the call) > ``psac.st.ansv`` (the
ANSV pass and its input), ``psac.st.nodes`` (the edges, the character
gather, the table's scatter and the overflow readback); the generalized
tree's: ``psac.gst`` (the call) > ``psac.st.ansv``, ``psac.gst.nodes``
(the edges, the character gather, the table's scatter) and
``psac.gst.dollar`` (the ``$``-edges' run ends and slot 0), with the
counter ``gst_dollar_edges``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from psac_tpu_torch.config import SAConfig
from psac_tpu_torch.models.suffix_array import (DeviceSuffixArray,
                                                construct_device, device_of,
                                                encode_and_shard, host_int64)
from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_SM
from psac_tpu_torch.parallel.ansv import (KERNELS, AnsvKernels, ansv_local,
                                          ansv_mesh_local, nonsv_for)
from psac_tpu_torch.parallel.collectives import (global_index_base,
                                                 next_of, prev_of)
from psac_tpu_torch.parallel.mesh import Rep, num_shards, run_on
from psac_tpu_torch.parallel.route import (cap_for, gather_global,
                                           route_scatter)
from psac_tpu_torch.utils import timers


@dataclasses.dataclass
class DeviceSuffixTree:
    """Flat node table ((N * (sigma+1),) in the SA's index dtype; padding
    rows unused; ``Sharded`` by rows on a mesh)."""

    nodes: torch.Tensor
    sigma: int
    n: int
    N: int

    def materialize(self) -> np.ndarray:
        """The real rows of the table, (n, sigma + 1), as a host int64
        array (``host_int64``: from a card, in pinned host memory that
        torch's host cache keeps for reuse once it is dropped)."""
        (nodes,) = host_int64(self.nodes, cut=self.N - self.n,
                              width=self.sigma + 1)
        return nodes


def _check_local_table(N: int, width: int, idt: torch.dtype) -> None:
    """The node table is addressed per shard: N is a shard's rows here."""
    if N * width >= (1 << 31) and idt != torch.int64:
        raise ValueError(
            f"node table N*width = {N * width} exceeds int32 addressing on an "
            f"int32 build; use force_int64 (or more shards)")


def _parent_nsv(ctx, lcp, n: int, capscale, kernels: AnsvKernels):
    """The ANSV pass of ``for_each_parent`` on this shard's rows, in a
    ``psac.st.ansv`` span: the LCP with padding rows at -1 (``lcp_adj``),
    the rows' global indices, the offset of the first real row, the real
    rows' mask, the (FURTHEST_EQ left, NEAREST_SM right) answers and the
    pass's overflow count (0 on one device, whose ANSV engines route
    nothing)."""
    with timers.span("psac.st.ansv", lcp.device):
        idt = lcp.dtype
        s = lcp.shape[0]
        off = s * (1 if ctx is None else ctx.p) - n
        base = global_index_base(s, ctx)
        g = torch.arange(base, base + s, dtype=idt, device=lcp.device)
        is_real = g >= off
        lcp_adj = torch.where(is_real, lcp, -1)
        lcp_adj = torch.where(g == off, 0, lcp_adj)
        if ctx is None:
            ans = ansv_local(lcp_adj, FURTHEST_EQ, NEAREST_SM, kernels)
            ovf = 0
        else:
            *ans, ovf = ansv_mesh_local(ctx, lcp_adj, FURTHEST_EQ,
                                        NEAREST_SM, capscale, kernels)
        return lcp_adj, g, off, is_real, tuple(ans), ovf


def _parent_edges(ctx, nsv, sa, n: int):
    """``for_each_parent`` on this shard's rows (JAX ``_parent_edges``)
    from ``_parent_nsv``'s pass: per-edge (parents, childs, elcp, savals,
    valid), each of length 2s (leaf edges, then internal-node edges)."""
    lcp_adj, g, off, is_real, (lidx, lval, ridx, rval), _ = nsv
    inf = nonsv_for(lcp_adj.dtype)
    # the globally last element always takes the left case (fill 0 <= lcp)
    lcp_next = next_of(lcp_adj, 0, ctx)

    # ---- leaf edges (one per real position)
    left_case = lcp_adj >= lcp_next
    dup = (lval == lcp_adj) & (lidx != inf)
    leaf_parent = torch.where(left_case, torch.where(dup, lidx, g), g + 1)
    leaf_elcp = torch.where(left_case, lcp_adj, lcp_next)
    leaf_child = n + (g - off)

    # ---- internal-node edges
    use_left = (ridx == inf) | (lval >= rval)
    int_parent = torch.where(use_left, lidx, ridx)
    int_elcp = torch.where(use_left, lval, rval)
    int_child = g - off
    int_valid = is_real & (g > off) & (lcp_adj > 0) & (lval != lcp_adj)

    return (torch.cat([leaf_parent, int_parent]),
            torch.cat([leaf_child, int_child]),
            torch.cat([leaf_elcp, int_elcp]),
            torch.cat([sa, sa]),
            torch.cat([is_real, int_valid]))


def _st(ctx, lcp, sa, xs, n: int, sigma: int, capscale, kernels):
    """This shard's (s * (sigma+1),) rows of the node table, and the
    replicated overflow count of its routing (JAX ``_st_local``)."""
    p = 1 if ctx is None else ctx.p
    nsv = _parent_nsv(ctx, lcp, n, capscale, kernels)
    with timers.span("psac.st.nodes", lcp.device):
        parents, childs, elcp, savals, valid = _parent_edges(ctx, nsv, sa, n)
        ovf = nsv[-1]
        del nsv  # the ANSV's arrays, freed before the gather and scatter
        # first character of each edge (slot 0 past the end of the text)
        char_idx = savals + elcp
        dollar = char_idx >= n
        ch, ovf_g = gather_global(xs, char_idx, valid & ~dollar, ctx=ctx,
                                  cap=cap_for(char_idx.shape[0], p, capscale),
                                  with_overflow=True)
        width = sigma + 1
        nodes = torch.zeros(lcp.shape[0] * width, dtype=lcp.dtype,
                            device=lcp.device)
        (nodes,), ovf_s = route_scatter(
            parents, (childs,), (nodes,), valid, width=width,
            slots=torch.where(dollar, 0, ch), ctx=ctx,
            cap=cap_for(parents.shape[0], p, capscale), with_overflow=True)
        ovf = int(ovf + ovf_g + ovf_s)
        timers.readback()
    return nodes, Rep(ovf)


def construct_suffix_tree_device(dsa: DeviceSuffixArray, xs,
                                 mesh=None) -> DeviceSuffixTree:
    """Flat suffix tree from a device-resident SA+LCP and the encoded padded
    text ``xs`` (as ``encode_and_shard`` gives it); on the SA's mesh (or
    ``mesh``) when it has one."""
    return _st_local(dsa, xs, KERNELS, mesh)


def _st_local(dsa: DeviceSuffixArray, xs, kernels: AnsvKernels,
              mesh=None) -> DeviceSuffixTree:
    """``construct_suffix_tree_device`` with its ANSV functions given
    (``parallel.ansv.PLAIN`` builds the plain reference tree, with K5's
    plain version on a mesh).  On a mesh the routing runs at capscale 6
    first and without a bound when that overflows (JAX
    ``construct_suffix_tree_device``)."""
    if dsa.lcp is None:
        raise ValueError("suffix tree construction requires the LCP array")
    mesh = mesh or dsa.mesh
    if mesh is not None and mesh.p == 1:
        mesh = None
    sigma = dsa.alphabet.sigma
    _check_local_table(dsa.N // num_shards(mesh), sigma + 1, dsa.sa.dtype)
    with timers.call("psac.st", device_of(dsa.lcp), n=dsa.n):
        for capscale in (6, None):
            nodes, ovf = run_on(mesh, _st, dsa.lcp, dsa.sa, xs, dsa.n, sigma,
                                capscale, kernels)
            if capscale is None or ovf == 0:
                break
    return DeviceSuffixTree(nodes=nodes, sigma=sigma, n=dsa.n, N=dsa.N)


def _start_bits(eos, n: int, ctx=None) -> torch.Tensor:
    """(s,) bool of this shard's positions: g < n is the first of its
    string.  Position n and the padding beyond carry no bit (their eos is
    their own index, so eos[n - 1] == n would otherwise read as a start)."""
    s = eos.shape[0]
    base = global_index_base(s, ctx)
    g = torch.arange(base, base + s, dtype=eos.dtype, device=eos.device)
    return (g < n) & ((g == 0) | (prev_of(eos, fill=0, ctx=ctx) == g))


def _gst(ctx, lcp, sa, xs, eos, n: int, sigma: int, capscale, kernels):
    """This shard's (s * (sigma+2),) rows of the generalized tree's node
    table (reference ``construct_gst``, ``include/suffix_tree.hpp:521-608``;
    JAX ``_gst_local``), and the replicated overflow count of its routing
    at ``capscale``."""
    p = 1 if ctx is None else ctx.p
    s, idt = lcp.shape[0], lcp.dtype
    width = sigma + 2
    nsv = _parent_nsv(ctx, lcp, n, capscale, kernels)
    with timers.span("psac.gst.nodes", lcp.device):
        parents, childs, elcp, savals, valid = _parent_edges(ctx, nsv, sa, n)
        off, ovf = nsv[2], nsv[-1]
        del nsv  # the ANSV's arrays, freed before the gathers and scatters
        # ``$``-edge test without an eos[SA[i]] gather: every recorded edge
        # has depth elcp >= 1 and elcp <= eos[SA[i]] - SA[i], so SA[i] +
        # elcp lies in (SA[i], eos[SA[i]]]: inside SA[i]'s own string
        # unless it IS the string's end, and a string end below n is the
        # next string's start.  So ``$`` <=> SA[i] + elcp is a string
        # start, or is n.  The start bit rides on the gathered text: one
        # gather answers char and ``$`` test.
        xz = xs + (sigma + 1) * _start_bits(eos, n, ctx).to(xs.dtype)
        char_idx = savals + elcp
        dollar_end = char_idx >= n
        valid_q = valid & (elcp != 0)  # root-depth edges are not recorded
        cap = cap_for(2 * s, p, capscale)
        chz, ovf_g = gather_global(xz, char_idx, valid_q & ~dollar_end,
                                   ctx=ctx, cap=cap, with_overflow=True)
        del xz, char_idx
    with timers.span("psac.gst.dollar", lcp.device):
        # A node's ``$``-children are the leaves whose suffixes end at its
        # depth d: identical whole suffixes, which sort first in its
        # interval [lb, rb], so they are the leaves of rows lb, lb + 1, ...
        # in a run, and the node's id is lb + 1 (the LCP there is d).  So
        # their (min, max) child ids are (n + id - 1, the run's last leaf):
        # the last leaf of each run writes slot 1 in the table's one
        # scatter (one place a node), and slot 0 follows from slot 1.  No
        # reducing scatter and no compaction: they are not few, at 32x read
        # coverage 81% of the leaves (120,950,968 of 150 M counted as
        # ``gst_dollar_edges``).
        dollar = valid_q & (dollar_end | (chz > sigma))
        if timers.current() is not None:
            timers.count("gst_dollar_edges", dollar.sum())
        ld, lp = dollar[:s], parents[:s]  # only leaf edges end in ``$``
        run_end = ld & ~(next_of(ld, False, ctx) & (next_of(lp, -1, ctx)
                                                   == lp))
        write = (valid_q & ~dollar) | torch.cat(
            [run_end, torch.zeros_like(run_end)])
        slots = torch.where(dollar, 1, chz + 1)
        del dollar, ld, lp, run_end, chz
    with timers.span("psac.gst.nodes", lcp.device):
        nodes = torch.zeros(s * width, dtype=idt, device=lcp.device)
        (nodes,), ovf_s = route_scatter(
            parents, (childs,), (nodes,), write, width=width, slots=slots,
            ctx=ctx, cap=cap, with_overflow=True)
    with timers.span("psac.gst.dollar", lcp.device):
        table = nodes.view(s, width)
        base = global_index_base(s, ctx)
        g = torch.arange(base, base + s, dtype=idt, device=lcp.device)
        table[:, 0] = torch.where(table[:, 1] != 0, n + (g - off) - 1, 0)
    return nodes, Rep(int(ovf + ovf_g + ovf_s))


def _gst_local(dgsa, kernels: AnsvKernels) -> DeviceSuffixTree:
    """Generalized suffix tree node table of a ``models.gsa.DeviceGSA``, on
    its device or its mesh, with its ANSV functions given
    (``parallel.ansv.PLAIN`` builds the plain reference tree).  On a mesh
    the routing runs at capscale 6 first and without a bound when that
    overflows."""
    if dgsa.lcp is None:
        raise ValueError("GST construction requires the GLCP array")
    mesh = dgsa.mesh
    if mesh is not None and mesh.p == 1:
        mesh = None
    sigma = dgsa.alphabet.sigma
    _check_local_table(dgsa.N // num_shards(mesh), sigma + 2, dgsa.sa.dtype)
    with timers.call("psac.gst", device_of(dgsa.lcp), n=dgsa.n):
        for capscale in (6, None):
            nodes, ovf = run_on(mesh, _gst, dgsa.lcp, dgsa.sa, dgsa.xs,
                                dgsa.eos, dgsa.n, sigma, capscale, kernels)
            if capscale is None or ovf == 0:
                break
    return DeviceSuffixTree(nodes=nodes, sigma=sigma + 1, n=dgsa.n, N=dgsa.N)


def construct_gst_device(dgsa) -> DeviceSuffixTree:
    """Generalized suffix tree from a device-resident GSA (+GLCP), a
    ``models.gsa.DeviceGSA``, on its device or on its mesh
    (``dgsa.mesh``)."""
    return _gst_local(dgsa, KERNELS)


def build_suffix_tree(text, device=None, config=None,
                      mesh=None) -> np.ndarray:
    """SA+LCP construction + suffix tree of ``text`` on ``device`` (None:
    the CUDA card; ``"cpu"`` runs the plain versions) or on the p shards of
    ``mesh``; returns the (n, sigma+1) int64 node table (the reference's
    ``psac -t``)."""
    xs, alpha, n, N = encode_and_shard(text, device, mesh)
    dsa = construct_device(xs, alpha, n, N, config or SAConfig(), mesh)
    return construct_suffix_tree_device(dsa, xs).materialize()


def build_gst(strings, device=None, config=None, mesh=None) -> np.ndarray:
    """GSA construction + generalized suffix tree of a string set on
    ``device`` (None: the CUDA card; ``"cpu"`` runs the plain versions) or
    on the p shards of ``mesh``; returns the (n, sigma+2) int64 node
    table."""
    from psac_tpu_torch.models.gsa import build_gsa_device

    return construct_gst_device(build_gsa_device(
        strings, device, config or SAConfig(), mesh)).materialize()
