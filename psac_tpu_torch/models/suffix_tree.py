"""Suffix tree from SA+LCP on one device (port of
``psac_tpu/models/suffix_tree.py`` at p = 1).

The reference's flat representation: one potential internal node per LCP
entry, sigma+1 child slots per node (slot 0 = the ``$`` edge);
``nodes[i][c]`` = id of the child reached from internal node ``i`` by an
edge starting with character ``c``.  Node ids: internal node = its LCP
index (root = 0), leaf for SA row j = ``n + j``.  Parent edges follow the
reference's ``for_each_parent`` (``include/suffix_tree.hpp:44-223``) from
one ANSV pass (FURTHEST_EQ left, NEAREST_SM right), then one character
gather and one (row, slot) scatter into the (N * (sigma+1),) table.
Padding rows (the first N - n) take LCP -1 and emit no edges.

The generalized suffix tree of a string set (``construct_gst_device``,
``build_gst``) has sigma+2 slots per node: slots 0-1 hold the (min, max)
child-id range of the node's ``$``-edges, slot c+1 the char-c edge, and
edges at root depth are not recorded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from psac_tpu_torch.models.suffix_array import (DeviceSuffixArray,
                                                construct_device,
                                                encode_and_shard)
from psac_tpu_torch.ops.ansv import FURTHEST_EQ, NEAREST_SM
from psac_tpu_torch.parallel.ansv import (KERNELS, AnsvKernels, ansv_local,
                                          nonsv_for)
from psac_tpu_torch.parallel.collectives import halo_from_right, prev_of
from psac_tpu_torch.parallel.route import route_scatter


@dataclasses.dataclass
class DeviceSuffixTree:
    """Flat node table ((N * (sigma+1),) in the SA's index dtype; padding
    rows unused)."""

    nodes: torch.Tensor
    sigma: int
    n: int
    N: int

    def materialize(self) -> np.ndarray:
        full = self.nodes.view(self.N, self.sigma + 1)[self.N - self.n:]
        return full.cpu().numpy().astype(np.int64)


def _parent_edges(lcp, sa, n: int, kernels: AnsvKernels):
    """``for_each_parent``: per-edge (parents, childs, elcp, savals, valid),
    each of length 2N (leaf edges, then internal-node edges)."""
    idt = lcp.dtype
    inf = nonsv_for(idt)
    N = lcp.shape[0]
    off = N - n
    g = torch.arange(N, dtype=idt, device=lcp.device)
    is_real = g >= off
    lcp_adj = torch.where(is_real, lcp, -1)
    lcp_adj = torch.where(g == off, 0, lcp_adj)

    lidx, lval, ridx, rval = ansv_local(lcp_adj, FURTHEST_EQ, NEAREST_SM,
                                        kernels)
    # the last element always takes the left case (fill 0 <= lcp)
    lcp_next = torch.cat([lcp_adj[1:], halo_from_right(lcp_adj, 1)])

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


def _gather_from(arr, idx, valid):
    """arr[idx] where ``valid``, 0 elsewhere."""
    safe = torch.where(valid, idx, 0).clamp(0, arr.shape[0] - 1)
    return torch.where(valid, arr[safe], 0)


def _check_local_table(N: int, width: int, idt: torch.dtype) -> None:
    if N * width >= (1 << 31) and idt != torch.int64:
        raise ValueError(
            f"node table N*width = {N * width} exceeds int32 addressing on an "
            f"int32 build; use force_int64")


def construct_suffix_tree_device(dsa: DeviceSuffixArray,
                                 xs) -> DeviceSuffixTree:
    """Flat suffix tree from a device-resident SA+LCP and the encoded padded
    text ``xs`` (as ``encode_and_shard`` gives it)."""
    return _st_local(dsa, xs, KERNELS)


def _st_local(dsa: DeviceSuffixArray, xs,
              kernels: AnsvKernels) -> DeviceSuffixTree:
    """``construct_suffix_tree_device`` with its ANSV functions given
    (``parallel.ansv.PLAIN`` builds the plain reference tree)."""
    if dsa.lcp is None:
        raise ValueError("suffix tree construction requires the LCP array")
    n, N = dsa.n, dsa.N
    sigma = dsa.alphabet.sigma
    idt = dsa.sa.dtype
    width = sigma + 1
    _check_local_table(N, width, idt)
    parents, childs, elcp, savals, valid = _parent_edges(dsa.lcp, dsa.sa, n,
                                                         kernels)
    # first character of each edge (slot 0 past the end of the text)
    char_idx = savals + elcp
    dollar = char_idx >= n
    ch = _gather_from(xs, char_idx, valid & ~dollar)
    slot = torch.where(dollar, 0, ch)
    nodes = torch.zeros(N * width, dtype=idt, device=dsa.sa.device)
    (nodes,) = route_scatter(parents, (childs,), (nodes,), valid,
                             width=width, slots=slot)
    return DeviceSuffixTree(nodes=nodes, sigma=sigma, n=n, N=N)


def _start_bits(eos, n: int) -> torch.Tensor:
    """(N,) bool: position g < n is the first of its string.  Position n
    and the padding beyond carry no bit (their eos is their own index, so
    eos[n - 1] == n would otherwise read as a start)."""
    g = torch.arange(eos.shape[0], dtype=eos.dtype, device=eos.device)
    return (g < n) & ((g == 0) | (prev_of(eos, fill=0) == g))


def _gst_local(dgsa, kernels: AnsvKernels) -> DeviceSuffixTree:
    """Generalized suffix tree node table (reference ``construct_gst``,
    ``include/suffix_tree.hpp:521-608``) with its ANSV functions given
    (``parallel.ansv.PLAIN`` builds the plain reference tree)."""
    if dgsa.lcp is None:
        raise ValueError("GST construction requires the GLCP array")
    n, N = dgsa.n, dgsa.N
    sigma = dgsa.alphabet.sigma
    idt = dgsa.sa.dtype
    width = sigma + 2
    _check_local_table(N, width, idt)
    inf = torch.iinfo(idt).max
    parents, childs, elcp, savals, valid = _parent_edges(dgsa.lcp, dgsa.sa, n,
                                                         kernels)
    # ``$``-edge test without an eos[SA[i]] gather: every recorded edge has
    # depth elcp >= 1 and elcp <= eos[SA[i]] - SA[i], so SA[i] + elcp lies
    # in (SA[i], eos[SA[i]]]: inside SA[i]'s own string unless it IS the
    # string's end, and a string end below n is the next string's start.
    # So ``$`` <=> SA[i] + elcp is a string start, or is n.  The start bit
    # rides on the gathered text: one gather answers char and ``$`` test.
    xz = dgsa.xs + (sigma + 1) * _start_bits(dgsa.eos, n).to(dgsa.xs.dtype)
    char_idx = savals + elcp
    dollar_end = char_idx >= n
    valid_q = valid & (elcp != 0)  # root-depth edges are not recorded
    chz = _gather_from(xz, char_idx, valid_q & ~dollar_end)
    dollar = dollar_end | (chz > sigma)

    # slot 0 accumulates a min: it starts at INF and goes back to 0 where
    # no ``$``-edge landed
    nodes = torch.zeros(N, width, dtype=idt, device=dgsa.sa.device)
    nodes[:, 0] = inf
    nodes = nodes.view(-1)
    (nodes,) = route_scatter(parents, (childs,), (nodes,), valid_q & ~dollar,
                             width=width, slots=chz + 1)
    # many ``$``-edges may meet at one node, so they go through the reducing
    # scatter, compacted by mask first (they are few beside the 2N rows)
    at = torch.nonzero(valid_q & dollar).squeeze(1)
    rows, kids = parents[at], childs[at]
    every = torch.ones_like(rows, dtype=torch.bool)
    for slot, how in ((0, "min"), (1, "max")):
        (nodes,) = route_scatter(rows, (kids,), (nodes,), every, width=width,
                                 slots=torch.full_like(rows, slot),
                                 combine=(how,))
    table = nodes.view(N, width)
    table[:, 0] = torch.where(table[:, 0] == inf, 0, table[:, 0])
    return DeviceSuffixTree(nodes=nodes, sigma=sigma + 1, n=n, N=N)


def construct_gst_device(dgsa) -> DeviceSuffixTree:
    """Generalized suffix tree from a device-resident GSA (+GLCP), a
    ``models.gsa.DeviceGSA``."""
    return _gst_local(dgsa, KERNELS)


def build_suffix_tree(text, device=None, config=None) -> np.ndarray:
    """SA+LCP construction + suffix tree of ``text`` on ``device`` (None:
    the CUDA card; ``"cpu"`` runs the plain versions); returns the
    (n, sigma+1) int64 node table (the reference's ``psac -t``)."""
    xs, alpha, n, N = encode_and_shard(text, device)
    kw = {} if config is None else {"config": config}
    dsa = construct_device(xs, alpha, n, N, **kw)
    return construct_suffix_tree_device(dsa, xs).materialize()


def build_gst(strings, device=None, config=None) -> np.ndarray:
    """GSA construction + generalized suffix tree of a string set on
    ``device`` (None: the CUDA card; ``"cpu"`` runs the plain versions);
    returns the (n, sigma+2) int64 node table."""
    from psac_tpu_torch.models.gsa import build_gsa_device

    kw = {} if config is None else {"config": config}
    return construct_gst_device(
        build_gsa_device(strings, device, **kw)).materialize()
