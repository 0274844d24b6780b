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
from psac_tpu_torch.parallel.collectives import halo_from_right
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


def build_suffix_tree(text, device, config=None) -> np.ndarray:
    """SA+LCP construction + suffix tree of ``text`` on ``device``; returns
    the (n, sigma+1) int64 node table (the reference's ``psac -t``)."""
    xs, alpha, n, N = encode_and_shard(text, device)
    kw = {} if config is None else {"config": config}
    dsa = construct_device(xs, alpha, n, N, **kw)
    return construct_suffix_tree_device(dsa, xs).materialize()
