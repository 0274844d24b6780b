"""The comparison that decides ``correct`` in the index cells: the SA,
the LCP array and, where the pipeline built one, the suffix-tree node
table that the window's last build produced, each entry against the plain
reference's own (``suffix_array``, ``suffix_tree`` beside this file),
worked out from the text alone.  Every number is a count of wrong entries
and its limit is 0: the configuration guarantees exact arrays.

The control (``control``) puts the reference in the program's place with
one guarantee broken: suffixes sorted by their first ``CONTROL_DEPTH``
characters only (ties left in text order, LCPs capped there), the
k-mer init's depth without the doubling after it."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import suffix_array as ref_sa
from portbench.reference import suffix_tree as ref_st

CONTROL_DEPTH = 20


def _on(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def _reference(text: bytes, device, depth=None):
    t = ref_sa.text_tensor(text, device)
    codes, sigma = ref_sa.encode(t)
    del t
    sa, levels = ref_sa.suffix_array(codes, sigma, depth)
    lcp = ref_sa.lcp_array(codes, sa, levels, cap=depth)
    del levels
    return codes, sigma, sa, lcp


def _wrong(got, want) -> int:
    """Entries of ``got`` (any device, dtype) unequal to ``want``'s."""
    got = _on(got, want.device).reshape(want.shape)
    if got.dtype != want.dtype:
        got, want = got.to(torch.int64), want.to(torch.int64)
    return int((got != want).sum())


def check(inputs: dict, outputs: dict, device) -> tuple[list[dict], int]:
    """(checks, failed): each number with its limit, and 1 when the build
    compared is wrong anywhere."""
    codes, sigma, sa, lcp = _reference(inputs["text"], device)
    out = [{"name": "sa_rows_wrong", "value": _wrong(outputs["sa"], sa),
            "limit": 0}]
    got_lcp = _on(outputs["lcp"], device).clone()
    got_lcp[0] = 0
    out.append({"name": "lcp_rows_wrong", "value": _wrong(got_lcp, lcp),
                "limit": 0})
    del got_lcp
    if outputs.get("nodes") is not None:
        table = ref_st.node_table(codes, sa, lcp, sigma)
        out.append({"name": "st_slots_wrong",
                    "value": _wrong(outputs["nodes"], table), "limit": 0})
    return out, int(any(c["value"] > c["limit"] for c in out))


def control(inputs: dict, pipeline_outputs: set, device) -> dict:
    """The outputs a program would give that sorted suffixes by their
    first ``CONTROL_DEPTH`` characters only."""
    codes, sigma, sa, lcp = _reference(inputs["text"], device,
                                       depth=CONTROL_DEPTH)
    out = {"sa": sa, "lcp": lcp}
    if "nodes" in pipeline_outputs:
        out["nodes"] = ref_st.node_table(codes, sa, lcp, sigma)
    return out
