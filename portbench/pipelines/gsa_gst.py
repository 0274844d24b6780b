"""The read set's index (psac ``gsac -f``, then ``construct_gst``): each
build goes from the host ``bytes`` of the newline-separated reads to the
generalized suffix array, its LCP and the generalized suffix tree's node
table on the card, ``build_gsa_device`` -> ``construct_gst_device``.
Builds run back to back; the previous build's index is dropped before the
next starts, so the card holds one index at a time, as a deployment would.
A step's bytes are the read characters, without the newlines."""

from __future__ import annotations

import dataclasses

from psac_tpu_torch.config import SAConfig
from psac_tpu_torch.models.gsa import build_gsa_device
from psac_tpu_torch.models.suffix_tree import construct_gst_device

from portbench.harness.spans import Recorder

REFERENCE = "gsa_outputs"
OUTPUTS = frozenset({"gsa", "glcp", "gst"})
#: the program's counters of a build, with the call span that holds them
COUNTERS = {"gsa_strings": "psac.gsa", "gsa_tie_rows": "psac.gsa",
            "gsa_redo": "psac.gsa", "gst_dollar_edges": "psac.gst"}


@dataclasses.dataclass
class State:
    reads: bytes
    config: SAConfig
    device: object
    sync: object
    last: tuple | None = None
    n: int = 0
    N: int = 0
    strings: int = 0


def inputs(config: dict, traffic: dict, seed: int, device, seconds: float,
           finder) -> dict:
    spec = traffic["text"]
    return {"reads": finder.module("gen", spec["gen"]).make(spec, seed,
                                                              device)}


def setup(config: dict, traffic: dict, inputs: dict, device,
          rec: Recorder) -> State:
    st = State(reads=inputs["reads"], config=SAConfig(**config["sa_config"]),
               device=device, sync=rec.sync)
    step(st, rec)  # the warm-up build: every shape the window's builds use
    return st


def step(st: State, rec: Recorder) -> dict:
    st.last = None
    with rec.span("gsa"):
        dgsa = build_gsa_device(st.reads, st.device, st.config)
    with rec.span("gst"):
        tree = construct_gst_device(dgsa)
    st.sync()
    st.last = (dgsa, tree)
    st.n, st.N, st.strings = dgsa.n, dgsa.N, len(dgsa.lens)
    return {"count": 1, "bytes": dgsa.n}


def _counters() -> dict:
    """Each of the program's counters as (least, most) over the traced
    builds; none on an untraced run or a program without them."""
    try:
        from psac_tpu_torch.utils.timers import records
    except ImportError:
        return {}
    recs = records()
    out = {}
    for name, root in COUNTERS.items():
        per = {r.id: 0 for r in recs if r.name == root and r.id == r.root}
        for r in recs:
            if r.root in per:
                per[r.root] += r.counts.get(name, 0)
        if per:
            out[name] = (min(per.values()), max(per.values()))
    return out


def facts(st: State) -> dict:
    return {"n": st.n, "N": st.N, "strings": st.strings, **_counters()}


def outputs(st: State) -> dict:
    """The last build's GSA, GLCP and GST node table, real rows only."""
    dgsa, tree = st.last
    cut = dgsa.N - dgsa.n
    return {"gsa": dgsa.sa[cut:], "glcp": dgsa.lcp[cut:],
            "gst": tree.nodes.view(tree.N, tree.sigma + 1)[cut:]}


def release(st: State) -> None:
    st.last = None
