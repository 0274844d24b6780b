"""The suffix-tree build (psac ``psac -t``): each build goes from the host
``bytes`` of the text to SA, LCP and the suffix-tree node table on the
card, ``encode_and_shard`` -> ``construct_device`` ->
``construct_suffix_tree_device``.  Builds run back to back; the previous
build's index is dropped before the next starts, so the card holds one
index at a time, as a deployment would."""

from __future__ import annotations

import dataclasses

from psac_tpu_torch.config import SAConfig
from psac_tpu_torch.models.suffix_array import (construct_device,
                                                encode_and_shard)
from psac_tpu_torch.models.suffix_tree import construct_suffix_tree_device

from portbench.harness.spans import Recorder

REFERENCE = "index_outputs"
OUTPUTS = frozenset({"sa", "lcp", "nodes"})


@dataclasses.dataclass
class State:
    text: bytes
    config: SAConfig
    device: object
    sync: object
    last: tuple | None = None
    N: int = 0


def inputs(config: dict, traffic: dict, seed: int, device, seconds: float,
           finder) -> dict:
    spec = traffic["text"]
    return {"text": finder.module("gen", spec["gen"]).make(spec, seed,
                                                             device)}


def setup(config: dict, traffic: dict, inputs: dict, device,
          rec: Recorder) -> State:
    st = State(text=inputs["text"], config=SAConfig(**config["sa_config"]),
               device=device, sync=rec.sync)
    step(st, rec)  # the warm-up build: every shape the window's builds use
    return st


def step(st: State, rec: Recorder) -> dict:
    st.last = None
    with rec.span("stage"):
        xs, alpha, n, N = encode_and_shard(st.text, st.device)
    with rec.span("sa_lcp"):
        dsa = construct_device(xs, alpha, n, N, st.config)
    with rec.span("st"):
        tree = construct_suffix_tree_device(dsa, xs)
    del xs
    st.sync()
    st.last, st.N = (dsa, tree), N
    return {"count": 1, "bytes": n}


def facts(st: State) -> dict:
    return {"n": len(st.text), "N": st.N}


def outputs(st: State) -> dict:
    """The last build's SA, LCP and node table, real rows only."""
    dsa, tree = st.last
    cut = dsa.N - dsa.n
    return {"sa": dsa.sa[cut:], "lcp": dsa.lcp[cut:],
            "nodes": tree.nodes.view(tree.N, tree.sigma + 1)[cut:]}


def release(st: State) -> None:
    st.last = None
