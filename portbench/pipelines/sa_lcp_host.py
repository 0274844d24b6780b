"""The library's ``build_suffix_array`` (psac ``psac -l -o``'s arrays):
each build goes from the host ``bytes`` of the text to host int64 SA and
LCP arrays, ``encode_and_shard`` -> ``construct_device`` ->
``DeviceSuffixArray.materialize``.  Builds run back to back; the previous
build's arrays are dropped before the next starts."""

from __future__ import annotations

import dataclasses

from psac_tpu_torch.config import SAConfig
from psac_tpu_torch.models.suffix_array import (construct_device,
                                                encode_and_shard)

from portbench.harness.spans import Recorder

REFERENCE = "index_outputs"
OUTPUTS = frozenset({"sa", "lcp"})


@dataclasses.dataclass
class State:
    text: bytes
    config: SAConfig
    device: object
    sync: object
    last: object = None
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
    step(st, rec)  # the warm-up build
    return st


def step(st: State, rec: Recorder) -> dict:
    st.last = None
    with rec.span("stage"):
        xs, alpha, n, N = encode_and_shard(st.text, st.device)
    with rec.span("sa_lcp"):
        dsa = construct_device(xs, alpha, n, N, st.config)
    del xs
    with rec.span("materialize"):
        st.last = dsa.materialize()
    st.N = N
    return {"count": 1, "bytes": n}


def facts(st: State) -> dict:
    return {"n": len(st.text), "N": st.N}


def outputs(st: State) -> dict:
    return {"sa": st.last.sa, "lcp": st.last.lcp}


def release(st: State) -> None:
    st.last = None
