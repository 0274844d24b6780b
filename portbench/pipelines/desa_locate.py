"""Seed lookups in a DESA (psac ``desa-main``): the index is built in
set-up with ``build_desa`` and held on the card; the window sends one
batch of patterns after another to ``DESA.bulk_locate`` (a closed loop),
each timed from the call to its ranges being on the host.  The batches
come from a pool drawn in set-up; the window takes them in order."""

from __future__ import annotations

import dataclasses
import time

from psac_tpu_torch.config import SAConfig
from psac_tpu_torch.models.desa import build_desa

from portbench.harness.spans import Recorder

REFERENCE = "locate_ranges"
OUTPUTS = frozenset({"batches", "ranges"})


@dataclasses.dataclass
class State:
    desa: object
    batches: list
    n: int
    N: int
    next: int = 1          # batch 0 warms up
    used: list = dataclasses.field(default_factory=list)
    ranges: list = dataclasses.field(default_factory=list)


def inputs(config: dict, traffic: dict, seed: int, device, seconds: float,
           finder) -> dict:
    spec = traffic["text"]
    text = finder.module("gen", spec["gen"]).make(spec, seed, device)
    pspec = traffic["patterns"]
    mat, batches = finder.module("gen", pspec["gen"]).make(
        pspec, text, seed, device, seconds)
    return {"text": text, "patterns": mat, "batches": batches}


def setup(config: dict, traffic: dict, inputs: dict, device,
          rec: Recorder) -> State:
    d = config["desa"]
    desa = build_desa(inputs["text"], device,
                      SAConfig(**config["sa_config"]),
                      tli_bits=d["tli_bits"], tli=d["tli"])
    encode = desa.encode_patterns

    def encode_in_span(patterns):
        with rec.span("encode"):
            return encode(patterns)

    # the span around the host's encoding, on this instance only
    desa.encode_patterns = encode_in_span
    st = State(desa=desa, batches=inputs["batches"], n=desa.n, N=desa.N)
    desa.bulk_locate(st.batches[0])
    return st


def step(st: State, rec: Recorder) -> dict:
    b = st.next % len(st.batches)
    st.next += 1
    batch = st.batches[b]
    t0 = time.perf_counter()
    ranges = st.desa.bulk_locate(batch)
    latency = time.perf_counter() - t0
    rec.count("search_steps", st.desa.last_stats["steps"])
    st.used.append(b)
    st.ranges.append(ranges)
    return {"count": len(batch), "patterns": len(batch),
            "latency_s": latency}


def facts(st: State) -> dict:
    return {"n": st.n, "N": st.N,
            "pool_wraps": max(0, st.next - 1) // len(st.batches)}


def outputs(st: State) -> dict:
    return {"batches": st.used, "ranges": st.ranges}


def release(st: State) -> None:
    st.desa = None
