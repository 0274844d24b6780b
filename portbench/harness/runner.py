"""One run of one cell: set-up, the measured window, the import guard,
the comparison with the plain reference, and the result line.

A run prints, as the last lines of standard error, each number compared
beside its limit, and as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import sys
import time

import torch

from portbench.harness import device as device_mod
from portbench.harness import guard, spec, trace as trace_mod
from portbench.harness.spans import Recorder


class Refused(RuntimeError):
    """A run that must print no result."""


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py::read``)."""

    workload: str
    config: dict
    traffic: dict
    units: list             # each step's dict: count, and bytes / patterns
    window_s: float
    setup_s: float
    peak_bytes: int | None  # None off the card
    facts: dict
    spans: dict
    counters: dict
    trace: trace_mod.Trace | None


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, bench_path: str | None = None,
        finder: spec.Finder | None = None, device=None,
        require_card: bool = True, out=None, err=None) -> dict:
    """Run ``workload`` once and print its result; returns the result.
    ``require_card=False`` and a ``device`` run it elsewhere (tests)."""
    out = out or sys.stdout
    err = err or sys.stderr
    finder = finder or spec.Finder()
    c = spec.load_cell(workload, bench_path, finder)
    bench, cell, config, traffic, pipe = (c.bench, c.cell, c.config,
                                          c.traffic, c.pipeline)
    if require_card:
        device_mod.require(cell["chips"])
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # ---- set-up: inputs from the seed, the program, one warm-up; the
    # peak is the program's, from its set-up on (the inputs are made on
    # the card, then handed over on the host)
    rec = Recorder(traced, sync)
    inputs = pipe.inputs(config, traffic, seed, device, seconds, finder)
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = pipe.setup(config, traffic, inputs, device, rec)
    rec.clear()
    sync()
    # the inputs (a pattern pool holds millions of objects) out of the
    # collector's reach: a full collection in the window would walk them
    gc.collect()
    gc.freeze()

    # ---- the window: steps back to back until ``seconds`` have passed
    units = []
    prof = _profile() if traced else contextlib.nullcontext()
    with prof:
        span = torch.profiler.record_function(trace_mod.WINDOW) if traced \
            else contextlib.nullcontext()
        with span:
            t0 = time.perf_counter()
            t1 = t0
            while t1 - t0 < seconds:
                unit = pipe.step(state, rec)
                unit["seconds"] = time.perf_counter() - t1
                t1 += unit["seconds"]
                units.append(unit)
    setup_s = t0 - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    tr = trace_mod.from_profiler(prof, rec.spans) if traced else None
    facts = pipe.facts(state)

    # ---- the comparison, with the program's state freed
    outputs = pipe.outputs(state)
    pipe.release(state)
    del state
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = finder.module("reference", pipe.REFERENCE)
    checks, failed = ref.check(inputs, outputs, device)
    del outputs
    correct = all(c["value"] <= c["limit"] for c in checks)

    record = RunRecord(
        workload=workload, config=config, traffic=traffic, units=units,
        window_s=t1 - t0, setup_s=setup_s, peak_bytes=peak, facts=facts,
        spans=dict(rec.spans), counters=dict(rec.counters), trace=tr)
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, workload, section):
        value = finder.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_mod.describe(cell["chips"], peak) if on_card else \
        {"platform": device.type, "kind": device.type, "count": 1,
         "memory_peak_bytes": 0}
    result = {"correct": correct,
              "attempted": sum(u["count"] for u in units),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = trace_mod.busy_s(tr)
        dev["window_s"] = (tr.window[1] - tr.window[0]) / 1e9
        result["breakdown"] = {"device_ops": trace_mod.device_ops(tr),
                               "idle_gaps": trace_mod.idle_gaps(tr)}
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    steps = sorted(u["seconds"] for u in units)
    print(f"portbench: {len(steps)} steps in {t1 - t0:.3f} s; step seconds "
          f"min {steps[0]:.4f} median {steps[len(steps) // 2]:.4f} max "
          f"{steps[-1]:.4f}: " + " ".join(f"{u['seconds']:.4f}"
                                            for u in units), file=err)
    for name, v in sorted(facts.items()):
        print(f"portbench: {name} = {v}", file=err)
    found = guard.forbidden_modules()
    if found:
        raise Refused("the run loaded forbidden modules: "
                      + ", ".join(found))
    for c in checks:
        print(f"check {c['name']}: {c['value']} (limit {c['limit']})",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result
