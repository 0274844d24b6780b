"""Where a build's device time goes, by the program's own spans
(``utils/timers.py``), on one NVIDIA GPU.

``split``: after one warm-up, one build of an ACGT text made from
``--seed`` (``--copies`` copies of one base with point substitutions at
``--sub-rate`` of the positions, as the benchmark's repetitive texts) from
host bytes to SA+LCP and the suffix tree (``--host``: to host int64 arrays
instead) runs under ``torch.profiler``.  It prints the spans' host and
device ms by name, and each kernel's device time split by the innermost
``psac.`` span open where the host launched it (the kernel's linked CPU
event, placed in the spans of its thread), with the checks that no device
event and no user annotation carries a ``psac.`` name.

``cost``: ``--turns`` rounds of the same build with the tracer off, its
spans on (the build inside an open span, as under the profiler, with no
``PSAC_TIMER`` lines) and ``PSAC_TIMER=1`` (the lines captured), each
timed by the host clock around work that ends in
``torch.cuda.synchronize()``, in turns off, spans, timer, timer, spans,
off; then as many rounds of a TLDT DESA's ``bulk_locate`` of 65,536
length-20 substrings.

Each mode prints the card's name and power limit and, last, one JSON line
(also written to ``--out``).  Run from the repository root:
    python3 -m psac_tpu_torch.tools.span_report split --n 209715200
    python3 -m psac_tpu_torch.tools.span_report cost --turns 3
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from psac_tpu_torch.models.desa import build_desa
from psac_tpu_torch.models.suffix_array import (construct_device,
                                                encode_and_shard)
from psac_tpu_torch.models.suffix_tree import construct_suffix_tree_device
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.utils import timers


def make_text(args) -> bytes:
    """``--copies`` copies of one random ACGT base with ``--sub-rate``
    point substitutions (``ops.alphabet.rep_dna``), or one random text."""
    if args.copies == 1:
        return rand_dna(args.n, seed=args.seed)
    return rep_dna(args.n, unit_len=args.n // args.copies, seed=args.seed,
                   mutations=round(args.sub_rate * args.n))


def build(text: bytes, dev, host: bool):
    xs, alpha, n, N = encode_and_shard(text, dev)
    dsa = construct_device(xs, alpha, n, N)
    out = dsa.materialize() if host else \
        (dsa, construct_suffix_tree_device(dsa, xs))
    torch.cuda.synchronize()
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = name[5:] if name.startswith("void ") else name
    while True:
        cut = re.sub(r"<[^<>]*>", "", name)
        if cut == name:
            break
        name = cut
    return name.split("(")[0] if "::" in name else name


def split_by_span(prof) -> tuple[dict, dict]:
    """({kernel: {innermost span: device s}}, checks) of a profile: each
    device event's linked CPU event (the op, or the span, that launched
    it) placed in the ``psac.`` spans of its thread."""
    events = prof.profiler.kineto_results.events()
    spans = defaultdict(list)    # thread -> [(start, end, name)]
    cpu = {}                     # correlation id -> (start, thread)
    device = []
    checks = {"device_events_named_psac": 0, "psac_user_annotations": 0}
    for ev in events:
        name = ev.name()
        if "CUDA" in str(ev.device_type()):
            if name.startswith("psac."):
                checks["device_events_named_psac"] += 1
            device.append(ev)
            continue
        if name.startswith("psac."):
            if ev.is_user_annotation():
                checks["psac_user_annotations"] += 1
            spans[ev.start_thread_id()].append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns(), name))
        if ev.correlation_id():
            cpu[ev.correlation_id()] = (ev.start_ns(), ev.start_thread_id())
    out = defaultdict(lambda: defaultdict(float))
    for ev in device:
        at = cpu.get(ev.linked_correlation_id())
        where = "(not linked)"
        if at is not None:
            t, tid = at
            inside = [s for s in spans.get(tid, ()) if s[0] <= t < s[1]]
            where = max(inside)[2] if inside else "(outside the spans)"
        out[short_name(ev.name())][where] += ev.duration_ns() / 1e9
    return out, checks


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def split(args, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    text = make_text(args)
    build(text, dev, args.host)
    timers.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        build(text, dev, args.host)
    recs = timers.records()
    by_name = defaultdict(lambda: [0, 0.0, 0.0])
    for r in recs:
        got = by_name[r.name]
        got[0] += 1
        got[1] += r.host_ms
        got[2] += r.device_ms or 0.0
    kernels, checks = split_by_span(prof)
    for name, (k, h, d) in sorted(by_name.items()):
        print(f"[span] {name}: x{k} host {h:.3f} ms device {d:.3f} ms")
    tot = {k: sum(v.values()) for k, v in kernels.items()}
    for name in sorted(tot, key=lambda k: -tot[k])[:args.top]:
        where = sorted(kernels[name].items(), key=lambda kv: -kv[1])
        print(f"[kernel] {name[:80]}: {tot[name] * 1e3:.3f} ms: "
              + ", ".join(f"{s} {v * 1e3:.3f}" for s, v in where))
    print("[checks] " + json.dumps(checks))
    return {"spans": {k: {"count": v[0], "host_ms": v[1], "device_ms": v[2]}
                      for k, v in by_name.items()},
            "kernels_s": {k: dict(v) for k, v in kernels.items()},
            "checks": checks}


def cost(args, dev) -> dict:
    text = make_text(args)
    order = ["off", "spans", "timer", "timer", "spans", "off"]

    def timed(mode, fn):
        env = os.environ.pop("PSAC_TIMER", None)
        if mode == "timer":
            os.environ["PSAC_TIMER"] = "1"
        try:
            with contextlib.redirect_stderr(io.StringIO()), \
                    (timers.Span("psac.cost", dev) if mode == "spans"
                     else contextlib.nullcontext()):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                return time.perf_counter() - t0
        finally:
            os.environ.pop("PSAC_TIMER", None)
            if env is not None:
                os.environ["PSAC_TIMER"] = env
            timers.clear()

    res = {"build_s": defaultdict(list), "locate_s": defaultdict(list)}
    build(text, dev, args.host)
    for _ in range(args.turns):
        for mode in order:
            res["build_s"][mode].append(
                timed(mode, lambda: build(text, dev, args.host)))
    desa = build_desa(text, dev, tli="tldt", tli_bits=24)
    rng = np.random.default_rng(args.seed)
    starts = rng.integers(0, len(text) - 20, 65536)
    batch = [text[s:s + 20] for s in starts]
    desa.bulk_locate(batch)
    for _ in range(args.turns):
        for mode in order:
            res["locate_s"][mode].append(
                timed(mode, lambda: desa.bulk_locate(batch)))
    for what, got in res.items():
        med = {m: statistics.median(v) for m, v in got.items()}
        print(f"[cost] {what}: " + ", ".join(
            f"{m} median {med[m] * 1e3:.3f} ms ({len(got[m])} runs: "
            + " ".join(f"{x * 1e3:.2f}" for x in got[m]) + ")"
            for m in ("off", "spans", "timer")))
    return {k: dict(v) for k, v in res.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("split", "cost"))
    ap.add_argument("--n", type=int, default=209_715_200)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--copies", type=int, default=1)
    ap.add_argument("--sub-rate", type=float, default=0.0)
    ap.add_argument("--host", action="store_true",
                    help="build to host arrays instead of the tree")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    res = (split if args.mode == "split" else cost)(args, dev)
    res.update(card=card(), args=vars(args))
    print(res["card"])
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
