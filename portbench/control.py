"""The control of a cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken (each
reference module's ``control``), judged by the same comparison that
decides ``correct``.  A sound comparison reads it as not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>]

Makes each seed's inputs as a run does (``--seconds`` sizes a pattern
pool as a run's window would) and prints one JSON line a seed with the
numbers compared and their limits.  The benchmark's own runs never run
it."""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def readings(workload: str, seed: int, seconds: float, device, *,
             bench_path=None, finder=None) -> dict:
    from portbench.harness import spec

    finder = finder or spec.Finder()
    c = spec.load_cell(workload, bench_path, finder)
    pipe = c.pipeline
    ref = finder.module("reference", pipe.REFERENCE)
    t0 = time.perf_counter()
    inputs = pipe.inputs(c.config, c.traffic, seed, device, seconds, finder)
    outputs = ref.control(inputs, pipe.OUTPUTS, device)
    checks, failed = ref.check(inputs, outputs, device)
    return {"workload": workload, "seed": seed, "failed": failed,
            "correct": all(c["value"] <= c["limit"] for c in checks),
            "checks": {c["name"]: {"value": c["value"], "limit": c["limit"]}
                       for c in checks},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  torch.device("cuda", 0))), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
