"""Run one cell of the benchmark of psac_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic by the names BENCHMARK.json
gives, makes the inputs from the seed, warms up, measures for ``--seconds``
seconds, compares what the window produced with the plain reference, and
prints the result as the last line of standard output.  Without the CUDA
cards the cell asks for it fails (exit 2) and prints no result; it never
falls back to the CPU.  Exit 3: a forbidden module (JAX or the JAX
package) was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compiler cache of the run at a fixed path inside the checkout
_CACHE = os.path.join(REPO, ".portbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import device, runner

    try:
        runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    except device.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except runner.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
