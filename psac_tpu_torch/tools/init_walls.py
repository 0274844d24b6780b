"""Time the builds whose k-mer init runs on K9 and K10
(``csrc/kmer_init.cu``) in two trees of the repository, in turns, on one
NVIDIA GPU.

For each tree (``--trees A B``: repository roots, e.g. this checkout and
an earlier commit unpacked under a git-ignored directory) a child process
run from that root builds the kernels and times, by the host clock around
calls that end in ``torch.cuda.synchronize()``, after one warm-up run,
``--reps`` runs each of: ``construct_device`` of SA+LCP of
``rand_dna(2^log2n, seed=42)`` and of ``rep_dna(2^rep_log2n)`` (the text
encoded once), ``build_gsa_device`` of the random string set
(``rand_dna(2^gsa_log2n, seed=43)`` cut into 4 KiB strings, upload
included), and SA+LCP of the first text on a mesh of 4 shards on
``cuda:0``.  The trees run in the order A, B, B, A.  It prints one line per
child, the card's name and power limit, and one JSON line with every
time.

Run from the repository root:
    python3 -m psac_tpu_torch.tools.init_walls --trees . scratch/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# run by each child from its tree's root: only entry points that every
# tree of the port has
CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from psac_tpu_torch.models import gsa as gsa_mod
from psac_tpu_torch.models import suffix_array as sa_mod
from psac_tpu_torch.ops import cuda_lib
from psac_tpu_torch.ops.alphabet import rand_dna, rep_dna
from psac_tpu_torch.parallel.mesh import make_mesh

log2n, rep_log2n, gsa_log2n, reps = map(int, sys.argv[1:5])
dev = torch.device("cuda", 0)
cuda_lib.build()
cuda_lib.lib()


def timed(fn):
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out[1:]


res = {}
for label, text in ((f"sa_2^{log2n}_rand_dna", rand_dna(1 << log2n, seed=42)),
                    (f"sa_2^{rep_log2n}_rep_dna", rep_dna(1 << rep_log2n))):
    xs, alpha, n, N = sa_mod.encode_and_shard(text, dev)
    res[label] = timed(lambda: sa_mod.construct_device(xs, alpha, n, N))
    del xs
whole = rand_dna(1 << gsa_log2n, seed=43)
strings = [whole[i:i + 4096] for i in range(0, len(whole), 4096)]
res[f"gsa_2^{gsa_log2n}_4KiB_strings"] = timed(
    lambda: gsa_mod.build_gsa_device(strings, dev))
mesh = make_mesh(4, ["cuda:0"] * 4)
text = rand_dna(1 << log2n, seed=42)
xs, alpha, n, N = sa_mod.encode_and_shard(text, mesh=mesh)
res[f"mesh4_sa_2^{log2n}_rand_dna"] = timed(
    lambda: sa_mod.construct_device(xs, alpha, n, N, mesh=mesh))
mesh.close()
print(json.dumps(res), flush=True)
os._exit(0)  # the mesh's worker threads need no orderly teardown
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True,
                    metavar=("A", "B"), help="two repository roots")
    ap.add_argument("--log2n", type=int, default=26)
    ap.add_argument("--rep-log2n", type=int, default=24)
    ap.add_argument("--gsa-log2n", type=int, default=26)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("init_walls: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    a, b = (os.path.abspath(t) for t in args.trees)
    turns = []
    for tree in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.log2n),
             str(args.rep_log2n), str(args.gsa_log2n), str(args.reps)],
            cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"init_walls: the child in {tree} failed "
                               f"({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append(dict(tree=tree, times_s=res))
        print(f"[init-walls] {tree}: " + ", ".join(
            f"{k} " + " / ".join(f"{t:.4f}" for t in v)
            for k, v in res.items()) + " s", flush=True)
    print(card)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
