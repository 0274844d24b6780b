"""Count the instructions K5 (``csrc/bansv.cu``) issues per element when no
element of a tile leaves its window.

Reads the SASS listing of the kernel library (``cuobjdump -sass`` of
``psac_tpu_torch/_build/libpsac_kernels.so``, run here unless a saved
listing is given), takes the int32 strict ``psv_kernel``, and walks one
iteration of its tile loop (the backward branch with the longest span) in
program order, taking every forward branch that follows the loop's first
warp vote and skips more than 50 instructions: those jump over the warp
climbs, which no lane needs.  The ring update of a tile after the first is
on this path.  Prints the path's length, its length per element (the
kernel's elements per thread, ``--elems``) and its opcode counts as one
JSON line.

Run from the repository root after the kernels were built (any GPU run):
    python3 -m psac_tpu_torch.tools.k5_sass [--listing FILE] [--elems 4]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

KERNEL = "psv_kernelIiLb1E"  # psv_kernel<int32_t, true>
_INS = re.compile(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);")
_BRA = re.compile(r"BRA (0x[0-9a-f]+)")


def kernel_listing(text: str) -> list[tuple[int, str]]:
    """(address, instruction) of the kernel named by ``KERNEL``."""
    out, inside = [], False
    for line in text.splitlines():
        if "Function : " in line:
            inside = KERNEL in line
        elif inside:
            m = _INS.match(line)
            if m:
                out.append((int(m.group(1), 16), m.group(2).strip()))
    if not out:
        raise ValueError(f"{KERNEL} not found in the listing")
    return out


def no_climb_path(ins: list[tuple[int, str]]) -> list[str]:
    """One tile-loop iteration in which no warp climbs."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    back = [(i, at[int(m.group(1), 16)]) for i, (a, t) in enumerate(ins)
            if (m := _BRA.search(t)) and int(m.group(1), 16) < a]
    tail, head = max(back, key=lambda b: b[0] - b[1])
    first_vote = next(i for i in range(head, tail) if "VOTE" in ins[i][1])
    path, i = [], head
    while True:
        path.append(ins[i][1])
        m = _BRA.search(ins[i][1])
        if m and i > first_vote:
            to = at[int(m.group(1), 16)]
            if i + 50 < to <= tail:
                i = to
                continue
        if i == tail:
            return path
        i += 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--listing", help="a saved cuobjdump -sass listing")
    ap.add_argument("--elems", type=int, default=4,
                    help="elements per thread (TILE / THREADS)")
    args = ap.parse_args()
    if args.listing:
        with open(args.listing) as f:
            text = f.read()
    else:
        from psac_tpu_torch.ops import cuda_lib

        text = subprocess.run(
            [os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump"),
             "-sass", cuda_lib._SO], capture_output=True, text=True,
            check=True).stdout
    path = no_climb_path(kernel_listing(text))
    ops = collections.Counter(
        re.sub(r"^@!?U?P[T0-9]+\s+", "", t).split()[0].split(".")[0]
        for t in path)
    print(json.dumps({"kernel": KERNEL, "per_tile_iteration": len(path),
                      "per_element": len(path) / args.elems,
                      "ops": dict(ops.most_common())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
