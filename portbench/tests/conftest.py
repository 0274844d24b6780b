"""Shared fixtures of the benchmark's CPU tests: the repository root on
``sys.path``, and a copy of BENCHMARK.json whose cells run tiny texts
(traffic files of their own in a temporary directory, found before the
benchmark's own), so a whole run goes through on the CPU in a second."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.harness import spec  # noqa: E402

CELLS = ["dna_index.random200", "dna_desa.mkpattern20", "dna_index.ecoli23",
         "dna_index.random200_host"]


def tiny_traffic(traffic: dict) -> dict:
    """The mix at a size the CPU holds: the text's shape kept (alphabet,
    copies, substitutions), its n cut, batches of 64 patterns."""
    t = json.loads(json.dumps(traffic))
    copies = t["text"].get("copies", 1)
    t["text"]["n"] = copies * (4000 // copies)
    if "patterns" in t:
        t["patterns"]["batch"] = 64
    return t


@pytest.fixture
def tiny(tmp_path):
    """(bench_path, finder) of the benchmark's cells on tiny texts."""
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        c["file"] = os.path.join(REPO, c["file"])
    (tmp_path / "traffic").mkdir()
    finder = spec.Finder([str(tmp_path), spec.PORTBENCH])
    for w in bench["workloads"]:
        t = tiny_traffic(finder.data("traffic", w["traffic"]))
        w["traffic"] = "tiny_" + w["traffic"]
        (tmp_path / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(t))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path), finder
