"""The control comes out not correct: the reference put in the program's
place with one guarantee broken (suffixes sorted by a bounded prefix; a
pattern answered by a prefix) fails the comparison that decides
``correct``.  At the cells' own sizes it runs on the card
(``portbench/control.py``); here at a size the CPU holds, on the cells'
pipelines with a repetitive text, where LCPs run past the control's
depth as they do at full size."""

import json

import pytest

from portbench import control

from conftest import CELLS


@pytest.fixture
def repetitive(tiny):
    """The tiny cells, each text 8 copies of a base with 1%
    substitutions."""
    path, finder = tiny
    root = finder.roots[0]
    bench = json.load(open(path))
    for w in bench["workloads"]:
        p = f"{root}/traffic/{w['traffic']}.json"
        t = json.load(open(p))
        t["text"].update(n=4000, copies=8, sub_rate=0.01)
        json.dump(t, open(p, "w"))
    return path, finder


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2**31 + 5, 2**33 + 7])
def test_control_is_not_correct(repetitive, workload, seed):
    path, finder = repetitive
    got = control.readings(workload, seed, 1.0, "cpu", bench_path=path,
                           finder=finder)
    assert not got["correct"] and got["failed"] > 0
    assert any(c["value"] > c["limit"] for c in got["checks"].values())
