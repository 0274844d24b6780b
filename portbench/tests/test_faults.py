"""A whole run on the CPU, with the chip's look skipped and the timed
path broken underneath, comes out ``correct: false``: an answer altered
where it is produced, in each output a cell compares, and, for the
pattern batches, half of a batch left unanswered."""

import time

import numpy as np
import pytest

from portbench.harness import runner


def run(tiny, workload, capsys):
    path, finder = tiny
    res = runner.run(workload, 2**31 + 99, 0.3, False,
                     t_start=time.perf_counter(), bench_path=path,
                     finder=finder, device="cpu", require_card=False)
    capsys.readouterr()
    return res


def sound(tiny, workload, capsys):
    res = run(tiny, workload, capsys)
    assert res["correct"] and res["failed"] == 0
    return res


def _swap_rows(dsa):
    dsa.sa[-1], dsa.sa[-2] = dsa.sa[-2].clone(), dsa.sa[-1].clone()


def _bump_lcp(dsa):
    dsa.lcp[-1] += 1


@pytest.mark.parametrize("workload", ["dna_index.random200",
                                      "dna_index.ecoli23"])
@pytest.mark.parametrize("fault", ["sa", "lcp", "tree"])
def test_index_fault(tiny, capsys, workload, fault):
    sound(tiny, workload, capsys)
    mod = tiny[1].module("pipelines", "sa_lcp_st")
    build, tree = mod.construct_device, mod.construct_suffix_tree_device

    def broken_build(*a, **k):
        dsa = build(*a, **k)
        {"sa": _swap_rows, "lcp": _bump_lcp}.get(fault, lambda d: 0)(dsa)
        return dsa

    def broken_tree(*a, **k):
        t = tree(*a, **k)
        if fault == "tree":
            t.nodes[t.nodes.argmax()] += 1
        return t

    mod.construct_device, mod.construct_suffix_tree_device = \
        broken_build, broken_tree
    try:
        res = run(tiny, workload, capsys)
    finally:
        mod.construct_device, mod.construct_suffix_tree_device = build, tree
    assert not res["correct"] and res["failed"] == 1


@pytest.mark.parametrize("fault", ["sa", "lcp"])
def test_host_arrays_fault(tiny, capsys, monkeypatch, fault):
    from psac_tpu_torch.models.suffix_array import DeviceSuffixArray

    sound(tiny, "dna_index.random200_host", capsys)
    materialize = DeviceSuffixArray.materialize

    def broken(self):
        out = materialize(self)
        if fault == "sa":
            out.sa[[3, 4]] = out.sa[[4, 3]]
        else:
            out.lcp[5] += 1
        return out

    monkeypatch.setattr(DeviceSuffixArray, "materialize", broken)
    res = run(tiny, "dna_index.random200_host", capsys)
    assert not res["correct"] and res["failed"] == 1


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
def test_locate_fault(tiny, capsys, monkeypatch, fault):
    from psac_tpu_torch.models.desa import DESA

    sound(tiny, "dna_desa.mkpattern20", capsys)
    locate = DESA.bulk_locate

    def broken(self, patterns):
        out = locate(self, patterns)
        if fault == "altered":
            out[7, 1] += 1
        else:
            out[len(out) // 2:] = 0
        return out

    monkeypatch.setattr(DESA, "bulk_locate", broken)
    res = run(tiny, "dna_desa.mkpattern20", capsys)
    assert not res["correct"] and res["failed"] > 0
    if fault == "half_left_out":
        assert res["failed"] >= res["attempted"] // 2
