"""The result line's keys, the numbers compared as the last lines of
standard error, and the refusals: no card, a forbidden module."""

import io
import json
import os
import subprocess
import sys
import time
import types

import pytest

from portbench.harness import runner

from conftest import CELLS, REPO


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_last_line(tiny, workload, traced):
    path, finder = tiny
    out, err = io.StringIO(), io.StringIO()
    runner.run(workload, 2**31 + 1, 0.2, traced,
               t_start=time.perf_counter(), bench_path=path, finder=finder,
               device="cpu", require_card=False, out=out, err=err)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if traced else ["checks"]
    assert list(res) == keys
    assert res["correct"] is True and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if traced:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in res["metrics"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    lines = err.getvalue().strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(lines, res["checks"].items()):
        assert line == f"check {name}: {c['value']} (limit {c['limit']})"


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot show")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "portbench", "run.py"),
         "--workload", "dna_index.random200", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_forbidden_module_no_result(tiny, monkeypatch):
    path, finder = tiny
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out = io.StringIO()
    with pytest.raises(runner.Refused, match="jax"):
        runner.run("dna_index.random200_host", 1, 0.1, False,
                   t_start=time.perf_counter(), bench_path=path,
                   finder=finder, device="cpu", require_card=False, out=out,
                   err=io.StringIO())
    assert out.getvalue() == ""
