"""The benchmark's cell across processes (``dna_index_p4.random491``,
``portbench/pipelines/sa_lcp_st_nccl.py``) on the CPU: its traffic cut to
2^15 characters and gloo in place of NCCL, 4 processes (rank 0 the
runner's, ranks 1-3 its workers), one shard each.

A run goes through set-up, the window and the gathered outputs, which
the cell's reference (``index_outputs_lean``) and ``index_outputs`` read
as 0 wrong, and which read not correct with two SA rows of rank 2's
block swapped; a rank killed mid-build ends the run and every worker
within the group's timeout; the lean reference equals ``index_outputs``;
the cell's readers of the ``psac.comm`` spans give numbers on records
with such spans and None without them.  Every wait on a process is
bounded."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import spec  # noqa: E402
from portbench.reference import index_outputs, index_outputs_lean  # noqa

CELL = "dna_index_p4.random491"
N_TINY = 1 << 15
#: the group's timeout of the tiny cell
TIMEOUT_S = 30
#: seconds rank 0's process may take, its workers' start included
WAIT_S = 150

#: runs the tiny cell once as ``portbench/run.py`` would, on the CPU;
#: ``swap`` also checks the outputs with two SA rows of rank 2's block
#: swapped, ``kill`` kills rank 2 in the middle of the window's first
#: build
RANK0 = r"""
import json, os, sys, threading, time
T0 = time.perf_counter()
root, mode = sys.argv[1], sys.argv[2]
sys.path.insert(0, sys.argv[3])
import torch
torch.set_num_threads(1)
from portbench.harness import runner, spec

finder = spec.Finder([root, spec.PORTBENCH])
pipe = finder.module("pipelines", "sa_lcp_st_nccl")
kept = {}
setup, outputs, build = pipe.setup, pipe.outputs, pipe._build


def setup_(*a):
    st = setup(*a)
    print("WORKERS " + json.dumps([p.pid for p in st.procs]),
          file=sys.stderr, flush=True)
    return st


def outputs_(st):
    kept["outputs"] = out = outputs(st)
    kept["N"] = st.N
    return out


def build_(st):
    kept["builds"] = kept.get("builds", 0) + 1
    if mode == "kill" and kept["builds"] == 2:
        threading.Timer(0.3, st.procs[1].kill).start()
        print(f"KILLED {time.time() + 0.3}", file=sys.stderr, flush=True)
    return build(st)


pipe.setup, pipe.outputs, pipe._build = setup_, outputs_, build_
result = runner.run("dna_index_p4.random491", 2**33 + 7, 1.0, True,
                    t_start=T0, bench_path=os.path.join(root,
                                                        "BENCHMARK.json"),
                    finder=finder, device="cpu", require_card=False)
if mode == "swap":
    from portbench.reference import index_outputs, index_outputs_lean
    out = kept["outputs"]
    sa = out["sa"].clone()
    s = kept["N"] // 4
    lo = 2 * s - (kept["N"] - sa.shape[0])  # rank 2's first real row
    sa[[lo + 5, lo + 9]] = sa[[lo + 9, lo + 5]]
    inputs = pipe.inputs(None, json.load(open(os.path.join(
        root, "traffic", "tiny491.json"))), 2**33 + 7, "cpu", 1.0, finder)
    for ref in (index_outputs, index_outputs_lean):
        checks, failed = ref.check(inputs, dict(out, sa=sa), "cpu")
        print("SWAPPED " + json.dumps({c["name"]: c["value"]
                                       for c in checks}), flush=True)
"""


@pytest.fixture
def tiny(tmp_path):
    """A copy of BENCHMARK.json whose cell across processes builds a
    2^15-character text over gloo on the CPU."""
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    t = spec.Finder().data("traffic", "random491")
    assert (t["processes"], t["backend"]) == (4, "nccl")
    t["text"]["n"] = N_TINY
    t.update(backend="gloo", timeout_s=TIMEOUT_S)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny491.json").write_text(json.dumps(t))
    for w in bench["workloads"]:
        if w["name"] == CELL:
            w["traffic"] = "tiny491"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "rank0.py").write_text(RANK0)
    return tmp_path


def run_rank0(root, mode: str):
    """(return code, standard output, standard error, seconds, the clock
    at its end) of rank 0's process; it and its workers are killed once
    ``WAIT_S`` has passed."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, str(root / "rank0.py"), str(root),
                          mode, ROOT], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = p.communicate(timeout=WAIT_S)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()
    return (p.returncode, out.decode(), err.decode(),
            time.perf_counter() - t0, time.time())


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _workers(err: str) -> list:
    line = next(x for x in err.splitlines() if x.startswith("WORKERS "))
    return json.loads(line.split(" ", 1)[1])


def test_four_processes_build_the_text_exactly(tiny):
    """Set-up, the window and the outputs on 4 processes: the reference
    reads 0 wrong rows and slots, ``correct`` is true, the facts hold
    every rank's peak, the traced line has the collectives a build; the
    same outputs with two SA rows of rank 2's block swapped read 2 wrong
    rows (not correct) by both references; the workers are gone."""
    rc, out, err, _, _ = run_rank0(tiny, "swap")
    assert rc == 0, err[-4000:]
    result = json.loads([x for x in out.splitlines()
                         if x.startswith("{")][-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {name: {"value": 0, "limit": 0} for name in
                                ("sa_rows_wrong", "lcp_rows_wrong",
                                 "st_slots_wrong")}
    assert result["attempted"] >= 1
    calls = result["metrics"]["comm_calls_per_build"]["value"]
    assert calls > 10  # the sample sort, the routing, the tree's ANSV
    for r in range(4):
        assert f"portbench: peak_bytes_rank{r} = 0" in err
    assert "portbench: p = 4" in err and f"portbench: n = {N_TINY}" in err
    swapped = [json.loads(x.split(" ", 1)[1]) for x in out.splitlines()
               if x.startswith("SWAPPED ")]
    assert swapped == [{"sa_rows_wrong": 2, "lcp_rows_wrong": 0,
                        "st_slots_wrong": 0}] * 2
    assert not any(_alive(pid) for pid in _workers(err))


def test_a_rank_killed_mid_build_ends_the_run(tiny):
    """Rank 2 killed in the middle of a build: rank 0 fails (exit code not
    0, no result line) within the group's timeout, and no worker is left
    running."""
    rc, out, err, secs, ended = run_rank0(tiny, "kill")
    assert "KILLED" in err, err[-4000:]
    assert rc != 0
    assert not any(x.startswith("{") for x in out.splitlines())
    assert secs < WAIT_S
    killed_at = err.index("KILLED")
    killed = float(err[killed_at:].split()[1])
    assert ended - killed < TIMEOUT_S, err[-3000:]
    assert "rank 2 exited" in err[killed_at:] or "Error" in err[killed_at:]
    deadline = time.perf_counter() + 10
    pids = _workers(err)
    while any(_alive(pid) for pid in pids) and time.perf_counter() < deadline:
        time.sleep(0.2)
    assert not any(_alive(pid) for pid in pids)


# ---------------------------------------------------------------- reference

def _texts():
    rng = np.random.RandomState(3)
    dna = rng.choice(np.frombuffer(b"ACGT", np.uint8), 3000).tobytes()
    long_run = b"A" * 700 + dna[:500]  # LCPs past 255: the int16 table
    return [dna, long_run, (dna[:400] * 3)[:1100], b"mississippi"]


@pytest.mark.parametrize("block", [1 << 25, 7])
@pytest.mark.parametrize("which", range(4))
def test_lean_reference_equals_index_outputs(monkeypatch, which, block):
    """The lean node table equals ``suffix_tree.node_table``, and its
    checks give ``index_outputs``'s counts on right and wrong outputs, at
    one block and at blocks of 7 rows."""
    from portbench.reference import suffix_tree

    monkeypatch.setattr(index_outputs_lean, "BLOCK", block)
    text = _texts()[which]
    codes, sigma, sa, lcp = index_outputs._reference(text, "cpu")
    table = suffix_tree.node_table(codes, sa, lcp, sigma)
    assert torch.equal(index_outputs_lean.node_table(codes, sa, lcp, sigma),
                       table)
    right = {"sa": sa.to(torch.int32), "lcp": lcp.clone(), "nodes": table}
    wrong = {k: v.clone() for k, v in right.items()}
    wrong["sa"][[1, 2]] = wrong["sa"][[2, 1]]
    wrong["lcp"][3] += 1
    wrong["lcp"][0] = 99  # row 0's LCP is read as 0
    wrong["nodes"][4, 1] += 1
    for outs, failed in ((right, 0), (wrong, 1)):
        want = index_outputs.check({"text": text}, outs, "cpu")
        got = index_outputs_lean.check({"text": text}, outs, "cpu")
        assert got == want and got[1] == failed
    ctl = index_outputs_lean.control({"text": text}, {"sa", "lcp", "nodes"},
                                     "cpu")
    ref = index_outputs.control({"text": text}, {"sa", "lcp", "nodes"},
                                "cpu")
    for k in ref:
        assert torch.equal(ctl[k], ref[k])


# ------------------------------------------------------------------ readers

READERS = ["mesh_sa_lcp_ms", "mesh_st_ms", "comm_ms",
           "comm_calls_per_build", "comm_link_pct"]


def _records(builds: int, comm: bool = True, on_card: bool = True):
    """Per build a ``psac.stage``, ``psac.construct`` and ``psac.st`` call,
    each with two ``psac.comm`` spans of 2 device ms and 10^9 bytes sent
    (a build: 6 calls, 12 ms, 6e9 bytes) and the calls 100 device ms each;
    the first build made before the window."""
    recs, ids = [], iter(range(1, 10 ** 6))
    for _ in range(builds):
        for root in ("psac.stage", "psac.construct", "psac.st"):
            r = SimpleNamespace(id=next(ids), name=root, t0=0, t1=10 ** 8,
                                counts={}, attrs={},
                                device_ms=100.0 if on_card else None)
            r.root = r.id
            recs.append(r)
            for _ in range(2 if comm else 0):
                recs.append(SimpleNamespace(
                    id=next(ids), root=r.id, name="psac.comm", t0=0,
                    t1=3 * 10 ** 6, attrs={"op": "all_to_all"},
                    counts={"comm_bytes": 10 ** 9, "readbacks": 1},
                    device_ms=2.0 if on_card else None))
    return recs


def _run(units: int, traced: bool = True):
    return SimpleNamespace(units=[{"count": 1, "bytes": 1}] * units,
                           trace=object() if traced else None)


def test_readers_of_the_comm_spans(monkeypatch):
    """On records with ``psac.comm`` spans each reader gives the window's
    per-build number; without them, off the card, untraced, or without
    the tracer, None."""
    from psac_tpu_torch.utils import timers

    mod = {name: spec.Finder().module("metrics", name) for name in READERS}
    peak = mod["comm_link_pct"].LINK_PEAK_BYTES_S
    monkeypatch.setattr(timers, "records", lambda: _records(4))
    got = {name: m.read(_run(3)) for name, m in mod.items()}
    assert got == pytest.approx({
        "mesh_sa_lcp_ms": 100.0, "mesh_st_ms": 100.0, "comm_ms": 12.0,
        "comm_calls_per_build": 6.0,
        "comm_link_pct": 100.0 * 6e9 / 12e-3 / peak})
    monkeypatch.setattr(timers, "records",
                        lambda: _records(4, comm=False))
    for name in ("comm_ms", "comm_calls_per_build", "comm_link_pct"):
        assert mod[name].read(_run(3)) is None
    monkeypatch.setattr(timers, "records",
                        lambda: _records(4, on_card=False))
    for name in ("mesh_sa_lcp_ms", "mesh_st_ms", "comm_ms", "comm_link_pct"):
        assert mod[name].read(_run(3)) is None
    assert mod["comm_calls_per_build"].read(_run(3)) == 6.0
    for name in READERS:
        assert mod[name].read(_run(3, traced=False)) is None
    monkeypatch.setitem(sys.modules, "psac_tpu_torch.utils.timers", None)
    for name in READERS:
        assert mod[name].read(_run(3)) is None


def test_the_cell_in_the_benchmark():
    """The configuration, the cell on 4 chips, its traffic and its
    readers, each found by name; ``build_mbps`` lists the cell."""
    bench = spec.load_benchmark()
    cell = spec.cell(bench, CELL)
    assert cell["chips"] == 4 and cell["config"] == "dna_index_p4"
    t = spec.Finder().data("traffic", cell["traffic"])
    assert t["text"] == {"gen": "text", "n": 491149951, "alphabet": "ACGT",
                         "copies": 1, "sub_rate": 0}
    assert t["pipeline"] == "sa_lcp_st_nccl" and t["timeout_s"] <= 120
    e2e = {m["name"] for m in spec.metrics_for(bench, CELL, "end_to_end")}
    assert e2e == {"build_mbps", "peak_bytes_per_char", "setup_s"}
    layer = {m["name"] for m in spec.metrics_for(bench, CELL, "per_layer")}
    assert layer == set(READERS)
