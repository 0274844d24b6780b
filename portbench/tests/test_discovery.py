"""Every piece of a cell is found by its name, so a new configuration,
traffic mix, pipeline or metric is new files and new entries alone."""

import json
import os
import time

from portbench.harness import runner, spec

from conftest import CELLS, REPO


def test_every_name_in_the_benchmark_resolves():
    bench = spec.load_benchmark()
    f = spec.Finder()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert spec.config(bench, c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        t = f.data("traffic", w["traffic"])
        pipe = f.module("pipelines", t["pipeline"])
        f.module("reference", pipe.REFERENCE)
        for key in ("text", "patterns"):
            if key in t:
                f.module("gen", t[key]["gen"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(f.module("metrics", m["name"]).read)


def test_metrics_of_a_cell():
    bench = spec.load_benchmark()
    e2e = {m["name"] for m in spec.metrics_for(
        bench, "dna_desa.mkpattern20", "end_to_end")}
    assert e2e == {"locate_pps", "locate_p95_ms", "peak_bytes_per_char",
                   "setup_s"}
    layer = {m["name"] for m in spec.metrics_for(
        bench, "dna_index.random200_host", "per_layer")}
    assert "materialize_ms" in layer and "st_ms" not in layer
    for w in CELLS:
        names = {m["name"] for m in spec.metrics_for(bench, w, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_for(bench, w, "per_layer")


def test_a_cell_and_a_metric_added_as_files_alone(tmp_path, capsys):
    """A throwaway configuration, traffic mix and per-layer metric in a
    temporary directory: the harness runs the new cell with no edit to a
    file that is there."""
    bench = spec.load_benchmark()
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = {"name": "tiny_bytes", "sa_config": {"kmer_words": 3},
           "reduced": [], "assumed": []}
    (tmp_path / "configs" / "tiny_bytes.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "letters.json").write_text(json.dumps(
        {"pipeline": "sa_lcp_host",
         "text": {"gen": "text", "n": 3000, "alphabet": "abcdefgh"}}))
    (tmp_path / "metrics" / "builds_done.py").write_text(
        "def read(run):\n    return float(len(run.units))\n")
    bench["configs"].append({"name": "tiny_bytes", "source": "a test",
                             "file": "configs/tiny_bytes.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_bytes.letters",
                               "config": "tiny_bytes", "traffic": "letters",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "builds_done", "unit": "builds",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "build_mbps",
                               "workloads": ["tiny_bytes.letters"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "build_mbps":
            m["workloads"].append("tiny_bytes.letters")
    for c in bench["configs"][:-1]:
        c["file"] = os.path.join(REPO, c["file"])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    finder = spec.Finder([str(tmp_path), spec.PORTBENCH])
    kw = dict(t_start=time.perf_counter(), bench_path=str(path),
              finder=finder, device="cpu", require_card=False)
    res = runner.run("tiny_bytes.letters", 11, 0.2, False, **kw)
    assert res["correct"] and set(res["metrics"]) == {"build_mbps",
                                                       "setup_s"}
    res = runner.run("tiny_bytes.letters", 11, 0.2, True, **kw)
    assert res["correct"]
    assert res["metrics"]["builds_done"]["value"] == res["attempted"]
    capsys.readouterr()
