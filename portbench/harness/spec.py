"""Finding a cell's pieces by name.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix.  The traffic file names its generators and its pipeline; the
pipeline names its reference; every metric is a reader named as the
metric.  Each is looked up as ``<root>/<kind>/<name>.<ext>`` in the
finder's roots, in order, so a new cell, mix, pipeline, reference or metric
is a new file and a new entry, never an edit."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

#: the kinds of file the harness finds by name, and their extension
KINDS = {"traffic": ".json", "gen": ".py", "pipelines": ".py",
         "reference": ".py", "metrics": ".py"}

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PORTBENCH)


class Finder:
    """Looks a name up under each root in turn (the benchmark's own
    directory last, so a test's temporary root can add to it)."""

    def __init__(self, roots=(PORTBENCH,)):
        self.roots = list(roots)
        self._modules = {}

    def path(self, kind: str, name: str) -> str:
        for root in self.roots:
            p = os.path.join(root, kind, name + KINDS[kind])
            if os.path.isfile(p):
                return p
        raise FileNotFoundError(f"no {kind} named {name!r} under "
                                f"{self.roots}")

    def data(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name)) as f:
            return json.load(f)

    def module(self, kind: str, name: str):
        """The module of ``<kind>/<name>.py``, loaded once from its file
        (names may hold dots, as ``device_idle_pct.build`` does)."""
        p = self.path(kind, name)
        if p not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name.replace('.', '_')}", p)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            self._modules[p] = mod
        return self._modules[p]


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def repo_of(bench_path: str | None) -> str:
    """The directory that ``BENCHMARK.json``'s paths are relative to."""
    return os.path.dirname(os.path.abspath(bench_path)) if bench_path \
        else REPO


def config(bench: dict, name: str, repo: str = REPO) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(repo, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """A workload's pieces, each found by its name."""

    bench: dict
    cell: dict
    config: dict
    traffic: dict
    pipeline: object


def load_cell(workload: str, bench_path: str | None, finder: Finder) -> Cell:
    bench = load_benchmark(bench_path)
    c = cell(bench, workload)
    traffic = finder.data("traffic", c["traffic"])
    return Cell(bench=bench, cell=c,
                config=config(bench, c["config"], repo=repo_of(bench_path)),
                traffic=traffic,
                pipeline=finder.module("pipelines", traffic["pipeline"]))


def metrics_for(bench: dict, workload: str, section: str) -> list[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``workload`` reports: those that list it under ``workloads``, and those
    without the key (an end-to-end metric: every cell; a per-layer one:
    every cell that reports the end-to-end metric it ``moves``)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
