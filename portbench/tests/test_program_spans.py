"""The readers of the program's own spans and counters
(``psac_tpu_torch.utils.timers``) on a synthetic record store: each
returns the traced window's total over its units, from the last calls
only; None on an untraced run, on a program without the tracer, and for
the device clock of records that carry no device time."""

import sys
from types import SimpleNamespace

import pytest

from portbench.harness import spec
from portbench.harness.trace import Trace
from psac_tpu_torch.utils import timers

from test_stats import record

F = spec.Finder()
MS = 1_000_000  # ns

#: metric -> (root, span, clock)
SPANS = {
    "stage_copy_ms": ("psac.stage", "psac.stage.copy", "host"),
    "stage_upload_ms": ("psac.stage", "psac.stage.upload", "host"),
    "init_ms": ("psac.construct", "psac.construct.init", "device"),
    "dense_ms": ("psac.construct", "psac.construct.dense", "device"),
    "resolve_ms": ("psac.construct", "psac.construct.resolve", "device"),
    "tail_ms": ("psac.construct", "psac.construct.tail", "device"),
    "st_ansv_ms": ("psac.st", "psac.st.ansv", "device"),
    "st_nodes_ms": ("psac.st", "psac.st.nodes", "device"),
    "materialize_copy_ms": ("psac.materialize", "psac.materialize.copy",
                            "host"),
    "materialize_widen_ms": ("psac.materialize", "psac.materialize.widen",
                             "host"),
    "encode_join_ms": ("psac.locate", "psac.locate.encode.join", "host"),
    "search_ms": ("psac.locate", "psac.locate.search", "device"),
}
ROOTS = sorted({r for r, _, _ in SPANS.values()})
TRACED = Trace(device=[], host=[], window=(0, 1))


class Store:
    """Records as the tracer keeps them: per call a root and two spans
    of each phase, the k-th call's phase spans 1 + k host ms and 10 + k
    device ms each (no device time with ``on_card`` False), and each span
    two readbacks."""

    def __init__(self, calls: int, on_card: bool = True):
        self.recs = []
        ids = iter(range(1, 10 ** 6))
        for k in range(calls):
            for root_name in ROOTS:
                root = self._rec(next(ids), None, root_name, 0, on_card, {})
                root.root = root.id
                kids = [self._rec(next(ids), root, name, k, on_card,
                                  {"readbacks": 2})
                        for name in {s for r, s, _ in SPANS.values()
                                     if r == root_name} for _ in range(2)]
                self.recs += kids + [root]

    @staticmethod
    def _rec(i, parent, name, k, on_card, counts):
        return SimpleNamespace(
            id=i, parent=parent and parent.id, root=parent and parent.root,
            name=name, t0=0, t1=(1 + k) * MS, counts=dict(counts),
            device_ms=float(10 + k) if on_card else None, attrs={})


def traced(units: int):
    return record([{"count": 1, "bytes": 1}] * units, trace=TRACED)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_the_window_total_over_the_units(monkeypatch, name):
    # five calls, the first two made before the window (set-up)
    store = Store(5)
    monkeypatch.setattr(timers, "records", lambda: store.recs)
    got = F.module("metrics", name).read(traced(3))
    per_span = {"host": lambda k: 1 + k, "device": lambda k: 10 + k}
    clock = SPANS[name][2]
    assert got == pytest.approx(
        sum(2 * per_span[clock](k) for k in (2, 3, 4)) / 3)


def test_readbacks_per_build(monkeypatch):
    store = Store(4)
    monkeypatch.setattr(timers, "records", lambda: store.recs)
    # staging's, construction's and the tree's spans, 2 x 2 readbacks each
    want = (2 * 2) * (2 + 4 + 2)
    assert F.module("metrics", "readbacks_per_build").read(traced(3)) == \
        pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SPANS) + ["readbacks_per_build"])
def test_none_on_an_untraced_run(monkeypatch, name):
    store = Store(3)
    monkeypatch.setattr(timers, "records", lambda: store.recs)
    assert F.module("metrics", name).read(
        record([{"count": 1, "bytes": 1}] * 3)) is None


@pytest.mark.parametrize("name", sorted(SPANS))
def test_device_clock_off_the_card(monkeypatch, name):
    store = Store(3, on_card=False)
    monkeypatch.setattr(timers, "records", lambda: store.recs)
    got = F.module("metrics", name).read(traced(3))
    if SPANS[name][2] == "device":
        assert got is None
    else:
        assert got == pytest.approx(2 * (1 + 2 + 3) / 3)


@pytest.mark.parametrize("name", ["tail_ms", "stage_copy_ms"])
def test_a_phase_that_did_not_run_reads_zero(monkeypatch, name):
    store = Store(3)
    store.recs = [r for r in store.recs if r.name != SPANS[name][1]]
    monkeypatch.setattr(timers, "records", lambda: store.recs)
    assert F.module("metrics", name).read(traced(3)) == 0.0


@pytest.mark.parametrize("name", sorted(SPANS) + ["readbacks_per_build"])
def test_none_without_the_tracer(monkeypatch, name):
    """A program without ``utils.timers`` (the commit before it): the
    reader returns None and does not raise."""
    monkeypatch.setitem(sys.modules, "psac_tpu_torch.utils.timers", None)
    assert F.module("metrics", name).read(traced(3)) is None


def test_every_reader_is_in_the_benchmark():
    bench = spec.load_benchmark()
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in list(SPANS) + ["readbacks_per_build"]:
        m = layer[name]
        assert m["source"] == ("program_counter"
                               if name == "readbacks_per_build"
                               else "program_span")
        assert m["workloads"]
