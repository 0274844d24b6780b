"""The idle share, the breakdown and the roofline read from a synthetic
profiler trace."""

import pytest

from portbench.harness import bounds, spec, trace
from portbench.harness.trace import WINDOW, Trace

from test_stats import record

F = spec.Finder()
MS = 1_000_000  # ns


def synthetic():
    """A 100 ms window: kernels busy 0-10, 5-30 (overlapping), 50-60 and
    90-110 ms (past the end), so busy 30 + 10 + 10 = 50 ms."""
    device = [("void pack_kernel<2, false, int>(int const*)", 0, 10 * MS),
              ("void heads_kernel<false, true, int>(int const*)", 5 * MS,
               30 * MS),
              ("Memcpy DtoH (Device -> Pageable)", 50 * MS, 60 * MS),
              ("void other_kernel()", 90 * MS, 110 * MS)]
    host = [(WINDOW, 0, 100 * MS),
            ("stage", 0, 40 * MS), ("aten::item", 32 * MS, 39 * MS),
            ("sa_lcp", 40 * MS, 100 * MS), ("aten::nonzero", 61 * MS,
                                            89 * MS)]
    return Trace(device=device, host=host, window=(0, 100 * MS))


@pytest.mark.parametrize("name, short", [
    ("void pack_kernel<2, false, int>(int const*, long long)", "pack_kernel"),
    ("void (anonymous namespace)::tile_kernel(int const*, int*)",
     "(anonymous namespace)::tile_kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::f<(at::"
     "TensorIteratorBase&)::{lambda(int)#1}> >(int, at::X)",
     "at::native::elementwise_kernel"),
    ("at::native::f(long*, int)", "at::native::f"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
])
def test_short_names(name, short):
    assert trace.short_name(name) == short


def test_busy_and_idle():
    tr = synthetic()
    assert trace.busy_s(tr) == pytest.approx(0.050)
    assert trace.idle_pct(tr) == pytest.approx(50.0)
    assert trace.gaps(tr) == [(30 * MS, 50 * MS), (60 * MS, 90 * MS)]


def test_breakdown():
    tr = synthetic()
    ops = trace.device_ops(tr)
    assert ops[0] == ["heads_kernel", 0.025]
    assert ops[2] == ["Memcpy DtoH (Device -> Pageable)", 0.010]
    assert len(ops) == 4 and ops[-1][1] == pytest.approx(0.010)
    # gap 30-50 ms: its middle (40 ms) starts sa_lcp; gap 60-90 ms: the
    # middle (75 ms) is inside sa_lcp > aten::nonzero
    assert trace.idle_gaps(tr) == [["sa_lcp > aten::nonzero", 0.030],
                                   ["sa_lcp", 0.020]]


def test_idle_metric_needs_device_events():
    units = [{"count": 1, "bytes": 10}]
    read = F.module("metrics", "device_idle_pct.build").read
    assert read(record(units, trace=synthetic())) == pytest.approx(50.0)
    empty = Trace(device=[], host=[], window=(0, MS))
    assert read(record(units, trace=empty)) is None
    assert F.module("metrics", "device_idle_pct.locate").read(
        record(units, trace=synthetic())) is None


def test_kmer_roofline_from_kernel_names():
    tr = synthetic()
    N = 1 << 26
    rec = record([{"count": 1, "bytes": N}], trace=tr,
                 facts={"n": N, "N": N})
    want = (bounds.kmer_pack_bound(N, (10, 10))
            + bounds.kmer_heads_bound(N, (10, 10))) / (0.010 + 0.025)
    assert F.module("metrics", "kmer_init_roofline_pct").read(rec) == \
        pytest.approx(100 * want)
    rec.trace = Trace(device=tr.device[2:], host=[], window=tr.window)
    assert F.module("metrics", "kmer_init_roofline_pct").read(rec) is None


def test_from_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            with record_function("stage"):
                torch.arange(1000).sort()
    tr = trace.from_profiler(prof, {"stage"})
    names = [h[0] for h in tr.host]
    assert "stage" in names and WINDOW in names and tr.device == []
    assert tr.window[1] > tr.window[0]
