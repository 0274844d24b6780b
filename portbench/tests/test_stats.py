"""The end-to-end arithmetic: a rate over all the work of the window, a
p95 over every batch, not statistics of chunks."""

import numpy as np
import pytest

from portbench.harness import spec
from portbench.harness.runner import RunRecord
from portbench.harness.stats import p95, rate

F = spec.Finder()


def record(units, window_s=10.0, **kw):
    base = dict(workload="w", config={}, traffic={}, units=units,
                window_s=window_s, setup_s=3.0, peak_bytes=None,
                facts={"n": 1000, "N": 1024}, spans={}, counters={},
                trace=None)
    base.update(kw)
    return RunRecord(**base)


def test_rate_is_all_work_over_all_time():
    assert rate([3, 4, 5], 4.0) == 3.0


def test_build_mbps_counts_every_build_over_the_window():
    units = [{"count": 1, "bytes": 200_000_000}] * 7
    assert F.module("metrics", "build_mbps").read(record(units, 14.0)) \
        == pytest.approx(100.0)
    assert F.module("metrics", "locate_pps").read(record(units)) is None


def test_p95_is_over_every_batch():
    lat = [0.1] * 95 + [1.0] * 5
    # the medians of chunks of 20 would all read 0.1
    assert p95(lat) == pytest.approx(np.percentile(lat, 95))
    assert p95(lat) > 0.1
    units = [{"count": 10, "patterns": 10, "latency_s": x} for x in lat]
    rec = record(units, window_s=20.0)
    assert F.module("metrics", "locate_p95_ms").read(rec) == \
        pytest.approx(1e3 * np.percentile(lat, 95))
    assert F.module("metrics", "locate_pps").read(rec) == 50.0


def test_peak_and_setup_and_span_means():
    rec = record([], peak_bytes=160_000, setup_s=12.5,
                 spans={"st": [0.1, 0.3]}, counters={"search_steps": [4, 6]})
    assert F.module("metrics", "peak_bytes_per_char").read(rec) == 160.0
    assert F.module("metrics", "setup_s").read(rec) == 12.5
    assert F.module("metrics", "st_ms").read(rec) == pytest.approx(200.0)
    assert F.module("metrics", "stage_ms").read(rec) is None
    assert F.module("metrics", "search_steps").read(rec) == 5.0
    assert F.module("metrics", "peak_bytes_per_char").read(
        record([])) is None
