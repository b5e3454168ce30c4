"""The metric arithmetic, on synthetic spans and events."""

import statistics

import pytest

from harness import cells, trace
from harness.run_cell import WindowRecord


def window(**kw):
    base = dict(seconds=10.0, passes=2, reads=1_000_000, phase_s={}, counters={},
                used_cells=0, gaps_s=[], device=None, launches={})
    base.update(kw)
    return WindowRecord(**base)


def test_interval_union_and_busy():
    merged = trace.union([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)])
    assert merged == [[0, 3], [5, 12], [20, 21]]
    assert trace.busy_seconds(merged) == 11


def test_summary_gaps_named_by_the_host():
    ev = [("k1", 1e6, 2e6), ("k2", 1.5e6, 3e6), ("k1", 7e6, 8e6)]
    s = trace.summarize(ev, 10.0, lambda t: "early" if t < 5 else "late")
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["kernel_s"] == {"k1": 2.0, "k2": 1.5}
    assert s["idle_gaps"] == [["late", 4.0], ["late", 2.0], ["early", 1.0]]


def test_p95_of_gaps():
    read = cells.metric_reader("batch_gap_ms_p95")
    gaps = [i / 1000 for i in range(1, 101)]
    assert read(window(gaps_s=gaps)) == pytest.approx(1e3 * statistics.quantiles(gaps, n=20)[18])
    assert read(window(gaps_s=gaps[:5])) is None


@pytest.mark.parametrize("name,phases,want", [
    ("ingest_us_per_read", {"ingest": 2.0}, 2.0),
    ("encode_us_per_read", {"encode": 3.0}, 3.0),
    ("host_vote_us_per_read", {"host_vote": 0.5}, 0.5),
    ("rawize_us_per_read", {"rawize": 4.0}, 4.0),
    ("emit_sort_us_per_read", {"emit": 1.0, "sort_write": 1.5}, 2.5),
])
def test_per_read_division(name, phases, want):
    read = cells.metric_reader(name)
    assert read(window(phase_s=phases)) == pytest.approx(want)
    assert read(window(phase_s={})) is None


def test_window_rate_over_whole_window():
    read = cells.metric_reader("window_reads_per_s")
    assert read(window(seconds=12.5, reads=500_000)) == pytest.approx(40_000)
    assert read(window(reads=0)) is None


def test_stall_and_idle_shares():
    assert cells.metric_reader("stall_pct")(window(phase_s={"stall": 2.5})) == pytest.approx(25)
    dev = {"busy_s": 0.5, "window_s": 10.0, "kernel_s": {}}
    assert cells.metric_reader("device_idle_pct")(window(device=dev)) == pytest.approx(95)
    assert cells.metric_reader("device_idle_pct")(window()) is None


def test_roofline_counts_real_cells_not_padding():
    """The same observations padded two ways: the used cells are equal,
    so the reading is; only the kernels' own time moves it."""
    import numpy as np

    read = cells.metric_reader("vote_roofline_pct")
    obs = np.full((3, 2, 100), 4, np.int8)
    obs[:, :, 10:60] = 1
    narrow = np.full((3, 2, 128), 4, np.int8)
    narrow[..., :100] = obs
    wide = np.full((4, 2, 256), 4, np.int8)
    wide[:3, :, :100] = obs
    dev = {"busy_s": 1.0, "window_s": 2.0,
           "kernel_s": {"seg_vote_kernel(...)": 1e-6, "vote_finalize_kernel": 1e-6, "copy": 5.0}}
    a = read(window(used_cells=int((narrow != 4).sum()), device=dev))
    b = read(window(used_cells=int((wide != 4).sum()), device=dev))
    assert a == b == pytest.approx(100 * 2 * 300 / 3.35e12 / 2e-6)
    assert read(window(used_cells=300, device={**dev, "kernel_s": {"copy": 1.0}})) is None
