"""The deep tiles' readers (deep_rows_pct, deep_tiles_roofline_pct) on
hand-made windows: their arithmetic on the program's 'vote.' counters
and the device trace, the larger of the two bounds, and None where the
program counts no vote plans, the run is untraced or no deep kernel ran."""

import pytest

from harness import cells
from harness.run_cell import WindowRecord

DEEP_KERNEL = "(anonymous namespace)::seg_vote_deep_kernel(CUtensorMap_st, CUtensorMap_st, ..."
PACKED_KERNEL = "(anonymous namespace)::seg_vote_kernel(signed char const*, short const*, ..."


def window(counters, kernel_s=None):
    device = None if kernel_s is None else {"busy_s": 1.0, "window_s": 50.0,
                                             "kernel_s": kernel_s}
    return WindowRecord(seconds=50.0, passes=10, reads=1_000_000, phase_s={}, counters=counters,
                        used_cells=10**9, gaps_s=[], device=device, launches={})


def vote(deep_rows, packed_rows, cells_in, cells_out, chain_rows):
    return {"vote.deep_rows": deep_rows, "vote.packed_rows": packed_rows,
            "vote.deep_cells_in": cells_in, "vote.deep_cells_out": cells_out,
            "vote.deep_chain_rows": chain_rows, "d2h_bytes": 5}


def test_deep_rows_pct_is_the_deep_share_of_the_voted_rows():
    read = cells.metric_reader("deep_rows_pct")
    assert read(window(vote(675, 325, 0, 0, 0))) == pytest.approx(67.5)
    assert read(window(vote(0, 40, 0, 0, 0))) == 0.0


def test_the_bytes_bound_when_it_is_the_larger():
    mod_read = cells.metric_reader("deep_tiles_roofline_pct")
    # 3 B x 1e9 cells in + 6 B x 1e7 out = 3.06e9 B: 913.4 us at 3.35 TB/s;
    # 1,000 chain rows x 4.08 cycles at 1.98 GHz: 2.06 us
    w = window(vote(1, 1, 10**9, 10**7, 1_000), {DEEP_KERNEL: 0.01, PACKED_KERNEL: 5.0})
    assert mod_read(w) == pytest.approx(100 * 3.06e9 / 3.35e12 / 0.01)


def test_the_row_order_bound_when_it_is_the_larger():
    read = cells.metric_reader("deep_tiles_roofline_pct")
    # 1e6 chain rows: 2.0606 ms against 1e6 cells' 0.9 us of bytes
    w = window(vote(1, 1, 10**6, 0, 10**6), {DEEP_KERNEL: 0.004, PACKED_KERNEL: 1.0})
    assert read(w) == pytest.approx(100 * 1e6 * 4.08 / 1.98e9 / 0.004)


@pytest.mark.parametrize("name", ["deep_rows_pct", "deep_tiles_roofline_pct"])
def test_none_without_the_counters(name):
    read = cells.metric_reader(name)
    assert read(window({"d2h_bytes": 5}, {DEEP_KERNEL: 0.01})) is None
    assert read(window({}, {DEEP_KERNEL: 0.01})) is None


def test_none_with_no_rows_voted():
    assert cells.metric_reader("deep_rows_pct")(window(vote(0, 0, 0, 0, 0))) is None


def test_the_roofline_is_none_untraced_or_without_a_deep_kernel():
    read = cells.metric_reader("deep_tiles_roofline_pct")
    counters = vote(100, 10, 10**6, 10**4, 100)
    assert read(window(counters)) is None
    assert read(window(counters, {PACKED_KERNEL: 1.0})) is None
    assert read(window(counters, {DEEP_KERNEL: 0.0})) is None
