"""The host memory readers (host_live_gib, malloc_retained_gib,
rss_unattributed_pct) on hand-made windows: their arithmetic on the
program's `mem.<stage>.peak.<part>_bytes` counters summed over passes,
the choice of the stage whose mean per-pass peak rss is higher, and None
where the program keeps no account or a part is absent."""

import pytest

from harness import cells
from harness.run_cell import WindowRecord

GIB = 2**30
NAMES = ("host_live_gib", "malloc_retained_gib", "rss_unattributed_pct")


def window(counters, passes=2):
    return WindowRecord(seconds=10.0, passes=passes, reads=1_000, phase_s={},
                        counters=counters, used_cells=0, gaps_s=[], device=None, launches={})


def peak(stage, passes=2, **parts):
    """Counters of `stage`'s peak, each part (GiB per pass) summed over passes."""
    out = {f"mem.{stage}.samples": 10 * passes}
    out.update({f"mem.{stage}.peak.{p}_bytes": int(v * GIB) * passes for p, v in parts.items()})
    return out


DUPLEX = dict(rss=9.0, rss_file=4.0, malloc_in_use=4.5, malloc_free=0.5, pinned=0.25,
              pinned_staging=0.125, ingest_reserved=1.0, ingest_written=0.125, inflight=0.0625,
              sort_buffer=0.0625, genome=2.5, genome_shared=2.5)
MOLECULAR = dict(DUPLEX, rss=8.5, malloc_free=1.5, ingest_written=0.5)


def test_arithmetic_at_the_higher_stage():
    w = window({**peak("duplex", **DUPLEX), **peak("molecular", **MOLECULAR),
                "d2h_bytes": 123})
    live = 0.125 + 0.0625 + 0.25 + 0.0625 + 2.5  # ingest written, inflight, pinned, sort, genome
    assert cells.metric_reader("host_live_gib")(w) == pytest.approx(live)
    assert cells.metric_reader("malloc_retained_gib")(w) == pytest.approx(0.5)
    want = 100 * (9.0 - live - 0.5 - 4.0) / 9.0
    assert cells.metric_reader("rss_unattributed_pct")(w) == pytest.approx(want)


def test_the_stage_with_the_higher_mean_peak_is_read():
    mol = dict(MOLECULAR, rss=9.5)
    w = window({**peak("duplex", **DUPLEX), **peak("molecular", **mol)})
    assert cells.metric_reader("malloc_retained_gib")(w) == pytest.approx(1.5)
    assert cells.metric_reader("host_live_gib")(w) == pytest.approx(
        0.5 + 0.0625 + 0.25 + 0.0625 + 2.5)


def test_a_mean_over_passes():
    w = window(peak("duplex", passes=4, **DUPLEX), passes=4)
    assert cells.metric_reader("malloc_retained_gib")(w) == pytest.approx(0.5)
    assert cells.metric_reader("host_live_gib")(w) == pytest.approx(3.0)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_account(name):
    assert cells.metric_reader(name)(window({"d2h_bytes": 5, "ingest_native": 1})) is None
    assert cells.metric_reader(name)(window({})) is None


def test_none_where_a_part_is_absent():
    no_malloc = {k: v for k, v in DUPLEX.items() if k not in ("malloc_free", "malloc_in_use")}
    w = window(peak("duplex", **no_malloc))
    assert cells.metric_reader("malloc_retained_gib")(w) is None
    assert cells.metric_reader("rss_unattributed_pct")(w) is None
    assert cells.metric_reader("host_live_gib")(w) == pytest.approx(3.0)
    no_file = {k: v for k, v in DUPLEX.items() if k != "rss_file"}
    assert cells.metric_reader("rss_unattributed_pct")(window(peak("duplex", **no_file))) is None
