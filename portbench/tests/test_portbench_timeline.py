"""The readers of the program's dotted parts, and the timeline laid against
the device (harness/timeline.py), on synthetic spans; `-m card`: the
program's span and the device's kernel on one clock."""

import collections

import pytest

from harness import cells
from harness import timeline as htl
from harness.run_cell import WindowRecord

Span = collections.namedtuple(
    "Span", "name path stage thread batch span parent t0_ns t1_ns wall_ns cpu_ns")


def window(**kw):
    base = dict(seconds=10.0, passes=2, reads=1_000_000, phase_s={}, counters={},
                used_cells=0, gaps_s=[], device=None, launches={})
    base.update(kw)
    return WindowRecord(**base)


def test_kernel_us_per_read_reads_the_kernel_span():
    read = cells.metric_reader("kernel_us_per_read")
    assert read(window(phase_s={"kernel": 3.0, "kernel.pack": 1.0})) == pytest.approx(3.0)
    assert read(window(phase_s={"encode": 1.0})) is None


def test_stall_encode_pct_reads_the_encode_part_or_nothing():
    read = cells.metric_reader("stall_encode_pct")
    assert read(window(phase_s={"stall": 4.0, "stall.encode": 1.5})) == pytest.approx(15.0)
    assert read(window(phase_s={"stall": 4.0})) is None  # a program with one stall


def S(name, t0, t1, thread="MainThread", batch=None, sid=None, parent=None, stage="duplex",
      path=None, cpu=None):
    return Span(name, path or name, stage, thread, batch, sid or f"{name}@{t0}", parent,
                t0, t1, t1 - t0, cpu)


def _records():
    """Batch 1 of a duplex pass: its encode on a host worker, its stall on
    the dispatch thread while the overlap worker fetched then rawized;
    then batch 2 retired with nothing open for 10 ns."""
    b1 = S("batch", 0, 100, batch=1, sid="b1")
    b2 = S("batch", 5, 140, batch=2, sid="b2")
    return [
        b1, b2,
        S("ingest", 0, 5, sid="i1", cpu=5),
        S("encode", 5, 20, thread="bsseq-host_0", batch=1, sid="e1", parent="b1", cpu=15),
        S("kernel", 20, 30, thread="bsseq-ovl_0", batch=1, sid="k1", parent="b1", cpu=8),
        S("fetch", 30, 45, thread="bsseq-ovl_0", batch=1, sid="f1", parent="b1", cpu=3),
        S("rawize", 45, 100, thread="bsseq-ovl_0", batch=1, sid="r1", parent="b1", cpu=44),
        S("stall", 40, 100, batch=1, sid="s1", parent="b1"),
        S("stall.batch", 40, 100, batch=1, sid="sb1", parent="s1", path="stall/stall.batch"),
        S("stall", 110, 140, batch=2, sid="s2", parent="b2"),
    ]


def test_idle_gaps_are_the_window_outside_the_busy_union():
    assert htl.idle_gaps([[10, 20], [30, 35]], 0, 50) == [(0, 10), (20, 30), (35, 50)]
    assert htl.idle_gaps([[0, 60]], 0, 50) == []


def test_a_gap_is_named_by_the_dispatch_threads_innermost_span_and_the_awaited_worker():
    t = htl.Timeline(_records())
    assert t.label(50, 90) == "duplex/stall.batch<-rawize"
    assert t.label(41, 44) == "duplex/stall.batch<-fetch"
    assert t.label(0, 5) == "duplex/ingest"
    assert t.label(101, 109) == "duplex/(no span)"
    by = t.idle_by_label([(0, 5), (40, 100), (100, 110)])
    assert by == {"duplex/stall.batch<-rawize": pytest.approx(60e-9),
                  "duplex/(no span)": pytest.approx(10e-9),
                  "duplex/ingest": pytest.approx(5e-9)}
    assert list(by)[0] == "duplex/stall.batch<-rawize"


def test_unattributed_idle_is_the_share_with_no_dispatch_span_open():
    t = htl.Timeline(_records())
    assert t.idle_unattributed_pct([(0, 5), (100, 110)]) == pytest.approx(100 * 10 / 15)
    assert t.idle_unattributed_pct([]) is None
    assert htl.Timeline([]).idle_unattributed_pct([(0, 5)]) is None


def test_retire_gaps_restart_with_each_pass_and_stage():
    recs = []
    for p in range(3):
        for stage in ("molecular", "duplex"):
            base = 1000 * p + (500 if stage == "duplex" else 0)
            recs += [S("batch", base, base + 10 * b, batch=b, stage=stage,
                       sid=f"{stage}{p}.{b}") for b in range(1, 9)]
    t = htl.Timeline(recs)
    assert t.retire_gaps_s() == [10e-9] * 42
    assert t.retire_gap_ms_p95() == pytest.approx(1e-5)
    assert htl.Timeline(recs[:8]).retire_gap_ms_p95() is None  # under 20 gaps


def test_host_span_cpu_share_counts_outermost_host_spans_only():
    t = htl.Timeline(_records())
    # encode 15/15, kernel 8/10, fetch 3/15, rawize 44/55, ingest 5/5; waits left out
    assert t.host_span_cpu_pct() == pytest.approx(100 * 75 / 100)
    assert htl.Timeline([S("stall", 0, 10, cpu=1)]).host_span_cpu_pct() is None
    assert t.cpu_pct_by_name() == {"encode": 100.0, "fetch": 20.0, "ingest": 100.0,
                                   "kernel": 80.0, "rawize": 80.0}


@pytest.mark.card
def test_a_span_encloses_its_kernel_on_the_devices_clock(cuda_card):
    torch = cuda_card
    from bsseqconsensusreads_tpu_torch.utils import observe

    torch.cuda.synchronize()
    m = observe.Metrics()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with observe.timeline() as tl, prof:
        with m.timed("kernel"):
            torch.cuda._sleep(50_000_000)
            torch.cuda.synchronize()
    (span,) = tl.records
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    sleep = max(kernels, key=lambda e: e.time_range.end - e.time_range.start)
    start = base + int(sleep.time_range.start * 1e3)
    end = base + int(sleep.time_range.end * 1e3)
    print(f"span {span.t0_ns}..{span.t1_ns}, {sleep.name} {start}..{end}: "
          f"lead {(start - span.t0_ns) / 1e3} us, tail {(span.t1_ns - end) / 1e3} us")
    assert span.t0_ns <= start < end <= span.t1_ns
    assert (end - start) > 0.5 * (span.t1_ns - span.t0_ns)
