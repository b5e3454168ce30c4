"""The port's span timeline (utils/observe.py `timeline`) on the CPU:

* off: no records are kept, and Metrics' seconds, spans, owner seconds and
  counters are what an unarmed run's are (a deterministic clock);
* the group stream's pulls (`Metrics.pulls`) book what a `timed` span per
  pull booked, nested parts included, once per `book`;
* on, over a CPU `run` on the wire with two host workers and two overlap
  workers:
  every batch's spans carry its index, every parent resolves, a
  'stall.batch' on batch N leads to N's worker spans, each new dotted
  part ('kernel.pack', 'kernel.h2d', 'stall.encode', 'stall.batch') lies
  inside its parent and the parts sum to no more than it, and 'ingest'
  is the bare-clock sum with at most one interval per chunk;
* the clock: a span around one large torch op encloses that op's CPU
  event placed by torch.profiler's trace_start_ns(), to within 1 ms;
* under BSSEQ_TPU_STATS and BSSEQ_TPU_TRACE: the per-batch 'span' lines
  pass ledger_tools.check_ledger and assemble in trace_tools with no
  orphans, and each stage's Chrome trace holds the spans.
"""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.utils import ledger_tools, observe, trace_tools
from test_torch_serve import _reference_natives  # noqa: F401

NEW_PARTS = ("kernel.pack", "kernel.h2d", "stall.encode", "stall.batch")


class _Clock:
    """A deterministic clock: each call advances by the next step."""

    def __init__(self):
        self._n = 0
        self.t = 100.0

    def __call__(self):
        self._n += 1
        self.t += 0.001 * (self._n % 7 + 1)
        return self.t


def _drive(m):
    """Every timer entry point, on the owner thread and a worker, with a
    bound batch and a group stream pulled in two chunks."""
    def groups():
        for i in range(5):
            if i == 3:
                with m.timed("ingest.idle"):
                    pass
            yield i

    pulls = m.pulls(groups(), "ingest")
    for chunk in (2, 3):
        for _ in range(chunk):
            next(pulls)
        pulls.book()
    assert list(pulls) == []
    pulls.book()
    observe.batch_open(1, "molecular")
    with observe.bind_batch(1, "molecular"), m.timed("stall"), m.timed("stall.batch"):
        pass

    def worker():
        with observe.bind_batch(1, "molecular"), m.timed("kernel"):
            with m.timed("kernel.pack"):
                pass
            with m.timed("kernel.h2d"):
                pass
        m.add_seconds("sort_write", 0.25)
        m.add_sub_seconds("sort_write.merge", 0.125)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    observe.batch_close(1, "molecular")
    m.count("records_seen", 7)
    return m


def _state(m):
    return m.seconds, m.spans, m.owner_seconds, m.counters


def test_off_keeps_nothing_and_books_what_an_unarmed_run_books():
    with observe.timeline() as earlier:
        pass
    off = _drive(observe.Metrics(clock=_Clock(), stage="molecular"))
    assert earlier.records == [] and earlier.dropped == 0
    with observe.timeline() as tl:
        on = _drive(observe.Metrics(clock=_Clock(), stage="molecular"))
    assert _state(on) == _state(off)
    assert off.phase_summary(3.0) == on.phase_summary(3.0)
    names = collections.Counter(r.name for r in tl.records)
    assert names == {"ingest": 3, "ingest.idle": 1, "stall": 1, "stall.batch": 1, "kernel": 1,
                     "kernel.pack": 1, "kernel.h2d": 1, "sort_write": 1,
                     "sort_write.merge": 1, "batch": 1}


def _timed_per_pull(items, m, name):
    """The stage's former group timer: one `timed` span per pull."""
    items = iter(items)
    while True:
        with m.timed(name):
            try:
                item = next(items)
            except StopIteration:
                return
        yield item


@pytest.mark.parametrize("chunks", [(1,), (2, 2), (4,), (1, 1, 1, 1)])
def test_pulls_book_what_a_span_per_pull_booked(chunks):
    def source(m):
        for i in range(4):
            if i % 2:
                with m.timed("ingest.sweep"):
                    pass
            yield i

    per_pull = observe.Metrics(clock=_Clock())
    assert list(_timed_per_pull(source(per_pull), per_pull, "ingest")) == [0, 1, 2, 3]
    booked = observe.Metrics(clock=_Clock())
    pulls = booked.pulls(source(booked), "ingest")
    got = []
    for n in chunks:
        got += [next(pulls) for _ in range(n)]
        pulls.book()
    got += list(pulls)
    pulls.book()
    assert got == [0, 1, 2, 3]
    assert _state(booked) == _state(per_pull)
    assert booked.span_tree() == per_pull.span_tree()
    assert booked.span_tree()["ingest"]["calls"] == 5  # four items and the end


def test_a_pull_inside_an_open_span_is_timed_as_before():
    m = observe.Metrics(clock=_Clock())
    pulls = m.pulls(iter([1, 2]), "ingest")
    with m.timed("sort_write"):
        assert next(pulls) == 1
    pulls.book()
    assert m.spans["sort_write/ingest"][1] == 1 and "ingest" not in m.owner_seconds


# ---------------------------------------------------------------------------
# a CPU run with the timeline armed


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_timeline")
    rng = np.random.default_rng(41)
    name, genome = random_genome(rng, 12000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=60,
                                               error_rate=0.01)
    bam = str(tmp / "input" / "sampleT.bam")
    os.makedirs(os.path.dirname(bam), exist_ok=True)
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    return tmp, fasta, bam


@pytest.fixture(scope="module")
def armed_run(inputs):
    tmp, fasta, bam = inputs
    cfg = pconfig.FrameworkConfig(genome_dir=os.path.dirname(fasta),
                                  genome_fasta_file_name=os.path.basename(fasta),
                                  backend="cpu", batch_families=8, transport="wire")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BSSEQ_TPU_HOST_WORKERS", "2")
        mp.setenv("BSSEQ_TPU_OVERLAP_THREADS", "2")
        with observe.timeline() as tl:
            _target, _rules, stats = pstages.run_pipeline(cfg, bam, outdir=str(tmp / "armed"),
                                                           force=True)
    return tl, stats


def test_every_batch_span_carries_its_index_and_every_parent_resolves(armed_run):
    tl, _stats = armed_run
    recs = tl.records
    assert tl.dropped == 0 and recs
    ids = {r.span for r in recs}
    assert len(ids) == len(recs)
    assert all(r.parent is None or r.parent in ids for r in recs)
    workers = [r for r in recs if r.thread.startswith(("bsseq-ovl", "bsseq-host"))]
    assert {r.name for r in workers} >= {"encode", "kernel", "fetch", "emit"}
    assert all(r.batch is not None for r in workers)
    by_id = {r.span: r for r in recs}
    for stage in ("molecular", "duplex"):
        batches = [r for r in recs if r.name == "batch" and r.stage == stage]
        assert len(batches) > 1 and all(b.thread == "MainThread" for b in batches)
    for r in workers:  # a worker's spans descend from their batch's record
        top = r
        while top.parent is not None:
            top = by_id[top.parent]
        assert top.name == "batch" and top.batch == r.batch and top.stage == r.stage


def test_a_stall_on_batch_n_leads_to_n_s_worker_spans(armed_run):
    tl, _stats = armed_run
    by_id = {r.span: r for r in tl.records}
    children = collections.defaultdict(list)
    for r in tl.records:
        children[r.parent].append(r)
    stalls = [r for r in tl.records if r.name == "stall.batch"]
    assert {r.stage for r in stalls} == {"molecular", "duplex"}
    for s in stalls:
        batch = by_id[by_id[s.parent].parent]
        assert by_id[s.parent].name == "stall" and batch.name == "batch"
        assert batch.batch == s.batch
        on_worker = [c for c in children[batch.span] if c.thread.startswith("bsseq-ovl")]
        assert {c.name for c in on_worker} >= {"kernel", "emit"}
        assert all(c.batch == s.batch for c in on_worker)


def test_the_new_parts_lie_inside_their_parent_and_sum_to_no_more(armed_run):
    tl, stats = armed_run
    by_id = {r.span: r for r in tl.records}
    parts = collections.defaultdict(int)
    seen = set()
    for r in tl.records:
        if r.name not in NEW_PARTS:
            continue
        seen.add(r.name)
        parent = by_id[r.parent]
        assert parent.name == r.name.split(".")[0] and parent.thread == r.thread
        assert parent.t0_ns <= r.t0_ns <= r.t1_ns <= parent.t1_ns
        parts[parent.span] += r.wall_ns
    assert seen == set(NEW_PARTS)
    assert all(ns <= by_id[sid].wall_ns for sid, ns in parts.items())
    for st in stats.values():
        secs = st.metrics.seconds
        assert secs["kernel.pack"] + secs["kernel.h2d"] <= secs["kernel"]
        assert secs["stall.encode"] + secs["stall.batch"] <= secs["stall"]


def test_ingest_is_the_bare_clock_sum_with_one_interval_a_chunk(armed_run):
    tl, stats = armed_run
    for stage, st in stats.items():
        ingest = [r for r in tl.records if r.name == "ingest" and r.stage == stage]
        chunks = sum(1 for r in tl.records if r.name == "batch" and r.stage == stage)
        assert 1 <= len(ingest) <= chunks + 1
        assert all(r.thread == "MainThread" and r.wall_ns <= r.t1_ns - r.t0_ns for r in ingest)
        assert sum(r.wall_ns for r in ingest) / 1e9 == pytest.approx(
            st.metrics.seconds["ingest"], abs=1e-9 * (len(ingest) + 1))
        assert st.metrics.spans["ingest"][1] > len(ingest)  # every pull a call, booked per chunk


def test_host_spans_carry_their_threads_cpu_time(armed_run):
    tl, _stats = armed_run
    timed = [r for r in tl.records if r.cpu_ns is not None]
    assert timed and all(r.cpu_ns >= 0 for r in timed)
    assert sum(r.cpu_ns for r in timed if r.name == "encode") > 0


# ---------------------------------------------------------------------------
# the clock


def test_a_span_encloses_its_torch_op_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(384, 384)
    m = observe.Metrics()
    with observe.timeline() as tl, profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.timed("kernel"):
            x @ x
    (span,) = tl.records
    base = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    start = base + int(mm.time_range.start * 1e3)
    end = base + int(mm.time_range.end * 1e3)
    assert span.t0_ns - 1_000_000 <= start <= end <= span.t1_ns + 1_000_000


# ---------------------------------------------------------------------------
# the ledger's span lines and the Chrome trace


@pytest.fixture(scope="module")
def traced_run(inputs, tmp_path_factory):
    tmp, fasta, bam = inputs
    out = tmp_path_factory.mktemp("torch_timeline_traced")
    sink, trace = str(out / "ledger.jsonl"), out / "traces"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BSSEQ_TPU_HOST_WORKERS", "2")
        mp.setenv("BSSEQ_TPU_OVERLAP_THREADS", "2")
        mp.setenv("BSSEQ_TPU_STATS", sink)
        mp.setenv("BSSEQ_TPU_TRACE", str(trace))
        observe.close_sinks()
        observe.reset_proc_trace()
        rc = cli.main(["run", "--bam", bam, "--reference", fasta, "--device", "cpu",
                       "--force", "--outdir", str(out / "run")])
        observe.close_sinks()
        observe.reset_proc_trace()
    assert rc == 0
    return sink, trace


def test_per_batch_span_lines_check_and_assemble_with_no_orphans(traced_run):
    sink, _trace = traced_run
    with open(sink) as fh:
        lines = [json.loads(x) for x in fh]
    spans = [d for d in lines if d["event"] == "span" and "stage" in d]
    assert {d["stage"] for d in spans} == {"molecular", "duplex"}
    assert {"batch", "stall.batch", "kernel", "encode", "ingest"} <= {d["name"] for d in spans}
    assert all(isinstance(d["batch"], int) for d in spans if d["name"] == "batch")
    assert ledger_tools.check_ledger(sink) == []
    report = trace_tools.assemble(sink)
    assert report.orphans == [] and report.parse_problems == []
    (proc,) = [t for t in report.traces.values() if t.kind == "proc"]
    assert len(proc.spans) >= len(spans)


def test_each_stage_chrome_trace_holds_the_spans(traced_run):
    _sink, trace = traced_run
    assert sorted(os.listdir(trace)) == ["duplex", "molecular"]
    for stage in ("duplex", "molecular"):
        (name,) = os.listdir(trace / stage)
        with open(trace / stage / name) as fh:
            doc = json.load(fh)
        ours = [e for e in doc["traceEvents"] if e.get("cat") == "bsseq_span"]
        assert {"batch", "stall.batch", "kernel"} <= {e["name"] for e in ours}
        assert {e["args"]["stage"] for e in ours} == {stage}
        lanes = [e for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e["args"].get("name", "").startswith("spans ")]
        assert len(lanes) == len({e["tid"] for e in ours}) >= 2
        # on the trace's own clock: inside the profiler's span of the stage
        ops = [e for e in doc["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") != "bsseq_span"]
        assert ops and min(e["ts"] for e in ops) <= min(e["ts"] for e in ours)
        assert max(e["ts"] + e["dur"] for e in ours) <= max(e["ts"] + e["dur"] for e in ops)
