"""The port's host memory account (utils/observe.py `mem_sample`,
`mem_track`, `MemGauge`; fed by io/native, pipeline/calling,
pipeline/extsort and ops/refstore) on the CPU:

* a stage keeps the whole sample taken at its highest rss, not each
  part's own maximum, and a part that reads None leaves no counter;
* a real `run` (both stages, the native sort) with the timeline armed:
  every sample's parts are >= 0, the program's live parts plus the
  allocator's free bytes fit inside the resident set, each stage samples
  at its start, its retires and around its final sort, and its peak
  counters are the composition of one of its samples;
* a ColumnarBatch counts (reserved and written) until the last view of
  its buffers is gone; a view of a counted buffer is not counted again;
* a sample below the stage's peak reads its rss alone, unless the
  timeline is armed;
* without mallinfo2 the malloc parts read None and nothing fails; a host
  whose /proc/self/status has no Rss* lines reads rss_file from the file
  mappings, again only after the loader's counts move;
* the ledger: the `mem.` counters stay out of Metrics.as_dict, so the
  stage_stats lines the JAX-parity tests hold stay byte-equal to the JAX
  package's for the same phases and counts;
* the registry under threads: owners dropped on many threads and gauges
  set concurrently leave every part where it began.
"""

import gc
import json
import os
import sys
import threading

import numpy as np
import pytest

from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.utils import observe as jobserve
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.io import native
from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.utils import observe
from test_torch_serve import _reference_natives  # noqa: F401


@pytest.fixture(scope="module")
def run_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_memaccount")
    rng = np.random.default_rng(17)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=40,
                                               error_rate=0.01)
    bam = str(tmp / "input" / "sampleM.bam")
    os.makedirs(os.path.dirname(bam), exist_ok=True)
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    return tmp, fasta, bam


def _counters(m, stage):
    pre = f"mem.{stage}.peak."
    return {k[len(pre):-len("_bytes")]: v for k, v in m.counters.items() if k.startswith(pre)}


def test_a_stage_keeps_its_highest_rss_sample_whole():
    m = observe.Metrics(stage="molecular")
    low = {"rss": 100, "inflight": 50, "malloc_free": 7}
    high = {"rss": 200, "inflight": 10, "malloc_free": None}
    later = {"rss": 150, "inflight": 90, "malloc_free": 30}
    assert m.mem_peak(low) and m.mem_peak(high) and not m.mem_peak(later)
    got = _counters(m, "molecular")
    assert got["rss"] == 200 and got["inflight"] == 10  # not later's 90: one instant
    assert "malloc_free" not in got  # it read None at the peak
    assert m.counters["mem.molecular.samples"] == 3
    assert not m.mem_peak(dict(high))  # a tie keeps the first


@pytest.fixture(scope="module")
def traced_run(run_env):
    tmp, fasta, bam = run_env
    cfg = pconfig.FrameworkConfig(genome_dir=os.path.dirname(fasta),
                                  genome_fasta_file_name=os.path.basename(fasta),
                                  backend="cpu", batch_families=8, sort_engine="native")
    with observe.timeline() as tl:
        _target, _results, stats = pstages.run_pipeline(cfg, bam, outdir=str(tmp / "traced"))
    return stats, tl


def test_a_run_samples_every_batch_boundary_and_its_parts_fit(traced_run):
    stats, tl = traced_run
    assert tl.mem
    for rec in tl.mem:
        parts = rec.parts
        assert all(v >= 0 for v in parts.values() if v is not None), rec
        live = sum(parts[p] for p in observe.MEM_LIVE_PARTS)
        assert live + (parts["malloc_free"] or 0) <= parts["rss"], rec
        assert parts["pinned_staging"] <= parts["pinned"]
        assert parts["ingest_written"] <= parts["ingest_reserved"]
    by_stage = {}
    for rec in tl.mem:
        by_stage.setdefault(rec.stage, []).append(rec)
    assert set(by_stage) == {"molecular", "duplex"}
    for stage, recs in by_stage.items():
        wheres = [r.where for r in recs]
        assert wheres[0] == "start" and wheres[-2:] == ["sort", "sort_end"], wheres
        assert wheres.count("retire") >= 2
        assert all(r.batch is not None for r in recs if r.where == "retire")
        st = stats[stage]
        assert st.metrics.counters[f"mem.{stage}.samples"] == len(recs)
        peak = _counters(st.metrics, stage)
        top = max(recs, key=lambda r: r.parts["rss"])
        assert peak == {p: v for p, v in top.parts.items() if v is not None}
        assert not any(k.startswith("mem.") for k in st.as_dict())


def test_a_columnar_batch_counts_until_its_last_view_is_gone(run_env):
    _tmp, _fasta, bam = run_env
    gc.collect()  # what earlier tests left in cycles goes first
    before = observe._MEM_LIVE.snapshot()
    batches = native.read_columnar(bam, batch_records=64, var_bytes=1 << 16)
    batch = next(batches)
    batches.close()
    held = observe._MEM_LIVE.snapshot()
    reserved = held["ingest_reserved"] - before["ingest_reserved"]
    written = held["ingest_written"] - before["ingest_written"]
    assert reserved >= (1 << 16) * (2 + 6 * 2)  # seq, qual and the 6x u16 aux planes at least
    assert 0 < written < reserved
    assert written >= 2 * int((batch.var_off + batch.l_seq).max())
    view = batch.seq[3:9]
    observe.mem_track_arrays("inflight", view, batch)  # counted already: not again
    assert observe._MEM_LIVE.snapshot()["inflight"] == held["inflight"]
    del batch
    gc.collect()
    after_batch = observe._MEM_LIVE.snapshot()
    seq_bytes = view.base.nbytes
    assert after_batch["ingest_reserved"] - before["ingest_reserved"] == seq_bytes
    del view
    gc.collect()
    assert observe._MEM_LIVE.snapshot() == before


def test_tracked_arrays_and_gauges_come_back_to_zero():
    gc.collect()  # what earlier tests left in cycles goes first
    before = observe._MEM_LIVE.snapshot()

    class Batch:  # a dataclass-like holder, as an encoded batch
        __dataclass_fields__ = {}

        def __init__(self):
            self.bases = np.zeros((4, 100), np.int8)
            self.quals = self.bases.astype(np.float32)

    b = Batch()
    observe.mem_track_arrays("inflight", b, b.bases[1:])
    assert observe._MEM_LIVE.snapshot()["inflight"] - before["inflight"] == 400 + 1600
    gauge = observe.MemGauge("sort_buffer")
    gauge.set(1000)
    gauge.set(300)
    assert observe._MEM_LIVE.snapshot()["sort_buffer"] - before["sort_buffer"] == 300
    gauge.close()
    del b
    gc.collect()
    assert observe._MEM_LIVE.snapshot() == before


def test_a_shared_genome_is_counted_once_and_marked_shared(tmp_path):
    gc.collect()  # what earlier tests left in cycles goes first
    before = observe._MEM_LIVE.snapshot()
    codes = np.zeros(10_000, np.int8)
    a = RefStore(["c"], codes=codes, lengths=[10_000])
    b = RefStore(["c"], codes=codes, lengths=[10_000])
    assert a.codes is codes and b.codes is codes
    now = observe._MEM_LIVE.snapshot()
    assert now["genome"] - before["genome"] == 10_000
    assert now["genome_shared"] - before["genome_shared"] == 10_000
    fasta = str(tmp_path / "g.fa")
    write_fasta(fasta, "c", "ACGT" * 50)
    own = RefStore.from_fasta(fasta)
    now2 = observe._MEM_LIVE.snapshot()
    assert now2["genome"] - now["genome"] == 200 and now2["genome_shared"] == now["genome_shared"]
    del a, b, codes, own
    gc.collect()
    assert observe._MEM_LIVE.snapshot() == before


@pytest.fixture
def fresh_probe(monkeypatch):
    """A memory probe made anew for the test, and forgotten after it."""
    monkeypatch.setattr(observe, "_MEM_PROBE", [])
    yield
    if observe._MEM_PROBE and observe._MEM_PROBE[0] is not None:
        observe._MEM_PROBE[0].close()


def test_no_mallinfo2_reads_none_and_fails_nothing(monkeypatch, fresh_probe):
    monkeypatch.setattr(observe, "_mallinfo2", lambda: None)
    m = observe.Metrics(stage="duplex")
    sample = observe.mem_sample(m, "start")
    assert sample["malloc_in_use"] is None and sample["malloc_free"] is None
    assert sample["rss"] > 0
    got = _counters(m, "duplex")
    assert "malloc_free" not in got and "malloc_in_use" not in got and got["rss"] > 0


def test_without_rss_lines_rss_file_is_the_file_mappings(monkeypatch, fresh_probe):
    reads = []
    real = observe._mapped_file_bytes

    def counted():
        reads.append(1)
        return real()

    monkeypatch.setattr(observe, "_mapped_file_bytes", counted)
    probe = observe._mem_probe()
    probe.split = False
    counts = [(5, 0)]
    probe._loads = lambda: counts[0]
    m = observe.Metrics(stage="molecular")
    with observe.timeline():  # armed: every sample reads every part
        first = observe.mem_sample(m, "start")
        observe.mem_sample(m, "retire")
        assert first["rss_anon"] is None and first["rss_shmem"] is None
        assert first["rss_file"] > 0 and len(reads) == 1  # read once while no library loads
        counts[0] = (6, 0)
        observe.mem_sample(m, "retire")
    assert len(reads) == 2


def test_a_sample_below_the_peak_reads_rss_alone_unless_armed(fresh_probe):
    m = observe.Metrics(stage="duplex")
    m.mem_peak({"rss": 1 << 50})  # no real sample can pass it
    sample = observe.mem_sample(m, "retire")
    assert set(sample) == {"rss"} and m.counters["mem.duplex.samples"] == 2
    assert _counters(m, "duplex") == {"rss": 1 << 50}
    with observe.timeline() as tl:
        armed = observe.mem_sample(m, "retire")
    assert set(armed) == set(observe.MEM_PARTS) and len(tl.mem) == 1
    assert _counters(m, "duplex") == {"rss": 1 << 50}


def test_mem_counters_stay_out_of_the_ledger_line():
    """A Metrics that booked memory samples gives the as_dict the JAX
    package's Metrics gives for the same counts: the stage_stats lines
    the parity tests compare carry no `mem.` key."""
    p, j = observe.Metrics(stage="molecular"), jobserve.Metrics()
    for m in (p, j):
        m.count("records_seen", 7)
        m.add_seconds("sort_write", 0.25)
    observe.mem_sample(p, "start")
    p.mem_peak({"rss": 1 << 40})
    assert any(k.startswith("mem.molecular.peak.") for k in p.counters)
    assert p.as_dict() == j.as_dict()
    assert json.dumps(p.as_dict()) == json.dumps(j.as_dict())


def test_stage_stats_lines_under_a_ledger_carry_no_mem_key(run_env, monkeypatch):
    tmp, fasta, bam = run_env
    sink = str(tmp / "ledger.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    cfg = pconfig.FrameworkConfig(genome_dir=os.path.dirname(fasta),
                                  genome_fasta_file_name=os.path.basename(fasta),
                                  backend="cpu")
    observe.reset_proc_trace()  # the process trace's root lands in this ledger
    try:
        _target, _results, stats = pstages.run_pipeline(cfg, bam, outdir=str(tmp / "ledgered"))
    finally:
        observe.close_sinks()
        observe.reset_proc_trace()  # and the next ledger gets its own
    with open(sink) as fh:
        lines = [json.loads(ln) for ln in fh]
    stage_lines = [d for d in lines if d["event"] == "stage_stats"]
    assert {d["stage"] for d in stage_lines} == {"molecular", "duplex"}
    assert not any(k.startswith("mem.") for d in lines for k in d)
    for d in stage_lines:
        assert stats[d["stage"]].metrics.counters[f"mem.{d['stage']}.samples"] > 0


def test_the_registry_under_threads_returns_every_part():
    """Owners made on one thread and dropped on others, and gauges set
    from many threads at once, with a short switch interval: every part
    ends where it began (a lost update would leave it off)."""
    gc.collect()  # what earlier tests left in cycles goes first
    before = observe._MEM_LIVE.snapshot()
    n_threads = 4 * (os.cpu_count() or 1)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(seed):
            try:
                rng = np.random.default_rng(seed)
                gauge = observe.MemGauge("sort_buffer")
                for _ in range(200):
                    arrays = [np.empty(int(rng.integers(1, 64)), np.uint8) for _ in range(4)]
                    observe.mem_track_arrays("inflight", *arrays)
                    for a in arrays:
                        observe.mem_track(a, ingest_reserved=a.nbytes)  # counted already
                    gauge.set(int(rng.integers(0, 1 << 20)))
                    del arrays
                gauge.close()
            except Exception as exc:  # noqa: BLE001 — surfaced by the assert below
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    gc.collect()
    assert errors == []
    assert observe._MEM_LIVE.snapshot() == before
