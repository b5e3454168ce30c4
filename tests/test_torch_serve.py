"""The port's serve engine (bsseqconsensusreads_tpu_torch.serve) on the CPU,
held against the JAX package's serve contract (tests/test_serve.py):

* identity — every job's BAM SHA-equal to the JAX package's `molecular
  --batching sequential` of the same input, and to the JAX package's own
  ServeEngine run with BSSEQ_TPU_HOST_WORKERS=0 (its engine drains only
  then: ROADMAP queue 3), with 2 and 3 interleaved tenants sharing device
  batches (batches_shared_jobs > 0), with 0 and 4 host workers;
* isolation — a corrupt tenant under strict fails alone, under quarantine
  completes with the JAX package's bytes and counts, a stalled tenant does
  not hold its neighbour;
* admission — the same refusals with the same exception types as the JAX
  package's engine;
* lifecycle — drain() returns True with 0 and 4 host workers (the JAX
  engine does not drain with its host pool on), JobMi rides the Python
  encode and emit to the retire, FLUSH_BATCH and the prefetch barrier;
* the per-job ledger lines read by the JAX package's utils.ledger_tools.

Tolerance: equality (SHA-256 of the BAMs, equal counters and types).
"""

import hashlib
import json
import os
import time

import numpy as np
import pytest

from bsseqconsensusreads_tpu import cli as jcli
from bsseqconsensusreads_tpu import serve as jserve
from bsseqconsensusreads_tpu.io.bam import BamReader, BamWriter
from bsseqconsensusreads_tpu.utils import ledger_tools
from bsseqconsensusreads_tpu.utils.testing import make_grouped_bam_records
from bsseqconsensusreads_tpu_torch.faults import failpoints
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling
from bsseqconsensusreads_tpu_torch.serve import (
    AdmissionError,
    JobMi,
    JobSpec,
    QueueClosed,
    ServeEngine,
)
from bsseqconsensusreads_tpu_torch.utils import observe
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives

GENOME = "".join("ACGT"[i] for i in np.random.default_rng(7).integers(0, 4, size=2000))


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _unarmed():
    yield
    failpoints.disarm()


def grouped_bam(path: str, seed: int, n_families: int = 6, read_len: int = 40) -> str:
    """The JAX serve tests' tenant input: make_grouped_bam_records over one
    random genome, 2-3 templates per strand."""
    header, records = make_grouped_bam_records(
        np.random.default_rng(seed), f"chr{seed % 97}", GENOME,
        n_families=n_families, reads_per_strand=(2, 3), read_len=read_len,
    )
    with BamWriter(path, header) as w:
        for r in records:
            w.write(r)
    return path


def corrupt_copy(src: str, dst: str) -> str:
    """The JAX serve tests' content corruption: one record without MI,
    another with a qual out of range; the BGZF framing stays valid."""
    with BamReader(src) as r, BamWriter(dst, r.header) as w:
        for i, rec in enumerate(r):
            if i == 3:
                del rec.tags["MI"]
            elif i == 9:
                rec.qual = bytes([200]) + rec.qual[1:]
            w.write(rec)
    return dst


def sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def jax_standalone(inp: str, out: str) -> str:
    """The JAX package's `molecular --batching sequential` on the input."""
    assert jcli.main(["molecular", "-i", inp, "-o", out, "--batching", "sequential"]) == 0
    return sha(out)


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    """Three tenant inputs and the JAX package's standalone SHAs: 16
    families each, so that after the first chunks (pulled while the second
    reader may still be opening its input) the queues interleave."""
    d = tmp_path_factory.mktemp("serve_tenants")
    inputs = [grouped_bam(str(d / f"in{k}.bam"), seed=100 + k, n_families=16)
              for k in range(3)]
    refs = [jax_standalone(p, str(d / f"ref{k}.bam")) for k, p in enumerate(inputs)]
    return d, inputs, refs


def run_engine(eng, inputs, outdir, stall_first_retire=False):
    """Submit every input, start the engine (after the submits, so both
    queues fill before the first chunk is cut), wait for every job."""
    jobs = [eng.submit({"input": p, "output": str(outdir / f"out{k}.bam")})
            for k, p in enumerate(inputs)]
    if stall_first_retire:
        failpoints.arm("serve_retire=stall:0.5s:times=1")
    eng.start()
    states = [eng.wait(j.id, timeout=60)["state"] for j in jobs]
    failpoints.disarm()
    return jobs, states


@pytest.mark.parametrize("host_workers", ["0", "4"])
@pytest.mark.parametrize("n_jobs", [2, 3])
def test_interleaved_jobs_equal_the_jax_packages(tenants, tmp_path, monkeypatch,
                                                 n_jobs, host_workers):
    """Tenants sharing device batches write the JAX package's standalone
    bytes, and drain() returns True, with the host pool off and on."""
    _d, inputs, refs = tenants
    monkeypatch.setenv("BSSEQ_TPU_HOST_WORKERS", host_workers)
    eng = ServeEngine(device="cpu", batch_families=4, stride=2)
    try:
        jobs, states = run_engine(eng, inputs[:n_jobs], tmp_path, stall_first_retire=True)
        assert states == ["done"] * n_jobs
        for k in range(n_jobs):
            assert sha(str(tmp_path / f"out{k}.bam")) == refs[k]
        counters = eng.scheduler.counters()
        assert counters.get("batches_shared_jobs", 0) > 0
        assert counters.get("records_dropped", 0) == 0
        stats = eng.scheduler.stats
        assert sum(j.families for j in jobs) == stats.families
        assert sum(j.consensus_out for j in jobs) == stats.consensus_out
        t0 = time.monotonic()
        assert eng.drain(timeout=30)
        assert time.monotonic() - t0 < 5.0
    finally:
        eng.stop(timeout=30)


def test_jax_engine_without_host_workers_writes_the_same_bytes(tenants, tmp_path, monkeypatch):
    """The JAX package's own engine (host pool off, the mode in which it
    drains) over the same three tenants: the port's bytes, the same
    per-job families and consensus counts."""
    _d, inputs, refs = tenants
    monkeypatch.setenv("BSSEQ_TPU_HOST_WORKERS", "0")
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jeng = jserve.ServeEngine(batch_families=4, stride=2)
    peng = ServeEngine(device="cpu", batch_families=4, stride=2)
    try:
        jjobs = [jeng.submit({"input": p, "output": str(jdir / f"out{k}.bam")})
                 for k, p in enumerate(inputs)]
        jeng.start()
        assert [jeng.wait(j.id, timeout=60)["state"] for j in jjobs] == ["done"] * 3
        assert jeng.drain(timeout=30)
        pjobs, states = run_engine(peng, inputs, pdir)
        assert states == ["done"] * 3
        for k in range(3):
            assert sha(str(pdir / f"out{k}.bam")) == sha(str(jdir / f"out{k}.bam")) == refs[k]
        assert [(j.families, j.consensus_out) for j in pjobs] == \
            [(j.families, j.consensus_out) for j in jjobs]
        assert [j.id for j in pjobs] == [j.id for j in jjobs]
    finally:
        jeng.stop(timeout=30)
        peng.stop(timeout=30)


def test_lone_job_completes_without_load(tenants, tmp_path):
    """One quiet job retires: the idle scheduler cuts the partial chunk and
    an empty sync chunk drains the retire pipeline."""
    _d, inputs, refs = tenants
    eng = ServeEngine(device="cpu", batch_families=4, stride=2).start()
    try:
        job = eng.submit({"input": inputs[0], "output": str(tmp_path / "out.bam")})
        assert eng.wait(job.id, timeout=60)["state"] == "done"
        assert sha(str(tmp_path / "out.bam")) == refs[0]
        assert eng.status(job.id)["latency_s"] >= 0
    finally:
        assert eng.stop(timeout=30)


# ---------------------------------------------------------------------------
# admission: the JAX engine's refusals, type for type


def _refusal(engine, spec):
    try:
        engine.submit(spec)
    except Exception as exc:  # noqa: BLE001 — the type is what is compared
        return type(exc).__name__, str(exc)
    return None, None


@pytest.mark.parametrize("case", ["policy", "missing", "garbage-strict", "garbage-quarantine",
                                  "no-output", "ingest", "chemistry", "grouping"])
def test_admission_refusals_equal_the_jax_packages(tenants, tmp_path, case):
    _d, inputs, _refs = tenants
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"this is not a BAM file, not even close")
    spec = {
        "policy": {"input": inputs[0], "output": "o.bam", "policy": "yolo"},
        "missing": {"input": str(tmp_path / "nope.bam"), "output": "o.bam"},
        "garbage-strict": {"input": str(bad), "output": "o.bam", "policy": "strict"},
        "garbage-quarantine": {"input": str(bad), "output": "o.bam", "policy": "quarantine"},
        "no-output": {"input": inputs[0], "output": ""},
        "ingest": {"input": inputs[0], "output": "o.bam", "ingest": "fast"},
        "chemistry": {"input": inputs[0], "output": "o.bam", "chemistry": "rna"},
        "grouping": {"input": inputs[0], "output": "o.bam", "grouping": "random"},
    }[case]
    jeng = jserve.ServeEngine(batch_families=4)
    peng = ServeEngine(device="cpu", batch_families=4)
    jtype, jmsg = _refusal(jeng, spec)
    ptype, pmsg = _refusal(peng, spec)
    assert jtype == ptype == "AdmissionError"
    assert pmsg.split(":")[0] == jmsg.split(":")[0]
    assert peng.queue.jobs() == [] and peng.queue.pending_count() == 0


def test_spec_and_closed_queue_refusals(tenants, tmp_path):
    _d, inputs, _refs = tenants
    with pytest.raises(AdmissionError, match="input"):
        JobSpec.from_dict({"output": "x.bam"})
    with pytest.raises(jserve.AdmissionError, match="input"):
        jserve.JobSpec.from_dict({"output": "x.bam"})
    eng = ServeEngine(device="cpu", batch_families=4).start()
    assert eng.drain(timeout=30)
    with pytest.raises(QueueClosed):
        eng.submit({"input": inputs[0], "output": str(tmp_path / "o.bam")})
    job_spec = JobSpec.from_dict({"input": inputs[0], "output": "o.bam", "ingest": None})
    assert job_spec.as_dict() == jserve.JobSpec.from_dict(
        {"input": inputs[0], "output": "o.bam", "ingest": None}).as_dict()


def test_admitted_job_fingerprint_equals_the_jax_packages(tenants, tmp_path):
    _d, inputs, _refs = tenants
    spec = {"input": inputs[1], "output": str(tmp_path / "o.bam"), "chemistry": "emseq"}
    jeng = jserve.ServeEngine(batch_families=4)
    peng = ServeEngine(device="cpu", batch_families=4)
    pj, jj = peng.submit(dict(spec)), jeng.submit(dict(spec))
    assert pj.fingerprint == jj.fingerprint
    assert pj.fingerprint["input"]["bytes"] == os.path.getsize(inputs[1])
    assert {k: v for k, v in pj.status().items() if k != "trace"} == \
        {k: v for k, v in jj.status().items() if k != "trace"}


# ---------------------------------------------------------------------------
# isolation


def test_corrupt_tenant_strict_fails_alone(tenants, tmp_path):
    _d, inputs, refs = tenants
    bad = corrupt_copy(inputs[0], str(tmp_path / "bad.bam"))
    eng = ServeEngine(device="cpu", batch_families=4, stride=2).start()
    try:
        job_bad = eng.submit({"input": bad, "output": str(tmp_path / "bad.out.bam"),
                              "policy": "strict"})
        job_good = eng.submit({"input": inputs[1], "output": str(tmp_path / "good.out.bam"),
                               "policy": "strict"})
        st_bad = eng.wait(job_bad.id, timeout=60)
        st_good = eng.wait(job_good.id, timeout=60)
        assert st_bad["state"] == "failed" and st_bad["error"]
        assert not os.path.exists(str(tmp_path / "bad.out.bam"))
        assert st_good["state"] == "done"
        assert sha(str(tmp_path / "good.out.bam")) == refs[1]
        assert eng.scheduler.alive
        assert eng.drain(timeout=30)
    finally:
        eng.stop(timeout=30)


def test_corrupt_tenant_quarantine_equals_the_jax_packages(tenants, tmp_path, monkeypatch):
    """Under quarantine the corrupt tenant completes with the JAX
    package's standalone quarantine bytes and the same counts."""
    _d, inputs, _refs = tenants
    bad = corrupt_copy(inputs[2], str(tmp_path / "bad.bam"))
    monkeypatch.setenv("BSSEQ_TPU_INPUT_POLICY", "quarantine")
    ref_q = jax_standalone(bad, str(tmp_path / "refq.bam"))
    monkeypatch.delenv("BSSEQ_TPU_INPUT_POLICY")
    eng = ServeEngine(device="cpu", batch_families=4, stride=2).start()
    try:
        job = eng.submit({"input": bad, "output": str(tmp_path / "q.out.bam"),
                          "policy": "quarantine"})
        assert eng.wait(job.id, timeout=60)["state"] == "done"
    finally:
        eng.stop(timeout=30)
    assert sha(str(tmp_path / "q.out.bam")) == ref_q
    assert job.stats.counter("records_quarantined") > 0


def test_stalled_tenant_does_not_block_neighbour(tenants, tmp_path):
    """serve_ingest stalls job j0001's reader for 4 s; j0002 must retire
    long before it wakes, and both write the JAX package's bytes."""
    _d, inputs, refs = tenants
    failpoints.arm("serve_ingest=stall:4s:times=1@job=j0001")
    eng = ServeEngine(device="cpu", batch_families=4, stride=2).start()
    try:
        t0 = time.monotonic()
        job_a = eng.submit({"input": inputs[0], "output": str(tmp_path / "a.out.bam")})
        job_b = eng.submit({"input": inputs[1], "output": str(tmp_path / "b.out.bam")})
        assert job_a.id == "j0001"
        st_b = eng.wait(job_b.id, timeout=3.5)
        waited = time.monotonic() - t0
        assert st_b["state"] == "done", (st_b, waited)
        assert waited < 3.5
        assert eng.wait(job_a.id, timeout=60)["state"] == "done"
    finally:
        eng.stop(timeout=30)
    assert sha(str(tmp_path / "a.out.bam")) == refs[0]
    assert sha(str(tmp_path / "b.out.bam")) == refs[1]


# ---------------------------------------------------------------------------
# the calling hooks under the engine


def test_jobmi_rides_the_python_encode_and_emit(tenants):
    """A GroupSource of JobMi-tagged families with FLUSH_BATCH between them:
    every emitted qname is the JobMi object (its .job readable), the flush
    cuts the chunk, an empty flush yields an empty batch, and the records
    equal the untagged run's."""
    _d, inputs, _refs = tenants
    groups = list(pcalling.stream_mi_groups(BamReader(inputs[0]), grouping="gather"))
    tagged = []
    for k, (mi, recs) in enumerate(groups):
        tag = JobMi(mi)
        tag.job = f"j{k % 2}"
        tagged.append((tag, recs))
    src = pcalling.GroupSource(
        tagged[:3] + [pcalling.FLUSH_BATCH, pcalling.FLUSH_BATCH] + tagged[3:])
    stats = pcalling.StageStats(stage="serve")
    batches = list(pcalling.call_molecular_batches(
        src, batch_families=4, grouping="gather", stats=stats, emit="python",
        batching="sequential", device="cpu"))
    plain = list(pcalling.call_molecular_batches(
        pcalling.GroupSource(groups), batch_families=4, grouping="gather", emit="python",
        batching="sequential", device="cpu"))
    assert [len(b) for b in batches][1] == 0  # the empty sync chunk
    got = [r for b in batches for r in b]
    assert got and all(hasattr(r.qname, "job") for r in got)
    assert {r.qname.job for r in got} == {"j0", "j1"}
    assert [(str(r.qname), r.seq, r.qual) for r in got] == \
        [(str(r.qname), r.seq, r.qual) for b in plain for r in b]
    assert stats.records_in == sum(len(r) for _, r in groups)


def test_prefetch_does_not_pull_past_a_sync_barrier():
    """_hp_prefetch yields the pending result and the barrier's before it
    pulls the item after a barrier (the serve source waits on them)."""
    from concurrent.futures import ThreadPoolExecutor

    pulled = []

    def items():
        for it in [(1, ["a"]), (2, []), (3, ["b"])]:
            pulled.append(it[0])
            yield it

    with ThreadPoolExecutor(2) as pool:
        gen = pcalling._hp_prefetch(items(), pool, lambda it: it[0], barrier=lambda it: not it[1])
        assert next(gen) == 1
        assert next(gen) == 2
        assert pulled == [1, 2]  # item 3 not pulled before the barrier yielded
        assert list(gen) == [3]


# ---------------------------------------------------------------------------
# the job-scoped ledger, read by the JAX package's ledger_tools


def test_job_scoped_ledger_reads_in_the_jax_ledger_tools(tenants, tmp_path, monkeypatch):
    _d, inputs, _refs = tenants
    ledger = str(tmp_path / "serve.jsonl")
    jobs_dir = str(tmp_path / "jobs")
    monkeypatch.setenv("BSSEQ_TPU_STATS", ledger)
    monkeypatch.setenv("BSSEQ_TPU_STATS_JOBS", jobs_dir)
    observe.open_ledger(component="serve-test", query_devices=False)
    eng = ServeEngine(device="cpu", batch_families=4, stride=2).start()
    try:
        jobs = [eng.submit({"input": p, "output": str(tmp_path / f"o{k}.bam")})
                for k, p in enumerate(inputs[:2])]
        for job in jobs:
            assert eng.wait(job.id, timeout=60)["state"] == "done"
    finally:
        eng.stop(timeout=30)
    observe.flush_sinks()
    ids = [j.id for j in jobs]
    s = ledger_tools.summarize_ledger(ledger)
    assert set(ids) <= set(s.jobs)
    assert not s.problems, s.problems
    assert "serve" in s.stages
    for jid, job in zip(ids, jobs):
        s0 = ledger_tools.summarize_ledger(ledger, job=jid)
        assert s0.job == jid and not s0.problems
        line = s0.stages["molecular"]
        assert (line["families"], line["consensus_out"]) == (job.families, job.consensus_out)
        assert {"job_admitted", "job_complete", "stage_stats", "span"} <= set(s0.events)
        sub = ledger_tools.summarize_ledger(os.path.join(jobs_dir, f"{jid}.jsonl"), job=jid)
        assert sub.events == s0.events
    assert not ledger_tools.summarize_ledger(ledger, job="j9999").ok
    with open(ledger) as fh:
        events = [json.loads(ln)["event"] for ln in fh]
    assert events[0] == "run_manifest"
    observe.close_sinks()


def test_warmup_books_the_warm_calls_cache_counts(monkeypatch, tmp_path):
    """warmup() runs one engine call on two synthetic families (four strand
    families: two templates each, so the device vote runs) and books the
    kernel loads' compile-cache outcomes into the engine's counters."""
    from bsseqconsensusreads_tpu_torch.io import _nativelib
    from bsseqconsensusreads_tpu_torch.utils import compilecache

    monkeypatch.setenv(compilecache.ENV_DIR, str(tmp_path / "cache"))
    monkeypatch.setattr(compilecache, "_STATE", {"enabled": False, "hits": 0, "misses": 0,
                                                 "published_hits": 0, "published_misses": 0})
    monkeypatch.setattr(pcalling, "_warm_device",
                        lambda *a, **k: _nativelib.build("wirepack"))
    sink = str(tmp_path / "l.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    eng = ServeEngine(device="cpu")
    eng.warmup()
    eng.warmup()
    counters = eng.scheduler.counters()
    assert (counters["compile_cache_miss"], counters["compile_cache_hit"]) == (1, 1)
    observe.flush_sinks()
    with open(sink) as fh:
        warm = [json.loads(ln) for ln in fh if '"serve_warmup"' in ln]
    assert [(w["families"], w["batches"]) for w in warm] == [(4, 1), (4, 1)]
    observe.close_sinks()


@pytest.mark.parametrize("batching", ["sequential", "bucketed"])
def test_group_source_flushes_equal_the_jax_packages(tenants, batching):
    """A GroupSource with FLUSH_BATCH between families (two in a row: the
    second an empty sync chunk under sequential batching), through both
    packages' call_molecular_batches: the same batches, record for record."""
    from bsseqconsensusreads_tpu.io import bam as jbam
    from bsseqconsensusreads_tpu.pipeline import calling as jcalling
    from bsseqconsensusreads_tpu_torch.io import bam as pbam

    _d, inputs, _refs = tenants
    out = {}
    for name, lib, io in (("port", pcalling, pbam), ("jax", jcalling, jbam)):
        groups = list(lib.stream_mi_groups(io.BamReader(inputs[1]), grouping="gather"))
        src = lib.GroupSource(groups[:5] + [lib.FLUSH_BATCH, lib.FLUSH_BATCH] + groups[5:11]
                              + [lib.FLUSH_BATCH] + groups[11:])
        kw = {"device": "cpu"} if name == "port" else {}
        batches = lib.call_molecular_batches(src, batch_families=4, grouping="gather",
                                             emit="python", batching=batching, **kw)
        out[name] = [[io.encode_record(r) for r in b] for b in batches]
    assert out["port"] == out["jax"]
    if batching == "sequential":
        assert [] in out["port"]  # the sync chunk
