"""The port's run ledger (utils/observe.py) and kernel build cache
(utils/compilecache.py) on the CPU, held against the JAX package's
(tests/test_observe.py, tests/test_serve.py's ledger and compile-cache
legs):

* the writer: concurrent emits interleave whole lines, lines survive with
  no flush, the manifest opens a ledger once, no sink writes nothing, the
  digest is the file's SHA-256, config_digest equals the JAX package's;
* sub-sinks, trace contexts, spans and the flight ring: the JAX package's
  line shapes (its ledger_tools read them);
* `run` and `molecular` on the same input in both packages with
  BSSEQ_TPU_STATS set: the same event names in the same order, the same
  rule_complete / pipeline_complete fields and values (seconds and paths
  aside), the stage_stats lines' counts equal; the port's ledgers pass the
  JAX package's ledger_tools.check_ledger (schema and closure) and
  summarize with the same stages and rules;
* the failpoint lines (`failpoint_fired`) and the compile cache's
  hit/miss accounting (a found build a hit, a build a miss; the cache
  directory takes the builds).

Tolerance: equality of names, keys and counts; wall seconds and
timestamps are measured, not compared.
"""

import hashlib
import json
import os
import threading

import numpy as np
import pytest

from bsseqconsensusreads_tpu import cli as jcli
from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.utils import ledger_tools
from bsseqconsensusreads_tpu.utils import observe as jobserve
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.faults import failpoints
from bsseqconsensusreads_tpu_torch.io import _nativelib
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.utils import compilecache, observe
from test_torch_serve import _reference_natives  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_sinks(monkeypatch):
    for var in ("BSSEQ_TPU_STATS", "BSSEQ_TPU_STATS_JOBS", "BSSEQ_TPU_STATS_REPLICAS",
                "BSSEQ_TPU_STATS_WORKERS", "BSSEQ_TPU_REPLICA_ID", "BSSEQ_TPU_WORKER_ID"):
        monkeypatch.delenv(var, raising=False)
    observe.close_sinks()
    jobserve.close_sinks()
    yield
    observe.close_sinks()
    jobserve.close_sinks()
    failpoints.disarm()


def _lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


# ---------------------------------------------------------------------------
# the writer


def test_concurrent_emits_interleave_whole_lines(tmp_path, monkeypatch):
    sink = str(tmp_path / "l.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)

    def burst(k):
        for i in range(200):
            observe.emit("tick", {"k": k, "i": i, "pad": "x" * 64})

    threads = [threading.Thread(target=burst, args=(k,), name=f"w{k}") for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lines = _lines(sink)
    assert len(lines) == 1200
    assert {(d["k"], d["i"]) for d in lines} == {(k, i) for k in range(6) for i in range(200)}
    assert all(d["thread"].startswith("w") for d in lines)


def test_manifest_once_digest_and_silence(tmp_path, monkeypatch):
    assert observe.open_ledger() is False  # no sink: nothing, no error
    observe.emit("tick", {})
    sink = str(tmp_path / "l.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    assert observe.open_ledger(component="t", query_devices=False)
    assert observe.open_ledger(component="t", query_devices=False)
    observe.emit("tick", {"n": 1})
    lines = _lines(sink)  # written without an explicit flush
    assert [d["event"] for d in lines] == ["run_manifest", "tick"]
    manifest = lines[0]
    assert set(jobserve.run_manifest("", "t", query_devices=False)) == set(manifest) - {
        "ts", "event"}
    with open(sink, "rb") as fh:
        assert observe.ledger_digest(sink) == hashlib.sha256(fh.read()).hexdigest()
    assert not ledger_tools.check_ledger(sink)


@pytest.mark.parametrize("obj", [{"a": 1, "b": [2, 3]}, "text", (1, 2.5), None])
def test_config_digest_equals_the_jax_packages(obj):
    assert observe.config_digest(obj) == jobserve.config_digest(obj)


def test_config_digest_of_the_default_configs_is_stable():
    a = observe.config_digest(pconfig.FrameworkConfig())
    assert a == observe.config_digest(pconfig.FrameworkConfig()) and len(a) == 12
    assert a != observe.config_digest(pconfig.FrameworkConfig(aligner="none"))


def test_sub_sinks_traces_and_spans_match_the_jax_shapes(tmp_path, monkeypatch):
    """The same calls through both packages write the same events with the
    same keys (ids, times and the process id aside)."""
    out = {}
    for name, lib in (("port", observe), ("jax", jobserve)):
        d = tmp_path / name
        monkeypatch.setenv("BSSEQ_TPU_STATS", str(d / "main.jsonl"))
        monkeypatch.setenv("BSSEQ_TPU_STATS_JOBS", str(d / "jobs"))
        monkeypatch.setenv("BSSEQ_TPU_STATS_REPLICAS", str(d / "replicas"))
        monkeypatch.setenv("BSSEQ_TPU_REPLICA_ID", "r1")
        os.makedirs(d, exist_ok=True)
        monkeypatch.setattr(lib, "_PROC_TRACE", None)  # minted (and its root emitted) anew
        ctx = lib.mint_trace("job", "j0001", job="j0001")
        with lib.bind_trace(ctx):
            assert lib.current_trace() == ctx
            lib.emit("job_admitted", {"input": "i", "output": "o", "fingerprint": {}},
                     job="j0001")
            with lib.span("ingest", job="j0001", n=3):
                lib.emit("tick", {})
        lib.emit_span("chunk_retire", 1.0, 2.0, ctx=lib.proc_trace(), batch=0, jobs=["j0001"])
        assert lib.flight_dump("test") >= 4
        lib.flush_sinks()
        out[name] = [_lines(d / "main.jsonl"), _lines(d / "jobs" / "j0001.jsonl"),
                     _lines(d / "replicas" / "r1.jsonl")]
    for port_lines, jax_lines in zip(out["port"], out["jax"]):
        assert [(d["event"], sorted(d)) for d in port_lines] == \
            [(d["event"], sorted(d)) for d in jax_lines]
    spans = [d for d in out["port"][0] if d["event"] == "span"]
    assert {s["trace"].split("-")[0] for s in spans} == {"job", "proc"}
    child = next(s for s in spans if s["name"] == "ingest")
    assert child["parent"] == spans[0]["span"] and child["n"] == 3
    assert ledger_tools.summarize_ledger(str(tmp_path / "port" / "main.jsonl"),
                                         replica="r1").ok


# ---------------------------------------------------------------------------
# the run ledger of the commands, both packages on the same input


@pytest.fixture(scope="module")
def run_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_observe")
    rng = np.random.default_rng(31)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=12,
                                               error_rate=0.01)
    bam = str(tmp / "input" / "sampleX.bam")
    os.makedirs(os.path.dirname(bam), exist_ok=True)
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    return tmp, fasta, bam


def _ledgered(monkeypatch, sink, fn):
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    fn()
    observe.close_sinks()
    jobserve.close_sinks()
    monkeypatch.delenv("BSSEQ_TPU_STATS")
    return _lines(sink)


COUNT_FIELDS = ("stage", "records_in", "records_seen", "records_quarantined", "families",
                "consensus_out", "skipped_families", "leftover_records",
                "refragmented_families", "batches", "indel_aligned", "indel_dropped",
                "batches_retried", "batches_degraded", "sample")


#: the pool decisions: each stage ledgers one per pool, in its own order
POOL_EVENTS = ("overlap_pool_disabled", "overlap_pool_enabled", "overlap_pool_composed",
               "host_pool_enabled", "host_pool_disabled")


def _contract(lines):
    """The ledger without the JAX package's XLA compile spans (the port
    compiles no XLA programs), each run of pool decisions in a fixed
    order."""
    out, run = [], []
    for d in lines:
        if d["event"] == "span":
            continue
        if d["event"] in POOL_EVENTS:
            run.append(d)
            continue
        out += sorted(run, key=lambda e: (e["event"], e["stage"]))
        run = []
        out.append(d)
    return out + sorted(run, key=lambda e: (e["event"], e["stage"]))


def _compare_ledgers(port, jax):
    port, jax = _contract(port), _contract(jax)
    assert [d["event"] for d in port] == [d["event"] for d in jax]
    for p, j in zip(port, jax):
        if p["event"] in POOL_EVENTS:
            assert sorted(p) == sorted(j) and p["stage"] == j["stage"]
        ev = p["event"]
        if ev == "rule_complete":
            assert sorted(p) == sorted(j)
            assert (p["rule"], p["ran"], p["reason"].replace("port_run", "run")) == \
                (j["rule"], j["ran"], j["reason"].replace("jax_run", "run"))
        elif ev == "pipeline_complete":
            assert sorted(p) == sorted(j)
            assert (p["rules"], p["sample"], os.path.basename(p["target"])) == \
                (j["rules"], j["sample"], os.path.basename(j["target"]))
        elif ev == "stage_stats":
            assert {k: p.get(k) for k in COUNT_FIELDS} == {k: j.get(k) for k in COUNT_FIELDS}
        elif ev == "run_manifest":
            assert set(j) - {"ts", "event"} <= set(p)
            assert (p["component"], p.get("sample")) == (j["component"], j.get("sample"))


def test_run_ledger_equals_the_jax_packages(run_env, monkeypatch):
    tmp, fasta, bam = run_env
    kw = dict(genome_dir=os.path.dirname(fasta), genome_fasta_file_name=os.path.basename(fasta),
              backend="cpu")
    port = _ledgered(monkeypatch, str(tmp / "port_run.jsonl"), lambda: pstages.run_pipeline(
        pconfig.FrameworkConfig(**kw), bam, outdir=str(tmp / "port_run")))
    jax = _ledgered(monkeypatch, str(tmp / "jax_run.jsonl"), lambda: jstages.run_pipeline(
        jconfig.FrameworkConfig(**kw), bam, outdir=str(tmp / "jax_run")))
    _compare_ledgers(port, jax)
    assert [d["event"] for d in port if d["event"] not in POOL_EVENTS] == \
        ["run_manifest"] + ["rule_complete"] * 2 + ["stage_stats"] * 2 + ["pipeline_complete"]
    assert port[0]["config_digest"] == observe.config_digest(pconfig.FrameworkConfig(**kw))
    assert port[0]["backend"] in ("cpu", "cuda")
    path = str(tmp / "port_run.jsonl")
    assert ledger_tools.check_ledger(path) == []
    ps = ledger_tools.summarize_ledger(path)
    js = ledger_tools.summarize_ledger(str(tmp / "jax_run.jsonl"))
    assert sorted(ps.stages) == sorted(js.stages) == ["duplex", "molecular"]
    assert [r["rule"] for r in ps.rules] == [r["rule"] for r in js.rules]
    assert "scoped" not in ledger_tools.format_summary(ps)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_molecular_cli_ledger_equals_the_jax_packages(run_env, monkeypatch, capsys, engine):
    tmp, _fasta, bam = run_env
    argv = ["molecular", "-i", bam, "--batching", "sequential", "--ingest", engine,
            "--emit", engine]
    port = _ledgered(monkeypatch, str(tmp / f"port_mol_{engine}.jsonl"), lambda: cli.main(
        argv + ["-o", str(tmp / f"pm_{engine}.bam"), "--device", "cpu"]))
    jax = _ledgered(monkeypatch, str(tmp / f"jax_mol_{engine}.jsonl"), lambda: jcli.main(
        argv + ["-o", str(tmp / f"jm_{engine}.bam")]))
    capsys.readouterr()
    _compare_ledgers(port, jax)
    assert [d["event"] for d in port if d["event"] not in POOL_EVENTS] == \
        ["run_manifest", "stage_stats"]
    assert port[0]["component"] == "molecular-cli"
    assert ledger_tools.check_ledger(str(tmp / f"port_mol_{engine}.jsonl")) == []


def test_failpoint_fires_are_ledgered_as_the_jax_packages(tmp_path, monkeypatch):
    sink = str(tmp_path / "l.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    failpoints.arm("serve_retire=stall:0.01s:times=1")
    failpoints.fire("serve_retire", stage="serve", batch=3)
    failpoints.fire("serve_retire", stage="serve", batch=4)
    assert failpoints.fired_total() == 1
    (line,) = _lines(sink)
    assert {k: line[k] for k in ("event", "site", "action", "stage", "batch")} == {
        "event": "failpoint_fired", "site": "serve_retire", "action": "stall",
        "stage": "serve", "batch": 3}
    assert set(ledger_tools.EVENT_SCHEMA["failpoint_fired"]) <= set(line)


# ---------------------------------------------------------------------------
# the kernel build cache


def test_compile_cache_counts_hits_and_misses(tmp_path, monkeypatch):
    """With BSSEQ_TPU_COMPILE_CACHE_DIR set the host libraries build into
    it (a miss), a later build step finds them (a hit), and publish books
    the delta once."""
    from bsseqconsensusreads_tpu_torch.pipeline.calling import StageStats

    cache = tmp_path / "cache"
    monkeypatch.setenv(compilecache.ENV_DIR, str(cache))
    monkeypatch.setattr(compilecache, "_STATE", {"enabled": False, "hits": 0, "misses": 0,
                                                 "published_hits": 0, "published_misses": 0})
    assert compilecache.maybe_enable() == str(cache) and compilecache.enabled()
    assert compilecache.build_dir(tmp_path / "default") == cache
    path = _nativelib.build("wirepack")
    assert path.parent == cache
    assert compilecache.counts() == (0, 1)
    _nativelib.build("wirepack")
    assert compilecache.counts() == (1, 1)
    stats = StageStats(stage="molecular")
    compilecache.publish(stats.metrics)
    compilecache.publish(stats.metrics)
    assert (stats.counter("compile_cache_hit"), stats.counter("compile_cache_miss")) == (1, 1)
    monkeypatch.delenv(compilecache.ENV_DIR)
    assert compilecache.build_dir(tmp_path / "default") == tmp_path / "default"


def test_compile_cache_is_silent_when_unset(monkeypatch):
    monkeypatch.delenv(compilecache.ENV_DIR, raising=False)
    monkeypatch.setattr(compilecache, "_STATE", {"enabled": False, "hits": 0, "misses": 0,
                                                 "published_hits": 0, "published_misses": 0})
    assert compilecache.maybe_enable() is None
    compilecache.record(hit=True)
    assert compilecache.counts() == (0, 0)
    m = observe.Metrics()
    compilecache.publish(m)
    assert m.counters == {}
