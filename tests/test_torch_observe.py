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
  directory takes the builds);
* the phase summary: Metrics' nested, thread-aware spans (owner seconds,
  span tree) and phase_summary, and StageStats.as_dict (the JAX
  package's keys in its order, host_s / device_s / stall_s / chip_busy /
  unattributed_s / effective_flop_utilization) equal the JAX package's
  for the same phases and wall, on a deterministic clock;
* the events: `run` on one fixture that spills its sort into a merge
  pass, retries an armed batch, asks for a blocked stream_interstage,
  runs the bucket engine, spills methyl tallies, resumes a bucket
  manifest, quarantines a corrupt shard and refuses a changed input
  writes the same multiset of event kinds, each with the same field
  names, as the JAX package (the 12 kinds the port once lacked among
  them);
* maybe_trace: a torch.profiler Chrome trace per stage under
  BSSEQ_TPU_TRACE, nothing without it.

The port's ledgers are read with the port's utils.ledger_tools; one
check also holds them against the JAX package's.

Tolerance: equality of names, keys, counts and (on the deterministic
clock) seconds; wall seconds and timestamps of real runs are measured,
not compared.
"""

import collections
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
from bsseqconsensusreads_tpu.pipeline import calling as jcalling
from bsseqconsensusreads_tpu.utils import ledger_tools as jledger_tools
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
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling
from bsseqconsensusreads_tpu_torch.utils import compilecache, ledger_tools, observe
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


def _compile_spans(lines):
    """The first-dispatch 'compile' spans: (stage, batch shape) each, sorted.
    With host workers two batches dispatch at once and each span is written
    when its dispatch ends, so the ledger's order of them is the threads'
    (in both packages); every span is still compared."""
    return sorted(((d["stage"], d["shape"]) for d in lines
                   if d["event"] == "span" and d["name"] == "compile"), key=repr)


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
    assert [d["event"] for d in port if d["event"] not in POOL_EVENTS + ("span",)] == \
        ["run_manifest"] + ["rule_complete"] * 2 + ["stage_stats"] * 2 + ["pipeline_complete"]
    assert _compile_spans(port) == _compile_spans(jax) != []
    assert port[0]["config_digest"] == observe.config_digest(pconfig.FrameworkConfig(**kw))
    assert port[0]["backend"] in ("cpu", "cuda")
    path = str(tmp / "port_run.jsonl")
    assert ledger_tools.check_ledger(path) == [] == jledger_tools.check_ledger(path)
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
    assert [d["event"] for d in port if d["event"] not in POOL_EVENTS + ("span",)] == \
        ["run_manifest", "stage_stats"]
    assert _compile_spans(port) == _compile_spans(jax) != []
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
    path = _nativelib.build_library("wirepack")
    assert path.parent == cache
    assert compilecache.counts() == (0, 1)
    _nativelib.build_library("wirepack")
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


# ---------------------------------------------------------------------------
# the phase summary


class _Clock:
    """A deterministic clock: each call advances by the next step."""

    def __init__(self, steps):
        self._steps = iter(steps)
        self.t = 100.0

    def __call__(self):
        self.t += next(self._steps)
        return self.t


def _drive(lib_metrics, clock):
    """Nested phases on the owner thread, a worker thread's phases, and
    outside seconds (a whole phase and dotted parts of one)."""
    m = lib_metrics(clock=clock)
    with m.timed("ingest"):
        with m.timed("encode"):
            pass
        with m.timed("emit"):
            with m.timed("emit.pack"):
                pass
    with m.timed("kernel"):
        pass

    def worker():
        with m.timed("device_wait"):
            with m.timed("fetch"):
                pass
        with m.timed("stall"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    m.add_seconds("sort_write", 0.25)
    (m.add_sub_seconds if hasattr(m, "add_sub_seconds") else m.add_seconds)(
        "sort_write.merge", 0.125)
    m.count("records_seen", 7)
    return m


STEPS = [0.5, 0.25, 0.125, 1.0, 0.0625, 0.5, 2.0, 1.5, 0.75, 0.25, 0.5, 0.375, 0.125, 0.0625,
         0.03125, 0.25, 0.5, 1.0, 0.75]


def test_phase_summary_of_nested_multithread_spans_equals_the_jax_packages():
    p = _drive(observe.Metrics, _Clock(STEPS))
    j = _drive(jobserve.Metrics, _Clock(STEPS))
    assert p.seconds == j.seconds and p.spans == j.spans
    assert p.owner_seconds == j.owner_seconds
    assert set(p.owner_seconds) == {"ingest", "kernel", "sort_write"}  # worker, nested, dotted out
    assert p.span_tree() == j.span_tree()
    assert p.span_tree()["ingest"]["children"]["emit"]["children"]["emit.pack"]["calls"] == 1
    for wall in (0.0, 3.0, 30.0):
        assert p.phase_summary(wall) == j.phase_summary(wall)
    summary = p.phase_summary(30.0)
    assert summary["device_s"] == round(p.seconds["kernel"] + p.seconds["device_wait"]
                                        + p.seconds["fetch"], 3)
    assert summary["stall_s"] == round(p.seconds["stall"], 3)
    assert p.as_dict() == j.as_dict() and p.rate("records_seen", "kernel") > 0
    with pytest.raises(ValueError, match="dotted"):
        p.add_sub_seconds("sort_write", 1.0)


@pytest.mark.parametrize("cells", [(0, 0), (30, 90), (64, 0)])
def test_stage_stats_as_dict_equals_the_jax_packages(cells):
    """The same counts, phases and wall through both packages' StageStats:
    the same keys in the same order and the same values — the phase
    summary included, last."""
    out = []
    for calling, lib in ((pcalling, observe), (jcalling, jobserve)):
        st = calling.StageStats(stage="molecular", metrics=_drive(lib.Metrics, _Clock(STEPS)))
        st.records_in, st.families, st.consensus_out, st.batches = 40, 20, 20, 3
        st.pad_cells, st.used_cells = cells
        st.wall_seconds = 12.5
        st.metrics.count("batches_retried")
        out.append(list(st.as_dict().items()))
    assert out[0] == out[1]
    keys = [k for k, _v in out[0]]
    assert keys[-5:] == ["host_s", "device_s", "stall_s", "chip_busy", "unattributed_s"]
    assert "effective_flop_utilization" in keys and "device_s" in keys


# ---------------------------------------------------------------------------
# the events of one fixture, both packages


#: (outdir key, FrameworkConfig fields, failpoint schedule or a step)
EVENT_SCENARIOS = [
    ("spill", dict(sort_buffer_records=1, sort_engine="native", emit="python",
                   stream_interstage=True), "dispatch_kernel=raise:RuntimeError:times=1"),
    ("bucket", dict(sort_buffer_records=4, sort_engine="bucket"), ""),
    ("ckpt", dict(sort_engine="bucket", checkpoint_every=1, methyl="both"),
     "bucket_finalize=raise:ValueError:times=1"),
    ("ckpt", dict(sort_engine="bucket", checkpoint_every=1, methyl="both"), ""),
    ("input", dict(checkpoint_every=1), "ckpt_finalize=raise:ValueError:times=1"),
    ("input", dict(checkpoint_every=1), "TOUCH"),
    ("corrupt", dict(checkpoint_every=1), "ckpt_finalize=raise:ValueError:times=1"),
    ("corrupt", dict(checkpoint_every=1), "CORRUPT"),
]

#: the kinds the port's ledger lacked before the phase summary repair
ONCE_MISSING = {"batch_retry", "batch_recovered", "spill", "merge_pass",
                "checkpoint_input_changed", "interstage_fallback", "integrity_mismatch",
                "methyl_spill", "methyl_finalize", "bucket_plan", "bucket_spill",
                "bucket_manifest_resumed"}


def _scenario_ledger(tmp, name, stages_mod, cfg_mod, fp_mod, fasta, src, monkeypatch):
    import glob
    import shutil

    d = tmp / name
    sink = str(tmp / f"{name}.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    outcomes = []
    for key, kw, step in EVENT_SCENARIOS:
        bam = str(d / f"in_{key}.bam")
        if not os.path.exists(bam):
            os.makedirs(d, exist_ok=True)
            shutil.copy(src, bam)
        fp_mod.disarm()
        if step == "TOUCH":
            st = os.stat(bam)
            os.utime(bam, (st.st_atime, st.st_mtime + 100))
        elif step == "CORRUPT":
            part = sorted(glob.glob(str(d / f"out_{key}" / "*.part*.bam")))[0]
            with open(part, "r+b") as fh:
                fh.seek(30)
                fh.write(b"\xff\xff\xff")
        elif step:
            fp_mod.arm(step)
        cfg = cfg_mod.FrameworkConfig(genome_dir=os.path.dirname(fasta),
                                      genome_fasta_file_name=os.path.basename(fasta),
                                      backend="cpu", batch_families=8, **kw)
        try:
            stages_mod.run_pipeline(cfg, bam, outdir=str(d / f"out_{key}"))
            outcomes.append("ok")
        except Exception as exc:  # the armed crashes and the refused input
            outcomes.append(type(exc).__name__)
    fp_mod.disarm()
    observe.close_sinks()
    jobserve.close_sinks()
    monkeypatch.delenv("BSSEQ_TPU_STATS")
    return outcomes, _lines(sink)


def _kinds(lines):
    """(event, field names) per line, timings and thread names aside; a
    stage_stats line keeps the StageStats fields (its metric counters and
    phase seconds are each package's own)."""
    fixed = set(jcalling.StageStats().as_dict()) | {"stage", "sample", "event", "job"}
    out = collections.Counter()
    for d in lines:
        keys = set(d) - {"ts", "thread"}
        if d["event"] == "stage_stats":
            keys &= fixed
        out[(d["event"], tuple(sorted(keys)))] += 1
    return out


def test_run_events_and_their_fields_equal_the_jax_packages(tmp_path, monkeypatch):
    from bsseqconsensusreads_tpu.faults import failpoints as jfailpoints

    monkeypatch.setenv("BSSEQ_TPU_HOST_WORKERS", "0")
    monkeypatch.setenv("BSSEQ_TPU_RETRY_BACKOFF_S", "0")
    rng = np.random.default_rng(31)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp_path / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=40,
                                               error_rate=0.01)
    src = str(tmp_path / "src.bam")
    with jbam.BamWriter(src, header) as w:
        w.write_all(records)
    p_out, port = _scenario_ledger(tmp_path, "port", pstages, pconfig, failpoints, fasta, src,
                                   monkeypatch)
    j_out, jax = _scenario_ledger(tmp_path, "jax", jstages, jconfig, jfailpoints, fasta, src,
                                  monkeypatch)
    assert p_out == j_out == ["ok", "ok", "ValueError", "ok", "ValueError",
                              "InputChangedError", "ValueError", "ok"]
    assert _kinds(port) == _kinds(jax)
    assert ONCE_MISSING <= {d["event"] for d in port}
    assert [(d["stage"], d["shape"]) for d in port if d.get("name") == "compile"] == \
        [(d["stage"], d["shape"]) for d in jax if d.get("name") == "compile"]
    stage_lines = [d for d in port if d["event"] == "stage_stats"]
    assert stage_lines and all("chip_busy" in d and "unattributed_s" in d for d in stage_lines)


# ---------------------------------------------------------------------------
# maybe_trace


def test_stages_write_a_torch_profiler_trace_only_under_bsseq_tpu_trace(run_env, monkeypatch,
                                                                          capsys):
    tmp, fasta, bam = run_env
    trace = tmp / "traces"
    monkeypatch.delenv("BSSEQ_TPU_TRACE", raising=False)
    argv = ["run", "--bam", bam, "--reference", fasta, "--device", "cpu", "--force"]
    assert cli.main(argv + ["--outdir", str(tmp / "untraced")]) == 0
    assert not trace.exists()
    monkeypatch.setenv("BSSEQ_TPU_TRACE", str(trace))
    assert cli.main(argv + ["--outdir", str(tmp / "traced")]) == 0
    capsys.readouterr()
    assert sorted(os.listdir(trace)) == ["duplex", "molecular"]
    for stage in ("duplex", "molecular"):
        (name,) = os.listdir(trace / stage)
        with open(trace / stage / name) as fh:
            doc = json.load(fh)
        assert doc["traceEvents"]
