"""The port's ledger and trace tools (utils/ledger_tools.py,
utils/trace_tools.py) and its `observe` subcommand on the CPU, held
against the JAX package's (tests/test_observe.py, tests/test_trace.py):

* the same ledgers — a `run` ledger of each package, an elastic run's
  ledger and its rundir, a fleet of traced processes written by hand, a
  truncated and a corrupted ledger — through both packages' parse,
  summarize (whole and scoped to a job, replica or worker), diff, check,
  assemble, check_traces, format_report and trace_summary give the same
  values and the same strings;
* `python -m bsseqconsensusreads_tpu_torch observe summarize|diff|check|
  trace` prints what the JAX CLI prints, on stdout and stderr, with the
  same exit codes (0 ok, 1 a failed check, 2 an unreadable ledger);
* `observe top` against a dead address exits 1, as the JAX CLI.

Tolerance: equality of strings and exit codes.
"""

import json
import os

import numpy as np
import pytest

from bsseqconsensusreads_tpu import cli as jcli
from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.utils import ledger_tools as jlt
from bsseqconsensusreads_tpu.utils import observe as jobserve
from bsseqconsensusreads_tpu.utils import trace_tools as jtt
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch import elastic as pelastic
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.utils import ledger_tools as plt
from bsseqconsensusreads_tpu_torch.utils import observe
from bsseqconsensusreads_tpu_torch.utils import trace_tools as ptt
from test_torch_serve import _reference_natives  # noqa: F401


@pytest.fixture(autouse=True)
def _no_sinks(monkeypatch):
    for var in ("BSSEQ_TPU_STATS", "BSSEQ_TPU_WORKER_ID", "BSSEQ_TPU_REPLICA_ID"):
        monkeypatch.delenv(var, raising=False)
    observe.close_sinks()
    jobserve.close_sinks()
    yield
    observe.close_sinks()
    jobserve.close_sinks()


def _write(path, lines):
    with open(path, "w") as fh:
        for d in lines:
            fh.write((d if isinstance(d, str) else json.dumps(d)) + "\n")
    return str(path)


def _span(name, trace, sid, parent=None, t0=0.0, t1=1.0, **kw):
    return {"ts": t1, "event": "span", "name": name, "trace": trace, "span": sid,
            "parent": parent, "t0": t0, "t1": t1, "dur_s": t1 - t0, **kw}


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """Ledgers of every shape the tools read, written once."""
    tmp = tmp_path_factory.mktemp("ledger_tools")
    rng = np.random.default_rng(41)
    name, genome = random_genome(rng, 5000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=8,
                                               error_rate=0.01)
    bam = str(tmp / "input" / "lt.bam")
    os.makedirs(os.path.dirname(bam))
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    kw = dict(genome_dir=os.path.dirname(fasta), genome_fasta_file_name=os.path.basename(fasta),
              backend="cpu")
    out = {}
    saved = os.environ.get("BSSEQ_TPU_STATS")
    try:
        for key, fn in (
            ("port_run", lambda: pstages.run_pipeline(pconfig.FrameworkConfig(**kw), bam,
                                                      outdir=str(tmp / "p"))),
            ("jax_run", lambda: jstages.run_pipeline(jconfig.FrameworkConfig(**kw), bam,
                                                     outdir=str(tmp / "j"))),
            ("elastic/ledger", lambda: pelastic.run_elastic(
                pconfig.FrameworkConfig(**kw), bam, str(tmp / "e"), inline=True, slices=3)),
        ):
            path = str(tmp / f"{key}.jsonl")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            os.environ["BSSEQ_TPU_STATS"] = path
            # each ledger is its own process's: its proc trace root in it
            observe.reset_proc_trace()
            jobserve._PROC_TRACE = None
            fn()
            observe.close_sinks()
            jobserve.close_sinks()
            out[key] = path
    finally:
        if saved is None:
            os.environ.pop("BSSEQ_TPU_STATS", None)
        else:
            os.environ["BSSEQ_TPU_STATS"] = saved
    with open(out["port_run"]) as fh:
        lines = fh.read().splitlines()
    out["truncated"] = _write(tmp / "truncated.jsonl", lines[1:])  # no manifest
    out["corrupt"] = _write(tmp / "corrupt.jsonl", lines[:2] + ["{not json", '{"ts": 1}'])
    out["unclosed"] = _write(tmp / "unclosed.jsonl", [
        json.loads(lines[0]),
        {"ts": 2.0, "event": "rule_complete", "rule": "a", "seconds": 1.0, "ran": True},
        {"ts": 3.0, "event": "pipeline_complete", "pipeline_s": 9.0},
    ])
    # a traced fleet by hand: a job trace across a router and a replica,
    # a requeued slice trace that terminates, an orphan and an open job
    fleet = tmp / "fleet"
    os.makedirs(fleet)
    _write(fleet / "router.jsonl", [
        _span("job_admit", "job-j1-aa", "1.1", t0=0.0, t1=0.0),
        {"ts": 0.1, "event": "job_admitted", "trace": "job-j1-aa", "span": "1.1", "job": "j1",
         "input": "i", "output": "o", "fingerprint": {}},
        _span("route", "job-j1-aa", "1.2", "1.1", 0.1, 0.3),
        _span("worker_spawn", "proc-pid1-bb", "1.9", None, 0.0, 2.5),
    ])
    _write(fleet / "r0.jsonl", [
        _span("ingest", "job-j1-aa", "2.1", "1.2", 0.3, 1.3, replica="r0"),
        _span("compile", "proc-pid2-cc", "2.5", None, 0.2, 0.9),
        {"ts": 1.5, "event": "job_complete", "trace": "job-j1-aa", "span": "2.1", "job": "j1"},
        _span("slice_admit", "slice-s0000-dd", "2.7", t0=0.0, t1=0.0),
        {"ts": 1.6, "event": "slice_requeued", "trace": "slice-s0000-dd", "span": "2.7",
         "slice": "s0000", "worker": "w0", "reason": "lease_expired", "batches_kept": 1},
        {"ts": 1.9, "event": "elastic_slice_done", "trace": "slice-s0000-dd", "span": "2.7",
         "slice": "s0000", "worker": "w1", "records": 4},
        _span("lost", "job-j9-ee", "2.9", "7.7", 1.0, 2.0),
        _span("job_admit", "job-j2-ff", "3.1", t0=0.0, t1=0.0),
    ])
    out["fleet"] = str(fleet)
    out["fleet_files"] = [str(fleet / "router.jsonl"), str(fleet / "r0.jsonl")]
    out["elastic_dir"] = os.path.dirname(out["elastic/ledger"])
    return out


LEDGER_KEYS = ["port_run", "jax_run", "elastic/ledger", "truncated", "corrupt", "unclosed"]


@pytest.mark.parametrize("key", LEDGER_KEYS)
def test_parse_summarize_check_equal_the_jax_tools(ledgers, key):
    path = ledgers[key]
    assert plt.parse_ledger(path) == jlt.parse_ledger(path)
    p, j = plt.summarize_ledger(path), jlt.summarize_ledger(path)
    assert plt.format_summary(p) == jlt.format_summary(j)
    assert (p.ok, p.problems, p.stages, p.rules, p.events) == \
        (j.ok, j.problems, j.stages, j.rules, j.events)
    assert plt.check_ledger(path) == jlt.check_ledger(path)
    assert plt.check_ledger(path, rel_tol=0.01) == jlt.check_ledger(path, rel_tol=0.01)


def test_the_port_ledgers_pass_and_the_broken_ones_fail(ledgers):
    assert plt.check_ledger(ledgers["port_run"]) == []
    for key in ("truncated", "corrupt", "unclosed"):
        assert plt.check_ledger(ledgers[key]), key
    stage = plt.summarize_ledger(ledgers["port_run"]).stages["molecular"]
    assert {"host_s", "device_s", "stall_s", "chip_busy", "unattributed_s"} <= set(stage)


@pytest.mark.parametrize("scope", [{"worker": "inline"}, {"worker": "w9"}, {"job": "j1"},
                                   {"replica": "r0"}])
def test_scoped_summaries_equal_the_jax_tools(ledgers, scope):
    for key in ("elastic/ledger", "port_run"):
        p = plt.summarize_ledger(ledgers[key], **scope)
        j = jlt.summarize_ledger(ledgers[key], **scope)
        assert plt.format_summary(p) == jlt.format_summary(j)
        assert (p.ok, p.problems) == (j.ok, j.problems)


@pytest.mark.parametrize("pair", [("port_run", "jax_run"), ("jax_run", "port_run"),
                                  ("port_run", "elastic/ledger")])
def test_diff_equals_the_jax_tools(ledgers, pair):
    a, b = (ledgers[k] for k in pair)
    assert plt.format_diff(plt.summarize_ledger(a), plt.summarize_ledger(b)) == \
        jlt.format_diff(jlt.summarize_ledger(a), jlt.summarize_ledger(b))


@pytest.mark.parametrize("target", ["fleet", "fleet_files", "elastic_dir"])
def test_trace_assembly_equals_the_jax_tools(ledgers, target):
    t = ledgers[target]
    p, j = ptt.assemble(t), jtt.assemble(t)
    assert ptt.format_report(p) == jtt.format_report(j)
    assert ptt.check_traces(p) == jtt.check_traces(j)
    assert ptt.trace_summary(t) == jtt.trace_summary(t)
    if target == "elastic_dir":
        assert ptt.check_traces(p) == []
        assert "slice_pipeline" in ptt.format_report(p)
    else:
        problems = " ".join(ptt.check_traces(p))
        assert "orphan" in problems and "job-j2-ff" in problems


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("argv", [
    ["summarize", "{port_run}"], ["summarize", "{elastic/ledger}", "--worker", "inline"],
    ["summarize", "{port_run}", "--job", "j1"], ["summarize", "{unclosed}"],
    ["summarize", "{port_run}", "--tolerance", "0.0001"],
    ["diff", "{port_run}", "{jax_run}"], ["check", "{port_run}"], ["check", "{corrupt}"],
    ["check", "{truncated}"], ["check", "{fleet}"], ["check", "{elastic_dir}"],
    ["check", "{missing}"], ["summarize", "{missing}"], ["trace", "{fleet}"],
    ["trace", "{elastic_dir}"],
], ids=lambda a: "-".join(x.strip("{}").replace("/", "_") for x in a))
def test_observe_cli_equals_the_jax_cli(ledgers, argv, capsys, tmp_path):
    subs = dict(ledgers, missing=str(tmp_path / "missing.jsonl"))
    args = ["observe"] + [a.format(**subs) for a in argv]
    assert _cli(cli.main, args, capsys) == _cli(jcli.main, args, capsys)


def test_observe_cli_exit_codes(ledgers, capsys, tmp_path):
    def rc(*argv):
        return _cli(cli.main, ["observe", *argv], capsys)[0]

    assert rc("check", ledgers["port_run"]) == 0
    assert rc("summarize", ledgers["port_run"]) == 0
    assert rc("check", ledgers["corrupt"]) == 1
    assert rc("trace", ledgers["fleet"]) == 1
    assert rc("trace", ledgers["elastic_dir"]) == 0
    assert rc("check", str(tmp_path / "missing.jsonl")) == 2


def test_observe_top_on_a_dead_address_exits_1(capsys, tmp_path):
    argv = ["observe", "top", "--address", f"unix:{tmp_path / 'no.sock'}", "--count", "1"]
    p = _cli(cli.main, argv, capsys)
    assert p[0] == 1 and p[1] == "" and p[2].startswith("observe top:")
