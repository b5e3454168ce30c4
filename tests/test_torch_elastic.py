"""The port's elastic tier (bsseqconsensusreads_tpu_torch/elastic/) on the
CPU, held against the JAX package's (tests/test_elastic.py,
tests/test_preempt.py):

* split — the slice BAMs, the slice descriptors (trace ids aside) and
  slices.json byte-equal to the JAX split; resume, rebuild, clamping and
  the ungrouped-input refusal as in the JAX package;
* the lease ledger — the same lease / heartbeat / expiry / requeue /
  commit / preempt / fence / restart sequences through both packages'
  SliceLedger give the same replies and counts;
* the coordinator's op table over real tcp, both packages;
* fencing — a revoked fence refuses every durable write seam
  (ckpt_shard_write, ckpt_manifest_rename, ckpt_finalize) and never a
  kernel launch; preemption flushes the interrupted batch first;
* byte identity — an inline `elastic run` (backend cpu) SHA-equal to the
  port's run_pipeline and decompressed-equal (@PG aside) to the JAX
  package's elastic target, its counters reconciled; an in-process
  work_loop over tcp; a preempted worker handing off to a successor
  (shared rundir and --ship); a two-worker `elastic run` fleet with a
  killed worker, whose workers' ledgers name the port;
* the scope refusals, word for word the JAX package's;
* the flat-record callers call_molecular / call_duplex, record-equal to
  the batch callers and to the JAX package's.

Tolerance: equality of bytes, replies and counts; wall seconds, ids
minted from the clock or os.urandom, and paths are not compared.
"""

import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu import elastic as jelastic
from bsseqconsensusreads_tpu.elastic import fencing as jfencing
from bsseqconsensusreads_tpu.elastic import preempt as jpreempt
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.pipeline import calling as jcalling
from bsseqconsensusreads_tpu.pipeline import checkpoint as jckpt
from bsseqconsensusreads_tpu.serve import transport as jtransport
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch import elastic as pelastic
from bsseqconsensusreads_tpu_torch.elastic import fencing as pfencing
from bsseqconsensusreads_tpu_torch.elastic import merge as pmerge
from bsseqconsensusreads_tpu_torch.elastic import preempt as ppreempt
from bsseqconsensusreads_tpu_torch.elastic import worker as pworker
from bsseqconsensusreads_tpu_torch.faults import failpoints, integrity
from bsseqconsensusreads_tpu_torch.io import bam as pbam
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling
from bsseqconsensusreads_tpu_torch.pipeline import checkpoint as pckpt
from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline
from bsseqconsensusreads_tpu_torch.serve import transport as ptransport
from bsseqconsensusreads_tpu_torch.utils import ledger_tools, observe
from test_torch_run import assert_same_bam
from test_torch_serve import _reference_natives  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N_FAMILIES = 10


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    """The latch, the gates, the fence and the elastic identity are
    process-global in both packages: every test leaves them as found."""
    for var in ("BSSEQ_TPU_STATS", "BSSEQ_TPU_WORKER_ID", "BSSEQ_TPU_COORDINATOR_ADDR",
                "BSSEQ_TPU_FAILPOINTS"):
        monkeypatch.delenv(var, raising=False)
    yield
    for pre, ck, fe in ((ppreempt, pckpt, pfencing), (jpreempt, jckpt, jfencing)):
        pre.FLAG.clear()
        ck.install_batch_gate(None)
        ck.install_write_gate(None)
        fe.release()
    failpoints.disarm()
    observe.close_sinks()
    os.environ.pop("BSSEQ_TPU_WORKER_ID", None)
    os.environ.pop("BSSEQ_TPU_COORDINATOR_ADDR", None)
    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except ValueError:
        pass


@pytest.fixture(scope="module")
def swarm(tmp_path_factory):
    """One grouped input, the port's single-process run (the byte and
    counter baseline) and the JAX package's inline elastic target."""
    tmp = tmp_path_factory.mktemp("torch_swarm")
    rng = np.random.default_rng(905)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=N_FAMILIES,
                                               error_rate=0.01)
    bam = str(tmp / "input" / "swarm.bam")
    os.makedirs(os.path.dirname(bam), exist_ok=True)
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    kw = dict(genome_dir=os.path.dirname(fasta), genome_fasta_file_name=os.path.basename(fasta),
              aligner="self")
    cfg = pconfig.FrameworkConfig(**kw, backend="cpu")
    target, _results, stats = run_pipeline(dataclasses.replace(cfg, tmp=str(tmp / "sp_tmp")),
                                           bam, outdir=str(tmp / "single"))
    jtarget, _jr = jelastic.run_elastic(jconfig.FrameworkConfig(**kw), bam,
                                        str(tmp / "jax_elastic"), inline=True, slices=3)
    return {"tmp": tmp, "fasta": fasta, "bam": bam, "cfg": cfg, "jcfg_kw": kw,
            "records": len(records), "sp_target": target, "sp_sha": _sha(target),
            "sp_stats": {k: s.as_dict() for k, s in stats.items()}, "jax_target": jtarget}


# ---------------------------------------------------------------------------
# split


@pytest.mark.parametrize("n", [1, 3, 4, 99])
def test_split_slices_byte_equal_the_jax_split(swarm, tmp_path, n):
    got = pelastic.split_input(swarm["bam"], str(tmp_path / "port"), n)
    want = jelastic.split_input(swarm["bam"], str(tmp_path / "jax"), n)
    strip = lambda specs: [{k: v for k, v in sl.items() if k != "trace"}  # noqa: E731
                           for sl in specs]
    assert strip(got) == strip(want)
    assert len(got) == min(n, N_FAMILIES)
    assert sum(sl["records"] for sl in got) == swarm["records"]
    for p, j in zip(got, want):
        assert _sha(str(tmp_path / "port" / p["path"])) == _sha(str(tmp_path / "jax" / j["path"]))
        assert p["trace"]["trace"].startswith(f"slice-{pelastic.slice_name(p['sid'])}-")
    if n == 4:
        assert [sl["families"] for sl in got] == [2, 3, 2, 3]


def test_split_resumes_intact_and_rebuilds_damaged_slices(swarm, tmp_path):
    rundir = str(tmp_path / "run")
    specs = pelastic.split_input(swarm["bam"], rundir, 3)
    mtimes = [os.path.getmtime(os.path.join(rundir, sl["path"])) for sl in specs]
    assert pelastic.split_input(swarm["bam"], rundir, 3) == specs
    assert [os.path.getmtime(os.path.join(rundir, sl["path"])) for sl in specs] == mtimes
    victim = os.path.join(rundir, specs[1]["path"])
    with open(victim, "r+b") as fh:
        fh.write(b"\x00\x00\x00\x00")
    assert pelastic.split_input(swarm["bam"], rundir, 3) == specs  # same trace ids kept
    integrity.verify_file_crc32(victim, specs[1]["input_crc"])


def test_split_refuses_ungrouped_input_as_the_jax_package(swarm, tmp_path):
    ungrouped = str(tmp_path / "ungrouped.bam")
    with pbam.BamReader(swarm["bam"]) as r:
        header, recs = r.header, list(r)
    for rec in recs:
        rec.tags.pop("MI", None)
    with pbam.BamWriter(ungrouped, header) as w:
        w.write_all(recs)
    errors = []
    for lib, d in ((pelastic, "p"), (jelastic, "j")):
        with pytest.raises(lib.ElasticError, match="grouped") as ei:
            lib.split_input(ungrouped, str(tmp_path / d), 2)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# the lease ledger (fake slices: no pipeline involved)


def _fake_rundir(root, n=2):
    rundir = str(root)
    specs = []
    for sid in range(n):
        os.makedirs(os.path.join(rundir, "slices", pelastic.slice_name(sid)), exist_ok=True)
        specs.append({"sid": sid, "path": os.path.join("slices", f"s{sid:04d}.bam"),
                      "records": 5 + sid, "families": 2, "family_crc": 1000 + sid,
                      "input_crc": 0})
    return rundir, specs


def _out(rundir, sid, payload=b"consensus-bytes"):
    path = os.path.join(rundir, "slices", pelastic.slice_name(sid), "out.bam")
    with open(path, "wb") as fh:
        fh.write(payload)
    return {"slice": pelastic.slice_name(sid), "output": "out.bam",
            "crc": integrity.file_crc32(path), "family_crc": 1000 + sid, "records_out": 2}


def _seq_commit_and_wait(lib, root):
    rundir, specs = _fake_rundir(root, n=2)
    led = lib.SliceLedger(rundir, specs, lease_s=30.0)
    g0 = led.lease("w0")
    g1 = led.lease("w1")
    out = [g0, g1, led.lease("w2"), led.heartbeat("w0", g0["lease_id"]),
           led.heartbeat("w1", g0["lease_id"])]
    out.append(led.commit(g0["lease_id"], 0, dict(_out(rundir, 0), family_crc=9)))
    out.append(led.commit(g0["lease_id"], 0, dict(_out(rundir, 0), crc=12345))["ok"])
    out.append(led.commit(g0["lease_id"], 0, _out(rundir, 0), worker="w0"))
    out.append(led.commit(g1["lease_id"], 1, _out(rundir, 1), worker="w1"))
    out += [led.lease("w0"), led.all_done(), led.counts()]
    return out


def _seq_expiry_requeue_duplicate(lib, root):
    rundir, specs = _fake_rundir(root, n=1)
    led = lib.SliceLedger(rundir, specs, lease_s=0.05)
    stale = led.lease("w0")
    time.sleep(0.12)
    out = [led.expire_scan(), led.heartbeat("w0", stale["lease_id"])]
    manifest = _out(rundir, 0)
    out.append(led.commit(stale["lease_id"], 0, manifest, worker="w0"))
    fresh = led.lease("w1")
    out += [fresh, led.commit(fresh["lease_id"], 0, manifest, worker="w1"),
            led.commit(stale["lease_id"], 0, manifest, worker="w0"), led.counts()]
    return out


def _seq_death_preempt_fence(lib, root):
    rundir, specs = _fake_rundir(root, n=2)
    led = lib.SliceLedger(rundir, specs, lease_s=3600.0)
    g0 = led.lease("w0")
    g1 = led.lease("w1")
    led.note_worker_dead("w0")
    fresh = led.lease("w2")
    out = [g0, g1, fresh, led.heartbeat("w0", g0["lease_id"])]
    # the zombie's preempt and publish are fenced before any bookkeeping
    out.append(led.preempt("w0", g0["lease_id"], 0, batches_kept=1,
                           epoch=g0["fence_epoch"]))
    out.append(led.commit(g0["lease_id"], 0, _out(rundir, 0), worker="w0",
                          epoch=g0["fence_epoch"]))
    out.append(led.preempt("w1", "no-such-lease", 1))
    out.append(led.preempt("w1", g1["lease_id"], 1, batches_kept=2, epoch=g1["fence_epoch"]))
    out += [led.lease("w1"), led.slice_epoch(1), led.counts()]
    return out


def _seq_restart_rescan(lib, root):
    rundir, specs = _fake_rundir(root, n=2)
    led = lib.SliceLedger(rundir, specs, lease_s=30.0)
    g = led.lease("w0")
    led.commit(g["lease_id"], 0, _out(rundir, 0))
    reborn = lib.SliceLedger(rundir, specs, lease_s=30.0)
    out = [reborn.counts(), reborn.lease("w0")]
    with open(os.path.join(rundir, "slices", "s0000", "out.bam"), "wb") as fh:
        fh.write(b"bitrot")
    out.append(lib.SliceLedger(rundir, specs, lease_s=30.0).counts())
    return out


@pytest.mark.parametrize("seq", [_seq_commit_and_wait, _seq_expiry_requeue_duplicate,
                                 _seq_death_preempt_fence, _seq_restart_rescan],
                         ids=lambda f: f.__name__[5:])
def test_slice_ledger_sequences_equal_the_jax_packages(seq, tmp_path):
    assert seq(pelastic, tmp_path / "port") == seq(jelastic, tmp_path / "jax")


def _served(lib, rundir, specs, **kw):
    led = lib.SliceLedger(rundir, specs, lease_s=30.0)
    server = lib.Coordinator(led, {"doc": True}, addresses=["tcp:127.0.0.1:0"], **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    deadline = time.monotonic() + 10.0
    while not server.bound and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.bound
    return server, thread


def test_coordinator_op_table_equals_the_jax_packages(tmp_path):
    replies = {}
    for name, lib, tr in (("port", pelastic, ptransport), ("jax", jelastic, jtransport)):
        rundir, specs = _fake_rundir(tmp_path / name, n=1)
        server, thread = _served(lib, rundir, specs)
        addr = server.bound[0]
        try:
            r = [tr.request(addr, {"op": "ping"}),
                 {k: v for k, v in tr.request(addr, {"op": "elastic_join", "worker": "wt"})
                  .items() if k != "rundir"}]
            grant = tr.request(addr, {"op": "lease", "worker": "wt"})
            r += [grant, tr.request(addr, {"op": "heartbeat", "worker": "wt",
                                           "lease_id": grant["lease_id"]}),
                  tr.request(addr, {"op": "status"}), tr.request(addr, {"op": "metrics"}),
                  tr.request(addr, {"op": "frobnicate"}),
                  tr.request(addr, {"op": "publish", "worker": "wt",
                                    "lease_id": grant["lease_id"], "slice": 0,
                                    "manifest": dict(_out(rundir, 0), family_crc=31337)}),
                  tr.request(addr, {"op": "publish", "worker": "wt",
                                    "lease_id": grant["lease_id"], "slice": 0,
                                    "manifest": _out(rundir, 0)}),
                  tr.request(addr, {"op": "lease", "worker": "wt"})]
        finally:
            server.request_drain()
            thread.join(timeout=10.0)
        replies[name] = r
    assert replies["port"] == replies["jax"]
    assert replies["port"][-1] == {"ok": True, "done": True}


# ---------------------------------------------------------------------------
# fencing and preemption


class _Seams:
    """A BatchCheckpoint driven seam by seam."""

    def __init__(self, root):
        rng = np.random.default_rng(77)
        gname, genome = random_genome(rng, 3000)
        header, self.records = make_grouped_bam_records(rng, gname, genome, n_families=12)
        self.header = pbam.BamHeader(text="@HD\tVN:1.6\tSO:unsorted\n",
                                     references=header.references)
        self.target = str(root / "consensus.bam")

    def batches(self):
        return pcalling.call_molecular_batches(iter(self.records), batch_families=4,
                                               device="cpu")


def test_a_revoked_fence_refuses_every_write_seam_and_no_launch(tmp_path):
    seams = _Seams(tmp_path)
    pfencing.adopt(7, "s0000.1")
    ck = pckpt.BatchCheckpoint(seams.target, seams.header, every=1)
    ck.write_batches(seams.batches())  # a live fence: every write lands
    assert ck.batches_done >= 3
    pfencing.revoke("test", lease_id="s0000.1")
    assert pfencing.is_revoked()
    with pytest.raises(pfencing.FencedError, match="ckpt_shard_write refused: fence epoch 7"):
        pckpt.BatchCheckpoint(seams.target + "2", seams.header).write_batches(seams.batches())
    with pytest.raises(pfencing.FencedError, match="ckpt_manifest_rename refused"):
        ck.manifest.save(ck.manifest_path)
    with pytest.raises(pfencing.FencedError, match="ckpt_finalize refused"):
        ck.finalize()
    # the vote itself is not a write seam: batches still compute
    assert sum(len(b) for b in seams.batches()) > 0
    # another lease's revoke does not touch this fence
    pfencing.adopt(8, "s0001.2")
    pfencing.revoke("other", lease_id="s0000.1")
    assert not pfencing.is_revoked() and pfencing.current() == 8
    pfencing.check("publish")


def test_fence_refusal_text_equals_the_jax_packages():
    msgs = []
    for fe in (pfencing, jfencing):
        fe.adopt(3, "s0002.5")
        fe.revoke("lease s0002.5 expired at the coordinator", lease_id="s0002.5")
        with pytest.raises(fe.FencedError) as ei:
            fe.check("ckpt_finalize")
        msgs.append((str(ei.value), ei.value.epoch))
        fe.release()
        fe.check("ckpt_finalize")
    assert msgs[0] == msgs[1]


def test_preempt_flushes_the_interrupted_batch_first(tmp_path):
    """The crash path keeps only full shards; the preempt gate flushes
    the pending buffer first, so the batch the latch interrupted is
    durable, and the batch stream is closed before the error unwinds."""
    seams = _Seams(tmp_path)
    ck = pckpt.BatchCheckpoint(seams.target, seams.header, every=2)
    flag = ppreempt.PreemptFlag()
    real = ppreempt.batch_gate(flag)

    def gate(done):
        if done == 3:
            flag.request()
        real(done)

    pckpt.install_batch_gate(gate)
    stream = pcalling.call_molecular_batches(iter(seams.records * 2), batch_families=4,
                                             device="cpu")
    with pytest.raises(ppreempt.PreemptedError) as ei:
        ck.write_batches(stream)
    assert ei.value.batches_kept == 3 == ck.batches_done
    with open(ck.manifest_path) as fh:
        assert json.load(fh)["batches_done"] == 3
    assert stream.gi_frame is None  # closed: no batch left in flight


def test_preempt_latch_and_handoff_equal_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("BSSEQ_TPU_PREEMPT_GRACE_S", "7.5")
    out = []
    for pre, d in ((ppreempt, "p"), (jpreempt, "j")):
        flag = pre.PreemptFlag()
        gate = pre.batch_gate(flag)
        gate(1)
        row = [flag.pending(), flag.request(), flag.request(), pre.grace_s()]
        row.append(round(flag.deadline() - flag.requested_at(), 6))
        with pytest.raises(pre.PreemptedError) as ei:
            gate(4)
        row += [ei.value.batches_kept, str(ei.value)]
        path = pre.write_handoff(str(tmp_path / d), slice_name="s0001", worker="w0",
                                 batches_kept=4)
        doc = pre.read_handoff(str(tmp_path / d))
        row += [os.path.basename(path), {k: v for k, v in doc.items() if k != "written_at"},
                pre.read_handoff(str(tmp_path / "absent"))]
        out.append(row)
    assert out[0] == out[1]
    assert ppreempt.install_signal_handler() is True
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5.0
    while not ppreempt.FLAG.pending() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert ppreempt.FLAG.pending()  # the latch, not a kill


# ---------------------------------------------------------------------------
# byte identity


def test_inline_elastic_run_equals_run_and_the_jax_packages_target(swarm, tmp_path):
    target, report = pelastic.run_elastic(swarm["cfg"], swarm["bam"], str(tmp_path / "out"),
                                          inline=True, slices=3)
    assert _sha(target) == swarm["sp_sha"]
    assert os.path.basename(target) == os.path.basename(swarm["jax_target"])
    assert_same_bam(target, swarm["jax_target"])
    assert report["ok"] and all(report["checks"].values())
    assert report["requeues"] == 0 and report["records_split"] == swarm["records"]
    # summed per-slice counters equal the single-process run's
    # ('batches' aside: slicing changes batch composition, not content)
    for stage in ("molecular", "duplex"):
        for key in pmerge.SUMMABLE_STATS:
            if key != "batches":
                assert report["stats"][stage][key] == swarm["sp_stats"][stage][key], (stage, key)


@pytest.mark.parametrize("slices", [1, 4, 7])
def test_inline_elastic_run_is_sha_equal_at_any_slice_count(swarm, tmp_path, slices):
    target, report = pelastic.run_elastic(swarm["cfg"], swarm["bam"], str(tmp_path / "out"),
                                          inline=True, slices=slices)
    assert _sha(target) == swarm["sp_sha"] and report["ok"]


def test_merge_header_names_the_port():
    h = pbam.BamHeader(text="@HD\tVN:1.6\tSO:unsorted\n", references=[("chr1", 100)])
    text = pmerge.final_header(h, "S").text
    assert "PN:bsseqconsensusreads_tpu_torch" in text and "SO:coordinate" in text
    assert text.count("@PG") == 2


def test_work_loop_over_tcp_then_merge(swarm, tmp_path, monkeypatch):
    """join -> lease -> pipeline -> publish over real tcp, then the merge;
    every slice's kernel launches are ledgered (0 on the CPU)."""
    sink = str(tmp_path / "l.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    outdir = str(tmp_path / "out")
    rundir = os.path.join(outdir, "elastic")
    os.makedirs(rundir)
    specs = pelastic.split_input(swarm["bam"], rundir, 3)
    led = pelastic.SliceLedger(rundir, specs, lease_s=30.0)
    server = pelastic.Coordinator(led, pelastic.config_doc(swarm["cfg"]),
                                  addresses=["tcp:127.0.0.1:0"])
    server.start_monitor()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 10.0
        while not server.bound and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pworker.work_loop(server.bound[0], worker_id="wl0") == 3
    finally:
        server.request_drain()
        thread.join(timeout=10.0)
    target, report = pmerge.finalize(swarm["cfg"], swarm["bam"], outdir, specs, led.manifests())
    assert report["ok"] and _sha(target) == swarm["sp_sha"]
    assert {m["worker"] for m in led.manifests().values()} == {"wl0"}
    observe.close_sinks()
    launches = [d for d in _lines(sink) if d["event"] == "kernel_launches"]
    assert len(launches) == 3 and all(d["backend"] == "cpu" for d in launches)
    assert all(d[k] == 0 for d in launches for k in cuda_vote.LAUNCHES)
    s = ledger_tools.summarize_ledger(sink, worker="wl0")
    assert s.worker == "wl0" and not s.problems


def test_a_stale_final_is_reset_and_recomputed(swarm, tmp_path):
    rundir = str(tmp_path / "run")
    specs = pelastic.split_input(swarm["bam"], rundir, 3)
    first = pworker.process_slice(swarm["cfg"], rundir, specs[0], worker="wa")
    second = pworker.process_slice(swarm["cfg"], rundir, specs[0], worker="wb")
    assert (second["crc"], second["buckets"]) == (first["crc"], first["buckets"])
    assert second["stats"]["molecular"]["records_in"] == \
        first["stats"]["molecular"]["records_in"] > 0


def test_a_card_worker_without_a_card_fails_loudly(swarm, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the worker would use it")
    rundir = str(tmp_path / "run")
    specs = pelastic.split_input(swarm["bam"], rundir, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pworker.process_slice(dataclasses.replace(swarm["cfg"], backend="cuda"), rundir,
                              specs[0], worker="w0")


@pytest.mark.parametrize("ship", [False, True])
def test_a_preempted_worker_hands_off_and_the_successor_matches(swarm, tmp_path, monkeypatch,
                                                                 ship):
    sink = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv("BSSEQ_TPU_STATS", sink)
    cfg = dataclasses.replace(swarm["cfg"], batch_families=2)
    outdir = str(tmp_path / "out")
    rundir = os.path.join(outdir, "elastic")
    os.makedirs(rundir)
    specs = pelastic.split_input(swarm["bam"], rundir, 2)
    led = pelastic.SliceLedger(rundir, specs, lease_s=300.0)
    server = pelastic.Coordinator(led, pelastic.config_doc(cfg), addresses=["tcp:127.0.0.1:0"],
                                  ship=ship)
    server.start_monitor()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    arm = {"on": True}
    real_factory = ppreempt.batch_gate

    def triggering_factory(flag=None):
        real = real_factory(flag)

        def gate(done):
            if arm["on"] and done >= 2:
                ppreempt.FLAG.request()  # what the SIGTERM handler does
            real(done)

        return gate

    monkeypatch.setattr(ppreempt, "batch_gate", triggering_factory)
    try:
        deadline = time.monotonic() + 10.0
        while not server.bound and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pworker.work_loop(server.bound[0], worker_id="pw0") == 0
        counts = led.counts()
        assert counts["preempts"] == 1 and counts["requeues"] == 1
        handoff = ppreempt.read_handoff(os.path.join(rundir, "slices", "s0000"))
        if ship:
            assert handoff is None
        else:
            assert handoff["batches_kept"] >= 2 and handoff["worker"] == "pw0"
        arm["on"] = False
        ppreempt.FLAG.clear()
        assert pworker.work_loop(server.bound[0], worker_id="pw1") == 2
    finally:
        server.request_drain()
        thread.join(timeout=10.0)
    target, report = pmerge.finalize(cfg, swarm["bam"], outdir, specs, led.manifests())
    assert report["ok"] and _sha(target) == swarm["sp_sha"]
    observe.close_sinks()
    events = _lines(sink)
    (published,) = [e for e in events if e["event"] == "handoff_published"]
    assert published["worker"] == "pw0" and published["batches_kept"] >= 2
    assert 0.0 <= published["handoff_latency_s"] < ppreempt.grace_s()
    (pre,) = [e for e in events if e["event"] == "worker_preempted"]
    assert (pre["worker"], pre["reason"]) == ("pw0", "handoff")


def test_two_worker_fleet_with_a_killed_worker_is_sha_equal(swarm, tmp_path):
    """`elastic run --workers 2` on the CPU: w0 is killed (exit 9) as it
    starts its first slice, the slice requeues, w0 respawns, and the
    target equals `run`; every worker's run_manifest names the port."""
    ledger = str(tmp_path / "elastic_ledger.jsonl")
    env = dict(os.environ, PYTHONPATH=REPO, BSSEQ_TPU_STATS=ledger,
               BSSEQ_TPU_RETRY_BACKOFF_S="0.01", BSSEQ_TPU_HOST_WORKERS="0")
    env.pop("BSSEQ_TPU_FAILPOINTS", None)
    cp = subprocess.run(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "elastic", "run",
         "--bam", swarm["bam"], "--reference", swarm["fasta"], "--outdir",
         str(tmp_path / "out"), "--workers", "2", "--slices", "4", "--device", "cpu",
         "--worker-failpoints", "w0:elastic_slice=exit:9@hit=1"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    out = json.loads(cp.stdout)
    assert _sha(out["target"]) == swarm["sp_sha"]
    report = out["report"]
    assert report["ok"] and report["requeues"] >= 1 and report["workers_lost"] >= 1
    lines = _lines(ledger)
    count = lambda ev: sum(1 for d in lines if d["event"] == ev)  # noqa: E731
    assert count("elastic_worker_spawn") >= 3 and count("slice_requeued") >= 1
    assert count("elastic_slice_done") == 4 and count("failpoint_fired") >= 1
    # a worker opens its ledger with its first slice's pipeline (w0 may
    # die before one, and its respawn may find the queue empty)
    manifests = [d for d in lines if d["event"] == "run_manifest" and d.get("worker_id")]
    assert manifests and {d["worker_id"] for d in manifests} <= {"w0", "w1"}
    for d in manifests:
        assert "bsseqconsensusreads_tpu_torch" in d["argv"] and "elastic worker" in d["argv"]
        assert d["backend"] in ("cpu", "cuda") and "version" in d
    assert {d["backend"] for d in lines if d["event"] == "kernel_launches"} == {"cpu"}
    for wid in {d["worker_id"] for d in manifests}:
        s = ledger_tools.summarize_ledger(ledger, worker=wid)
        assert s.worker == wid and not s.problems


# ---------------------------------------------------------------------------
# refusals and config


@pytest.mark.parametrize("over", [{"aligner": "bwameth"}, {"aligner": "none"},
                                  {"methyl": "both"}, {"single_strand": True},
                                  {"filter": {"min_reads": [1, 1, 1]}},
                                  {"aligner": "none", "methyl": "cx"}])
def test_scope_refusals_are_the_jax_packages_words(swarm, over):
    msgs = []
    for lib, cfg_mod in ((pelastic, pconfig), (jelastic, jconfig)):
        cfg = cfg_mod.FrameworkConfig(**{**swarm["jcfg_kw"], **over})
        with pytest.raises(lib.ElasticError) as ei:
            lib.run_elastic(cfg, swarm["bam"], "unused")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and msgs[0].startswith("elastic run refused: ")


def test_ship_needs_a_fleet(swarm, tmp_path):
    with pytest.raises(pelastic.ElasticError, match="--ship needs a worker fleet"):
        pelastic.run_elastic(swarm["cfg"], swarm["bam"], str(tmp_path), inline=True, ship=True)


def test_config_doc_roundtrip_and_slice_config(swarm):
    cfg = swarm["cfg"]
    assert pelastic.config_from_doc(json.loads(json.dumps(pelastic.config_doc(cfg)))) == cfg
    sc = pelastic.slice_config(cfg)
    assert (sc.group_umis, sc.stream_interstage, sc.checkpoint_every) == ("never", False, 4)
    assert sc.backend == "cpu"


# ---------------------------------------------------------------------------
# the flat-record callers


def _encoded(recs, lib):
    return [lib.encode_record(r) for r in recs]


def test_call_molecular_is_the_flat_view_of_the_batch_caller(swarm):
    with pbam.BamReader(swarm["bam"]) as r:
        recs = list(r)
    with jbam.BamReader(swarm["bam"]) as r:
        jrecs = list(r)
    params = ConsensusParams(min_reads=1)
    flat = list(pcalling.call_molecular(iter(recs), params, batch_families=4, device="cpu"))
    batched = [x for b in pcalling.call_molecular_batches(iter(recs), params, batch_families=4,
                                                          device="cpu") for x in b]
    want = list(jcalling.call_molecular(iter(jrecs), batch_families=4))
    assert _encoded(flat, pbam) == _encoded(batched, pbam) == _encoded(want, jbam)
    assert len(flat) > 0


def test_call_duplex_is_the_flat_view_of_the_batch_caller(swarm, tmp_path):
    from bsseqconsensusreads_tpu.io.fasta import FastaFile as JFasta
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile as PFasta

    target, _results, _stats = run_pipeline(
        dataclasses.replace(swarm["cfg"], tmp=str(tmp_path / "t")), swarm["bam"],
        outdir=str(tmp_path / "o"))
    aligned = os.path.join(str(tmp_path / "o"), "swarm_consensus_unfiltered_aunamerged_aligned.bam")
    with pbam.BamReader(aligned) as r:
        names = [n for n, _ in r.header.references]
        recs = list(r)
    with jbam.BamReader(aligned) as r:
        jrecs = list(r)
    with PFasta(swarm["fasta"]) as pf, JFasta(swarm["fasta"]) as jf:
        flat = list(pcalling.call_duplex(iter(recs), pf.fetch, names, batch_families=4,
                                         device="cpu"))
        batched = [x for b in pcalling.call_duplex_batches(iter(recs), pf.fetch, names,
                                                           batch_families=4, device="cpu")
                   for x in b]
        want = list(jcalling.call_duplex(iter(jrecs), jf.fetch, names, batch_families=64))
    assert _encoded(flat, pbam) == _encoded(batched, pbam) == _encoded(want, jbam)
    assert len(flat) > 0
