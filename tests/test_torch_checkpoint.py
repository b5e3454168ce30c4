"""Intra-stage checkpoint/resume of the port (pipeline.checkpoint, and
through run_pipeline) on the CPU: the port's versions of
tests/test_checkpoint.py's cases.

The crash-resume contract: killing a consensus stage between batches loses
at most `every` batches of work; the resumed run skips the durable prefix
(no encode, no launch) and the final BAM is SHA-equal to an uninterrupted
run's — and to the JAX package's BatchCheckpoint over its own batches."""

import hashlib
import json
import os

import numpy as np
import pytest

from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.pipeline import calling as jcalling
from bsseqconsensusreads_tpu.pipeline import checkpoint as jcheckpoint
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.faults.guard import InputChangedError
from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamReader
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.pipeline import calling
from bsseqconsensusreads_tpu_torch.pipeline import checkpoint as pcheckpoint
from bsseqconsensusreads_tpu_torch.pipeline import stages
from bsseqconsensusreads_tpu_torch.pipeline.checkpoint import BatchCheckpoint
from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


BATCH_FAMILIES = 8  # 40 families x 2 strand-groups -> ~10 batches
JAX_ROUTE = dict(mesh=None, transport="unpacked", layout="packed", vote_kernel="xla")


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ckpt")
    rng = np.random.default_rng(77)
    gname, genome = random_genome(rng, 3000)
    header, records = make_grouped_bam_records(rng, gname, genome, n_families=40)
    bam = str(tmp / "grouped.bam")
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    with BamReader(bam) as r:
        recs = list(r)
    uh = BamHeader(text="@HD\tVN:1.6\tSO:unsorted\n", references=r.header.references)
    return {"records": recs, "header": uh, "bam": bam, "tmp": tmp,
            "genome": (gname, genome)}


def _batches(grouped, **kw):
    return calling.call_molecular_batches(
        iter(grouped["records"]), batch_families=BATCH_FAMILIES, device="cpu", **kw)


def _uninterrupted(grouped, tmp_path) -> str:
    target = str(tmp_path / "whole.bam")
    ck = BatchCheckpoint(target, grouped["header"], every=2)
    ck.write_batches(_batches(grouped))
    ck.finalize()
    return target


def _dying(batches, after):
    for i, b in enumerate(batches):
        if i == after:
            raise KeyboardInterrupt
        yield b


def test_crash_and_resume_reproduces_uninterrupted_output(grouped, tmp_path, monkeypatch):
    encoded = []
    real_encode = calling.encode_molecular_families

    def counting(*a, **k):
        encoded.append(1)
        return real_encode(*a, **k)

    monkeypatch.setattr(calling, "encode_molecular_families", counting)
    full_stats = calling.StageStats()
    whole = str(tmp_path / "whole.bam")
    ck = BatchCheckpoint(whole, grouped["header"], every=2)
    ck.write_batches(_batches(grouped, stats=full_stats))
    ck.finalize()
    total = len(encoded)
    assert total >= 8
    # the JAX package's checkpoint over its own batches: the same bytes
    jax_target = str(tmp_path / "jax.bam")
    jck = jcheckpoint.BatchCheckpoint(jax_target, jbam.BamHeader(
        grouped["header"].text, grouped["header"].references), every=2)
    with jbam.BamReader(grouped["bam"]) as r:
        jck.write_batches(jcalling.call_molecular_batches(
            r, JaxParams(min_reads=1), batch_families=BATCH_FAMILIES, emit="python",
            **JAX_ROUTE))
    jck.finalize()
    assert _sha(whole) == _sha(jax_target)

    target = str(tmp_path / "consensus.bam")
    ck = BatchCheckpoint(target, grouped["header"], every=2)
    with pytest.raises(KeyboardInterrupt):  # "crash" after 5 of 10 batches
        ck.write_batches(_dying(_batches(grouped), 5))
    assert ck.batches_done == 4  # two full shards of 2; the 5th batch not durable
    manifest = json.loads((tmp_path / "consensus.bam.ckpt.json").read_text())
    assert manifest["batches_done"] == 4 and len(manifest["shards"]) == 2

    # resume in a fresh checkpoint object: only the suffix encodes
    ck2 = BatchCheckpoint(target, grouped["header"], every=2)
    assert ck2.batches_done == 4
    stats = calling.StageStats()
    encoded.clear()
    ck2.write_batches(_batches(grouped, skip_batches=ck2.batches_done, stats=stats))
    ck2.finalize()
    assert len(encoded) == total - 4
    assert stats.batches <= full_stats.batches - 4
    assert _sha(target) == _sha(whole)
    assert not list(tmp_path.glob("consensus.bam.part*"))
    assert not list(tmp_path.glob("consensus.bam.ckpt*"))


def test_checkpoint_noop_run_matches_plain(grouped, tmp_path):
    target = str(tmp_path / "ck.bam")
    ck = BatchCheckpoint(target, grouped["header"], every=3)
    ck.write_batches(_batches(grouped))
    ck.finalize()
    plain = str(tmp_path / "plain.bam")
    write_batch_stream(_batches(grouped), plain, grouped["header"], "unaligned")
    assert _sha(target) == _sha(plain)


def _with_dead_families(records, how: str):
    """Records whose first two families (in input order) cannot
    tensorize: every read an insertion read (molecular) or an
    off-vocabulary flag (duplex)."""
    dead: list = []
    for r in records:
        base = str(r.get_tag("MI")).split("/")[0]
        if base not in dead and len(dead) < 2:
            dead.append(base)
    out = []
    for r in records:
        r = r.copy()
        if str(r.get_tag("MI")).split("/")[0] in dead:
            if how == "indel":
                n = len(r.seq)
                r.cigar = [(0, n // 2), (1, 1), (0, n - n // 2 - 1)]
            else:
                r.flag = 0
        out.append(r)
    return out


@pytest.mark.parametrize("stage", ["molecular", "duplex"])
def test_skip_batches_alignment_counts_empty_batches(grouped, stage):
    """Batches that tensorize to nothing still count for skip alignment."""
    if stage == "molecular":
        recs = _with_dead_families(grouped["records"], "indel")

        def run(skip):
            return list(calling.call_molecular_batches(
                iter(recs), batch_families=2, device="cpu", skip_batches=skip))
    else:
        mol = list(_batches(grouped, mode="self"))
        recs = _with_dead_families([x for b in mol for x in b], "flag")
        name, genome = grouped["genome"]

        def run(skip):
            return list(calling.call_duplex_batches(
                iter(recs), lambda c, s, e: genome[s:e], [name], batch_families=2,
                device="cpu", skip_batches=skip))
    full = run(0)
    assert [] in full[:3]  # the dead families made an empty batch
    for skip in (1, 2, 3):
        got = run(skip)
        assert [[(r.qname, r.flag) for r in b] for b in got] == [
            [(r.qname, r.flag) for r in b] for b in full[skip:]]


def test_stale_fingerprint_discards_shards(grouped, tmp_path, capsys):
    """A manifest from a different config must not be resumed, and the
    discard prints both fingerprints."""
    uh = grouped["header"]
    target = str(tmp_path / "fp.bam")
    ck = BatchCheckpoint(target, uh, every=2, fingerprint={"input": "A"})
    ck.write_batches(b for i, b in enumerate(_batches(grouped)) if i < 4)
    assert ck.batches_done == 4
    assert BatchCheckpoint(target, uh, every=2, fingerprint={"input": "A"}).batches_done == 4
    capsys.readouterr()
    ck3 = BatchCheckpoint(target, uh, every=2, fingerprint={"input": "B"})
    assert ck3.batches_done == 0
    assert not list(tmp_path.glob("fp.bam.part*"))
    line = capsys.readouterr().err.strip().splitlines()[-1]
    name, doc = line.split(" ", 1)
    ev = json.loads(doc)
    assert name == "checkpoint_discarded" and ev["reason"] == "fingerprint_mismatch"
    assert ev["manifest_fingerprint"] == {"input": "A"}
    assert ev["run_fingerprint"] == {"input": "B"}
    assert ev["dropped_batches"] == 4


def test_input_change_refuses_resume(grouped, tmp_path):
    uh = grouped["header"]
    target = str(tmp_path / "ifp.bam")
    fp_a = {"input": "/data/in.bam", "size": 1000, "mtime": 1.0}
    ck = BatchCheckpoint(target, uh, every=2, fingerprint={"p": 1}, input_fingerprint=fp_a)
    ck.write_batches(b for i, b in enumerate(_batches(grouped)) if i < 4)
    assert BatchCheckpoint(target, uh, every=2, fingerprint={"p": 1},
                           input_fingerprint=fp_a).batches_done == 4
    fp_b = dict(fp_a, size=2000, mtime=2.0)
    with pytest.raises(InputChangedError, match="different\\s+input") as info:
        BatchCheckpoint(target, uh, every=2, fingerprint={"p": 1}, input_fingerprint=fp_b)
    assert info.value.manifest_fingerprint == fp_a and info.value.run_fingerprint == fp_b
    # the refusal left the checkpoint intact
    assert BatchCheckpoint(target, uh, every=2, fingerprint={"p": 1},
                           input_fingerprint=fp_a).batches_done == 4
    os.remove(target + ".ckpt.json")  # the documented escape hatch
    assert BatchCheckpoint(target, uh, every=2, fingerprint={"p": 1},
                           input_fingerprint=fp_b).batches_done == 0


def test_corrupt_shard_quarantined_and_recomputed(grouped, tmp_path, capsys):
    uh = grouped["header"]
    target = str(tmp_path / "crc.bam")
    ck = BatchCheckpoint(target, uh, every=2)
    ck.write_batches(_batches(grouped))
    manifest = json.loads((tmp_path / "crc.bam.ckpt.json").read_text())
    assert len(manifest["shard_crcs"]) == len(manifest["shards"])
    assert sum(manifest["shard_batches"]) == manifest["batches_done"]
    victim = str(tmp_path / manifest["shards"][1])
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(blob))

    capsys.readouterr()
    ck2 = BatchCheckpoint(target, uh, every=2)
    name, doc = capsys.readouterr().err.strip().splitlines()[-1].split(" ", 1)
    assert name == "shard_quarantined" and json.loads(doc)["shard"] == manifest["shards"][1]
    assert ck2.batches_done == 2  # truncated to the valid prefix: shard 0
    assert os.path.exists(victim + ".quarantined")
    ck2.write_batches(_batches(grouped, skip_batches=ck2.batches_done))
    ck2.finalize()
    assert _sha(target) == _sha(_uninterrupted(grouped, tmp_path))
    assert not list(tmp_path.glob("crc.bam.part*"))


def test_finalize_is_atomic(grouped, tmp_path, monkeypatch):
    target = str(tmp_path / "atomic.bam")
    ck = BatchCheckpoint(target, grouped["header"], every=4)
    ck.write_batches(_batches(grouped))
    real_replace = os.replace
    seen = {}

    def spying_replace(src, dst):
        if dst == target:
            seen["target_exists_before_rename"] = os.path.exists(target)
        return real_replace(src, dst)

    monkeypatch.setattr(pcheckpoint.os, "replace", spying_replace)
    ck.finalize()
    assert seen["target_exists_before_rename"] is False
    assert os.path.exists(target)


# ------------------------------------------------------ through run_pipeline


@pytest.fixture(scope="module")
def run_env(grouped):
    tmp = grouped["tmp"]
    name, genome = grouped["genome"]
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    return {"tmp": tmp, "fasta": fasta, "bam": grouped["bam"]}


def _cfg(run_env, **over):
    return pconfig.FrameworkConfig(
        genome_dir=os.path.dirname(run_env["fasta"]), genome_fasta_file_name="genome.fa",
        backend="cpu", batch_families=4, **over)


def _crash_after_flushes(monkeypatch, suffix: str, n: int):
    """Make the n+1-th shard flush of the stage whose target ends with
    `suffix` die, as a killed process would between two batches."""
    real = BatchCheckpoint._flush
    count = {"n": 0}

    def flush(self, items, n_batches):
        if self.target.endswith(suffix):
            if count["n"] == n:
                raise KeyboardInterrupt
            count["n"] += 1
        return real(self, items, n_batches)

    monkeypatch.setattr(BatchCheckpoint, "_flush", flush)


@pytest.mark.parametrize("stage,suffix", [
    ("molecular", "_aunamerged_aligned.bam"), ("duplex", "_duplex_unfiltered.bam")])
def test_run_pipeline_resumes_a_crashed_stage_to_the_same_bytes(run_env, tmp_path,
                                                                 monkeypatch, stage, suffix):
    plain_target, _r, plain = stages.run_pipeline(
        _cfg(run_env), run_env["bam"], outdir=str(tmp_path / "plain"))
    outdir = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _crash_after_flushes(m, suffix, 2)
        with pytest.raises(KeyboardInterrupt):
            stages.run_pipeline(_cfg(run_env, checkpoint_every=1), run_env["bam"], outdir=outdir)
    manifests = [p for p in os.listdir(outdir) if p.endswith(".ckpt.json")]
    assert len(manifests) == 1 and manifests[0].endswith(suffix + ".ckpt.json")
    manifest = json.loads(open(os.path.join(outdir, manifests[0])).read())
    assert manifest["batches_done"] == 2
    assert manifest["fingerprint"]["device"] == "cpu"
    target, results, resumed = stages.run_pipeline(
        _cfg(run_env, checkpoint_every=1), run_env["bam"], outdir=outdir)
    assert [r.ran for r in results] == ([True, True] if stage == "molecular" else [False, True])
    assert resumed[stage].batches == plain[stage].batches - 2
    assert _sha(target) == _sha(plain_target)
    inter = [p for p in os.listdir(outdir) if p.endswith("_aunamerged_aligned.bam")]
    assert _sha(os.path.join(outdir, inter[0])) == _sha(
        os.path.join(tmp_path / "plain", inter[0]))
    assert not [p for p in os.listdir(outdir) if ".part" in p or ".ckpt" in p]


def test_cpu_manifest_is_discarded_under_a_cuda_fingerprint(run_env, tmp_path,
                                                            monkeypatch, capsys):
    """Card and CPU may differ by one qual: shards computed on the CPU are
    never resumed by a run on the card (the fingerprint is built by hand,
    so no card is needed)."""
    outdir = str(tmp_path / "ck")
    cfg = _cfg(run_env, checkpoint_every=1)
    with monkeypatch.context() as m:
        _crash_after_flushes(m, "_aunamerged_aligned.bam", 3)
        with pytest.raises(KeyboardInterrupt):
            stages.run_pipeline(cfg, run_env["bam"], outdir=outdir)
    target = os.path.join(outdir, "grouped_consensus_unfiltered_aunamerged_aligned.bam")
    manifest = json.loads(open(target + ".ckpt.json").read())
    assert manifest["batches_done"] == 3
    header = BamReader(target + ".part00000.bam").header
    fp_cpu = stages.stage_fingerprint(cfg, "molecular", "cpu")
    assert manifest["fingerprint"] == fp_cpu
    assert BatchCheckpoint(target, header, every=1, fingerprint=fp_cpu,
                           input_fingerprint=manifest["input_fingerprint"]).batches_done == 3
    capsys.readouterr()
    fp_cuda = stages.stage_fingerprint(cfg, "molecular", "cuda")
    ck = BatchCheckpoint(target, header, every=1, fingerprint=fp_cuda,
                         input_fingerprint=manifest["input_fingerprint"])
    assert ck.batches_done == 0
    assert not [p for p in os.listdir(outdir) if ".part" in p]
    name, doc = capsys.readouterr().err.strip().splitlines()[-1].split(" ", 1)
    ev = json.loads(doc)
    assert name == "checkpoint_discarded"
    assert (ev["manifest_fingerprint"]["device"], ev["run_fingerprint"]["device"]) == ("cpu", "cuda")


def test_duplex_chemistry_and_device_are_in_the_duplex_fingerprint():
    cfg = pconfig.FrameworkConfig(backend="cpu")
    mol = stages.stage_fingerprint(cfg, "molecular", "cpu")
    dup = stages.stage_fingerprint(cfg, "duplex", "cpu")
    assert "chemistry" not in mol and dup["chemistry"] == "bisulfite"
    assert mol["params"] == repr(ConsensusParams(min_reads=1))
    assert dup["params"] == repr(ConsensusParams(min_reads=0))
    assert stages.stage_fingerprint(cfg, "duplex", "cuda") != dup
