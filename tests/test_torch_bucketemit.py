"""The port's bucket sort engine (pipeline.bucketemit with
io.wirepack.bucket_split), its fused molecular->duplex rule
(pipeline.stages run_fused) and the parallel BGZF writer (io.pbgzf) on
the CPU against the JAX package's and against the port's other engines.

Tolerance: equality. Sorted streams are compared as BGZF file bytes
(one continuous writer: the bucket concatenation must not even cut a
block differently); `run` outputs decompressed, @PG lines aside (the
port's name the port, tests/test_torch_run.assert_same_bam)."""

import gzip
import hashlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.pipeline import extsort as je
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.faults import failpoints
from bsseqconsensusreads_tpu_torch.io import bam as pbam
from bsseqconsensusreads_tpu_torch.io import bgzf as pbgzf
from bsseqconsensusreads_tpu_torch.io import pbgzf as ppbgzf
from bsseqconsensusreads_tpu_torch.io import wirepack as pwirepack
from bsseqconsensusreads_tpu_torch.pipeline import bucketemit as pbe
from bsseqconsensusreads_tpu_torch.pipeline import extsort as pe
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from tests.test_torch_run import assert_same_bam
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(path: str) -> bytes:
    with gzip.open(path) as fh:
        return fh.read()


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def blobs():
    """(header, mixed item stream as encoded blobs): 3 contigs, 1,500
    records with repeated coordinates, unmapped records (ref -1) and
    mapped-ref / unplaced-pos records."""
    rng = np.random.default_rng(9)
    header = pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n",
                            [("c1", 50_000), ("c2", 20_000), ("c3", 9_000)])
    out = []
    for i in range(1500):
        ref = int(rng.integers(-1, 3))
        pos = int(rng.integers(0, 400)) * 37 if ref >= 0 else -1
        if i % 97 == 0 and ref >= 0:
            pos = -1
        rec = pbam.BamRecord(qname=f"q{int(rng.integers(0, 300))}", flag=int(rng.choice([0, 16, 99, 147])),
                             ref_id=ref, pos=pos, mapq=60, cigar=[(0, 20)] if ref >= 0 else [],
                             seq="ACGTACGTACGTACGTACGT", qual=bytes([30] * 20))
        out.append(pbam.encode_record(rec))
    return header, out


def _items(blobs_list):
    """The blobs as a producer's stream: RawRecords blocks of varying
    size and single blobs, as the consensus stages hand them on."""
    items, i, k = [], 0, 0
    while i < len(blobs_list):
        n = (k % 7) + 1
        chunk = blobs_list[i:i + n]
        items.append(pbam.RawRecords(b"".join(chunk), len(chunk)) if n > 1 else chunk[0])
        i += n
        k += 1
    return items


def _port_sorted(header, blobs_list, path, engine, buckets=0, buffer_records=100_000):
    with pbam.BamWriter(path, header) as w:
        n = pe.external_sort_raw_to_writer(_items(blobs_list), w, header, engine=engine,
                                           sort_buckets=buckets, buffer_records=buffer_records)
    return n


@pytest.mark.parametrize("buffer_records", [100_000, 64, 7])
@pytest.mark.parametrize("buckets", [1, 3, 17])
def test_bucket_engine_equals_the_merge_engines_and_the_jax_bucket_engine(
        blobs, tmp_path, buckets, buffer_records):
    header, bl = blobs
    shas = {}
    for engine in ("bucket", "native", "python"):
        path = str(tmp_path / f"{engine}.bam")
        assert _port_sorted(header, bl, path, engine, buckets, buffer_records) == len(bl)
        shas[engine] = _sha(path)
    jheader = jbam.BamHeader(header.text, header.references)
    jpath = str(tmp_path / "jax.bam")
    with jbam.BamWriter(jpath, jheader) as w:
        je.external_sort_raw_to_writer(
            [jbam.RawRecords(it.blob, it.count) if isinstance(it, pbam.RawRecords) else it
             for it in _items(bl)],
            w, jheader, engine="bucket", sort_buckets=buckets, buffer_records=buffer_records)
    assert shas["bucket"] == shas["native"] == shas["python"] == _sha(jpath)


def test_bucket_split_and_plan_equal_the_jax_packages(blobs):
    from bsseqconsensusreads_tpu.io import wirepack as jwirepack
    from bsseqconsensusreads_tpu.pipeline import bucketemit as jbe

    header, bl = blobs
    blob = b"".join(bl)
    jheader = jbam.BamHeader(header.text, header.references)
    for n in (1, 5, 32):
        plan = pbe.BucketPlan.from_header(header, n)
        assert plan.boundaries == jbe.BucketPlan.from_header(jheader, n).boundaries
        parts, counts = pwirepack.bucket_split(blob, plan.as_array())
        jparts, jcounts = jwirepack.bucket_split(blob, plan.as_array())
        assert parts == jparts and counts.tolist() == jcounts.tolist()
        assert int(counts.sum()) == len(bl)
        keys = [pbe.blob_bucket_key(b) for b in bl]
        assert counts.tolist() == np.bincount([plan.bucket_of(k) for k in keys],
                                              minlength=plan.nbuckets).tolist()


@pytest.mark.parametrize("workers", [1, 2, 3, 5])
def test_pbgzf_writer_bytes_equal_the_serial_writer(workers):
    rng = np.random.default_rng(workers)
    payload = [rng.integers(0, 4, size=int(n)).astype(np.uint8).tobytes()
               for n in rng.integers(1, 90_000, size=12)]
    serial, par = io.BytesIO(), io.BytesIO()
    sw = pbgzf.BgzfWriter(serial, level=6)
    pw = ppbgzf.PBgzfWriter(par, level=6, workers=workers, window=2)
    for i, chunk in enumerate(payload):
        sw.write(chunk)
        pw.write(chunk)
        if i % 5 == 4:
            sw.flush()
            pw.flush()
    serial_bytes = _closed(sw, serial)
    assert _closed(pw, par) == serial_bytes


def _closed(writer, buf) -> bytes:
    close = buf.close
    buf.close = lambda: None  # keep the bytes readable after the writer closes
    writer.close()
    data = buf.getvalue()
    close()
    return data


def test_python_codec_takes_pbgzf_with_workers(tmp_path, monkeypatch):
    monkeypatch.setenv("BSSEQ_TPU_PBGZF", "3")
    w = pbam.BamWriter(str(tmp_path / "p.bam"), pbam.BamHeader("@HD\tVN:1.6\n", []),
                       engine="python")
    assert isinstance(w._bgzf, ppbgzf.PBgzfWriter) and w._bgzf.workers == 3
    w.close()
    monkeypatch.setenv("BSSEQ_TPU_PBGZF", "0")
    w = pbam.BamWriter(str(tmp_path / "s.bam"), pbam.BamHeader("@HD\tVN:1.6\n", []),
                       engine="python")
    assert isinstance(w._bgzf, pbgzf.BgzfWriter)
    w.close()


@pytest.fixture(scope="module")
def run_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_bucket_run")
    rng = np.random.default_rng(77)
    name, genome = random_genome(rng, 20_000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=60,
                                               error_rate=0.01)
    bam = str(tmp / "sampleB.bam")
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    return {"tmp": tmp, "fasta": fasta, "bam": bam}


def _cfg(mod, env, **over):
    return mod.FrameworkConfig(genome_dir=os.path.dirname(env["fasta"]),
                               genome_fasta_file_name=os.path.basename(env["fasta"]),
                               backend="cpu", batch_families=16, sort_buffer_records=40,
                               sort_buckets=5, **over)


def test_run_fused_equals_the_jax_packages_run_fused(run_env, capsys):
    kw = dict(sort_engine="bucket", stream_interstage=True)
    jt, _r, _s = jstages.run_pipeline(_cfg(jconfig, run_env, **kw), run_env["bam"],
                                      outdir=str(run_env["tmp"] / "jax_fused"))
    pt, results, stats = pstages.run_pipeline(_cfg(pconfig, run_env, **kw), run_env["bam"],
                                              outdir=str(run_env["tmp"] / "port_fused"))
    assert "stream_interstage disabled" not in capsys.readouterr().err
    assert [r.name for r in results] == ["call_consensus_molecular_duplex_fused"]
    assert_same_bam(pt, jt)
    inter = "sampleB_consensus_unfiltered_aunamerged_aligned.bam"
    assert_same_bam(str(run_env["tmp"] / "port_fused" / inter),
                    str(run_env["tmp"] / "jax_fused" / inter))
    assert stats["molecular"].metrics.counters["bucket_count"] == 5
    # the two-pass bucket run writes the same target and intermediate
    tt, results, _s = pstages.run_pipeline(_cfg(pconfig, run_env, sort_engine="bucket"),
                                           run_env["bam"],
                                           outdir=str(run_env["tmp"] / "port_two"))
    assert [r.name for r in results] == ["call_consensus_molecular_tpu", "call_duplex_tpu"]
    assert_same_bam(tt, jt)


_KILL = """
import sys
sys.path.insert(0, {repo!r})
from bsseqconsensusreads_tpu_torch import config
from bsseqconsensusreads_tpu_torch.pipeline import stages
cfg = config.FrameworkConfig(genome_dir={gdir!r}, genome_fasta_file_name={gname!r},
                             backend="cpu", batch_families=16, sort_buffer_records=40,
                             sort_buckets=5, sort_engine="bucket", checkpoint_every=1)
stages.run_pipeline(cfg, {bam!r}, outdir={outdir!r})
"""


def test_killed_bucket_finalize_resumes_to_the_same_bytes(run_env):
    ref, _r, _s = pstages.run_pipeline(_cfg(pconfig, run_env, sort_engine="native"),
                                       run_env["bam"], outdir=str(run_env["tmp"] / "ref"))
    outdir = str(run_env["tmp"] / "killed")
    script = _KILL.format(repo=REPO, gdir=os.path.dirname(run_env["fasta"]),
                          gname=os.path.basename(run_env["fasta"]), bam=run_env["bam"],
                          outdir=outdir)
    env = dict(os.environ, BSSEQ_TPU_FAILPOINTS="bucket_finalize=exit:9@hit=3",
               BSSEQ_TPU_HOST_WORKERS="2")
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 9, proc.stderr
    runs = [d for d in os.listdir(outdir) if d.endswith(".bucketruns")]
    assert runs, os.listdir(outdir)  # phase A committed its runs before the kill
    failpoints.disarm()
    target, _r, stats = pstages.run_pipeline(
        _cfg(pconfig, run_env, sort_engine="bucket", checkpoint_every=1), run_env["bam"],
        outdir=outdir)
    assert _plain(target) == _plain(ref)
    assert not [d for d in os.listdir(outdir) if d.endswith(".bucketruns")]


def test_damaged_bucket_run_replays_only_its_bucket(run_env):
    """A bucket run corrupted between the kill and the resume: only its
    bucket replays from the shards ('bucket_replayed' 1), same bytes."""
    ref, _r, _s = pstages.run_pipeline(_cfg(pconfig, run_env, sort_engine="native"),
                                       run_env["bam"], outdir=str(run_env["tmp"] / "ref2"))
    outdir = str(run_env["tmp"] / "damaged")
    failpoints.arm("bucket_finalize=raise:RuntimeError@hit=2")
    try:
        with pytest.raises(RuntimeError, match="bucket_finalize"):
            pstages.run_pipeline(_cfg(pconfig, run_env, sort_engine="bucket",
                                      checkpoint_every=1), run_env["bam"], outdir=outdir)
    finally:
        failpoints.disarm()
    rundir = [os.path.join(outdir, d) for d in os.listdir(outdir) if d.endswith(".bucketruns")]
    run = sorted(f for f in os.listdir(rundir[0]) if f.endswith(".bam"))[0]
    with open(os.path.join(rundir[0], run), "r+b") as fh:
        fh.seek(30)
        fh.write(b"\xff\xff")
    target, _r, stats = pstages.run_pipeline(
        _cfg(pconfig, run_env, sort_engine="bucket", checkpoint_every=1), run_env["bam"],
        outdir=outdir)
    assert _plain(target) == _plain(ref)
    replayed = [s.metrics.counters.get("bucket_replayed", 0) for s in stats.values()
                if hasattr(s, "metrics")]
    assert sum(replayed) == 1


def test_interstage_fallback_reasons_match_the_jax_package(run_env):
    for over in (dict(), dict(checkpoint_every=1), dict(methyl="both"),
                 dict(duplex_passthrough=True)):
        kw = dict(stream_interstage=True, **({} if not over else {"sort_engine": "bucket"}),
                  **over)
        jb = jstages.PipelineBuilder(_cfg(jconfig, run_env, **kw), run_env["bam"])
        pb = pstages.PipelineBuilder(_cfg(pconfig, run_env, **kw), run_env["bam"])
        assert pb._interstage_blocked() == jb._interstage_blocked(), over
