"""The port's molecular -> duplex chain on the CPU against the JAX package's
(call_molecular_batches / call_duplex_batches + write_batch_stream on its
single-device plain-tensor route, XLA vote): the BAMs must be SHA-equal.

Fixtures: the tests/test_pipeline.py pipeline_env recipe, and a
~200-family bisulfite stream_duplex_families mixture of 1 and 2 templates
per strand with RTA3-binned quals and substitutions."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu.io.fasta import FastaFile
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu.pipeline import calling as jc
from bsseqconsensusreads_tpu.pipeline import extsort as je
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    stream_duplex_families,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch.io.bam import BamReader as PortReader
from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile as PortFasta
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline import extsort as te
from bsseqconsensusreads_tpu_torch.pipeline import stages
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTE = dict(mesh=None, transport="unpacked", layout="packed", emit="python",
             vote_kernel="xla")


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def grouped_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipe")
    rng = np.random.default_rng(31)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(
        rng, name, genome, n_families=12, error_rate=0.01
    )
    bam = str(tmp / "grouped.bam")
    with BamWriter(bam, header) as w:
        w.write_all(records)
    return {"tmp": tmp, "fasta": fasta, "bam": bam}


@pytest.fixture(scope="module")
def mixture_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mix")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=30_000).astype(np.int8)
    genome = codes_to_seq(codes)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", genome)
    read_len = 100
    pool = [bytes(np.random.default_rng(100 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=read_len)) for i in range(16)]
    err_pos = rng.integers(2, read_len - 2, size=4096)
    err_base = rng.integers(0, 4, size=4096)

    def mutate(seq, fam, ti, flag):
        h = (fam * 31 + ti * 7 + flag) & 4095
        for k in (h, (h * 2654435761) & 4095):
            i = int(err_pos[k])
            seq = seq[:i] + "ACGT"[err_base[k]] + seq[i + 1:]
        return seq

    recs = stream_duplex_families(
        codes, 200, read_len=read_len,
        templates_for=lambda fam: 1 if fam % 10 < 7 else 2,
        qual_for=lambda fam, ti, flag: pool[(fam + ti * 13 + flag) & 15],
        mutate=mutate, bisulfite=True,
    )
    bam = str(tmp / "grouped.bam")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(genome))])
    with BamWriter(bam, header) as w:
        w.write_all(recs)
    return {"tmp": tmp, "fasta": fasta, "bam": bam}


def _jax_chain(env, mode, tag):
    mol = str(env["tmp"] / f"jax_mol_{tag}.bam")
    with BamReader(env["bam"]) as r:
        batches = jc.call_molecular_batches(
            r, JaxParams(min_reads=1), mode=mode, grouping="coordinate", **ROUTE
        )
        je.write_batch_stream(batches, mol, r.header, mode, sort_engine="python")
    if mode != "self":
        return mol, None
    dup = str(env["tmp"] / f"jax_dup_{tag}.bam")
    with BamReader(mol) as r, FastaFile(env["fasta"]) as fa:
        names = [n for n, _ in r.header.references]
        batches = jc.call_duplex_batches(
            r, fa.fetch, names, JaxParams(min_reads=0), mode="self",
            grouping="coordinate", **ROUTE
        )
        je.write_batch_stream(batches, dup, r.header, "self", sort_engine="python")
    return mol, dup


def _port_chain(env, mode, tag, layout="packed", stats=None, engine=None):
    """The port's chain on the CPU. engine None: records from the
    BamReader, the Python emit and the default sort; 'native' or 'python':
    every host engine (ingest, emit, sort) by that name."""
    ingest = {} if engine is None else {"ingest_choice": engine}
    host = {} if engine is None else {"emit": engine}
    sort = {} if engine is None else {"sort_engine": engine}
    stats = stats if stats is not None else tc.StageStats()
    mol = str(env["tmp"] / f"port_mol_{tag}.bam")
    with PortReader(env["bam"]) as r:
        src = r if engine is None else stages.molecular_ingest_stream(
            env["bam"], r, stats, **ingest)
        batches = tc.call_molecular_batches(
            src, ConsensusParams(min_reads=1), mode=mode, grouping="coordinate",
            layout=layout, stats=stats, device="cpu", **host,
        )
        te.write_batch_stream(batches, mol, r.header, mode, metrics=stats.metrics, **sort)
    if mode != "self":
        return mol, None
    dup = str(env["tmp"] / f"port_dup_{tag}.bam")
    dstats = tc.StageStats()
    with PortReader(mol) as r, PortFasta(env["fasta"]) as fa:
        names = [n for n, _ in r.header.references]
        src = r if engine is None else stages.duplex_ingest_stream(mol, r, dstats, **ingest)
        batches = tc.call_duplex_batches(
            src, fa.fetch, names, ConsensusParams(min_reads=0), mode="self",
            grouping="coordinate", stats=dstats, device="cpu", **host,
        )
        te.write_batch_stream(batches, dup, r.header, "self", metrics=dstats.metrics, **sort)
    return mol, dup


def _jax_native_chain(env, mode, tag):
    """The JAX package's chain with its native host engines: columnar
    ingest with C grouping and encode scan, the C batch emit, the native
    sort."""
    route = {**ROUTE, "emit": "native"}
    mol = str(env["tmp"] / f"jaxnat_mol_{tag}.bam")
    with BamReader(env["bam"]) as r:
        src = jstages.molecular_ingest_stream(env["bam"], r, jc.StageStats(),
                                              ingest_choice="native")
        batches = jc.call_molecular_batches(
            src, JaxParams(min_reads=1), mode=mode, grouping="coordinate", **route)
        je.write_batch_stream(batches, mol, r.header, mode, sort_engine="native")
    if mode != "self":
        return mol, None
    dup = str(env["tmp"] / f"jaxnat_dup_{tag}.bam")
    with BamReader(mol) as r, FastaFile(env["fasta"]) as fa:
        names = [n for n, _ in r.header.references]
        src = jstages.duplex_ingest_stream(mol, r, jc.StageStats(), ingest_choice="native")
        batches = jc.call_duplex_batches(
            src, fa.fetch, names, JaxParams(min_reads=0), mode="self",
            grouping="coordinate", **route)
        je.write_batch_stream(batches, dup, r.header, "self", sort_engine="native")
    return mol, dup


@pytest.mark.parametrize("fixture,mode", [
    ("grouped_env", "self"), ("mixture_env", "self"),
    ("grouped_env", "unaligned"), ("mixture_env", "unaligned"),
])
def test_native_and_python_engines_and_the_jax_native_chain_are_sha_equal(
        fixture, mode, request):
    env = request.getfixturevalue(fixture)
    stats = tc.StageStats()
    nat = _port_chain(env, mode, f"eng_nat_{mode}", stats=stats, engine="native")
    py = _port_chain(env, mode, f"eng_py_{mode}", engine="python")
    jax_nat = _jax_native_chain(env, mode, mode)
    for a, b, c in zip(nat, py, jax_nat):
        if a is not None:
            assert _sha(a) == _sha(b) == _sha(c)
    assert stats.metrics.counters["ingest_native"] == 1
    assert stats.metrics.counters["group_native"] == 1
    assert stats.metrics.seconds["emit.pack"] > 0 and stats.metrics.seconds["sort_write"] > 0


@pytest.mark.parametrize("fixture", ["grouped_env", "mixture_env"])
def test_self_chain_is_sha_equal_to_the_jax_package(fixture, request):
    env = request.getfixturevalue(fixture)
    jmol, jdup = _jax_chain(env, "self", "self")
    pmol, pdup = _port_chain(env, "self", "self")
    assert _sha(pmol) == _sha(jmol)
    assert _sha(pdup) == _sha(jdup)
    with PortReader(pdup) as r:
        recs = list(r)
    assert recs and all(rec.has_tag("ac") and rec.has_tag("cd") for rec in recs)


def test_unaligned_molecular_stage_is_sha_equal_to_the_jax_package(grouped_env):
    jmol, _ = _jax_chain(grouped_env, "unaligned", "unal")
    pmol, _ = _port_chain(grouped_env, "unaligned", "unal")
    assert _sha(pmol) == _sha(jmol)


def test_padded_molecular_layout_writes_the_same_bytes(mixture_env):
    pmol, _ = _port_chain(mixture_env, "self", "packed")
    qmol, _ = _port_chain(mixture_env, "self", "padded", layout="padded")
    assert _sha(pmol) == _sha(qmol)


def _molecular_deep(env, tag, deep_threshold, engine=None, mode="self"):
    """The molecular stage of both packages at a lowered deep_threshold:
    (JAX BAM, JAX stats, port BAM, port stats). The port runs `engine`'s
    ingest and emit (None: BamReader records, Python emit)."""
    jmol = str(env["tmp"] / f"jax_deep_{tag}.bam")
    jstats = jc.StageStats()
    with BamReader(env["bam"]) as r:
        batches = jc.call_molecular_batches(
            r, JaxParams(min_reads=1), mode=mode, grouping="coordinate", stats=jstats,
            deep_threshold=deep_threshold, **ROUTE,
        )
        je.write_batch_stream(batches, jmol, r.header, mode, sort_engine="python")
    pmol = str(env["tmp"] / f"port_deep_{tag}.bam")
    pstats = tc.StageStats()
    with PortReader(env["bam"]) as r:
        src = r if engine is None else stages.molecular_ingest_stream(
            env["bam"], r, pstats, ingest_choice=engine)
        batches = tc.call_molecular_batches(
            src, ConsensusParams(min_reads=1), mode=mode, grouping="coordinate",
            stats=pstats, device="cpu", deep_threshold=deep_threshold,
            **({} if engine is None else {"emit": engine}),
        )
        te.write_batch_stream(batches, pmol, r.header, mode, metrics=pstats.metrics,
                              **({} if engine is None else {"sort_engine": engine}))
    return jmol, jstats, pmol, pstats


@pytest.mark.parametrize("fixture,threshold", [
    ("grouped_env", 2), ("grouped_env", 3), ("mixture_env", 1)])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_deep_families_route_as_the_jax_package_routes_them(fixture, threshold, engine,
                                                           request):
    """Families above deep_threshold vote on the padded deep route; the
    BAM is the JAX package's, and — the deep route being the same vote —
    the BAM of the default threshold, where no family is deep."""
    env = request.getfixturevalue(fixture)
    tag = f"{fixture}_{threshold}_{engine}"
    jmol, jstats, pmol, pstats = _molecular_deep(env, tag, threshold, engine)
    routed = pstats.metrics.counters.get("deep_routed_families", 0)
    assert routed > 0
    assert routed == jstats.metrics.counters["deep_routed_families"]
    assert pstats.metrics.counters["deep_skipped_families"] == 0
    assert pstats.skipped_families == jstats.skipped_families == 0
    assert pstats.families == jstats.families and pstats.consensus_out > 0
    assert _sha(pmol) == _sha(jmol)
    normal, _ = _port_chain(env, "self", f"deep_ref_{tag}", engine=engine)
    assert _sha(pmol) == _sha(normal)


def test_unaligned_deep_records_follow_their_batch_as_in_the_jax_package(grouped_env):
    # unaligned output is not sorted: the deep records' place in the
    # stream is the JAX package's (after their chunk's normal batch)
    jmol, _js, pmol, pstats = _molecular_deep(grouped_env, "unaligned", 2, mode="unaligned")
    assert pstats.metrics.counters["deep_routed_families"] > 0
    assert _sha(pmol) == _sha(jmol)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_families_past_the_deep_cap_are_skipped_and_counted_as_in_the_jax_package(
        grouped_env, monkeypatch, engine):
    # the cap lowered on both sides: families deeper than it are skipped
    # (and counted) by both packages alike; the rest vote on the deep route
    monkeypatch.setattr(jc, "DEEP_TEMPLATE_CAP", 3)
    monkeypatch.setattr(tc, "DEEP_TEMPLATE_CAP", 3)
    jmol, jstats, pmol, pstats = _molecular_deep(grouped_env, f"cap_{engine}", 1, engine)
    counters = pstats.metrics.counters
    assert counters["deep_routed_families"] == jstats.metrics.counters["deep_routed_families"]
    assert 0 < counters["deep_skipped_families"] < counters["deep_routed_families"]
    assert pstats.skipped_families == jstats.skipped_families == counters["deep_skipped_families"]
    assert pstats.families == jstats.families
    assert _sha(pmol) == _sha(jmol)


def test_deep_buckets_share_dispatches_up_to_the_cap():
    deep = [(f"g{i}", d) for i, d in enumerate([4097, 5000, 4500, 16384, 5100, 700, 4200])]
    groups = list(tc._bucket_deep(deep))
    # bucket 5120 holds 3 families per dispatch (3 * 5120 <= 16,384), the
    # cap bucket one, and buckets yield in first-appearance order
    assert groups == [["g0", "g1", "g2"], ["g4", "g6"], ["g3"], ["g5"]]
    assert list(tc._bucket_deep(deep)) == list(jc._bucket_deep(deep))


def test_entry_points_do_not_fall_back_to_the_cpu(grouped_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with PortReader(grouped_env["bam"]) as r, pytest.raises(RuntimeError, match="CUDA"):
        next(tc.call_molecular_batches(r, ConsensusParams()))


def test_cli_duplex_on_the_cpu_matches_the_library_chain(mixture_env):
    tmp = mixture_env["tmp"]
    _pmol, pdup = _port_chain(mixture_env, "self", "cli_ref")
    mol = str(tmp / "cli_mol.bam")
    dup = str(tmp / "cli_dup.bam")
    env = {**os.environ, "PYTHONPATH": REPO}
    for argv in (
        ["molecular", "-i", mixture_env["bam"], "-o", mol, "--mode", "self"],
        ["duplex", "-i", mol, "-o", dup, "--mode", "self",
         "--reference", mixture_env["fasta"]],
    ):
        out = subprocess.run(
            [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", *argv,
             "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, text=True,
        )
        assert out.returncode == 0, out.stderr
    assert _sha(dup) == _sha(pdup)
