"""The port's transports end to end on the CPU: the molecular and duplex
stages and `run` over transport 'wire', 'auto' and 'unpacked', on both
host engines, against each other and against the JAX package's explicit
transport='wire'.

Tolerance: SHA-equal BAMs (the stage subcommands and callers add no @PG);
`run`'s target and intermediate equal the JAX package's decompressed, @PG
lines aside (tests/test_torch_run.assert_same_bam's rule). Fixture: a
~120-family bisulfite stream_duplex_families mixture of 1 and 2
templates per strand with RTA3 quals and substitutions."""

import gzip
import hashlib
import os
import struct

import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu.io.fasta import FastaFile
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.pipeline import calling as jc
from bsseqconsensusreads_tpu.pipeline import extsort as je
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.utils.testing import stream_duplex_families, write_fasta
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.io.bam import BamReader as PortReader
from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile as PortFasta
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline import extsort as te
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_transport")
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=20_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes))
    read_len = 100
    pool = [bytes(np.random.default_rng(200 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=read_len)) for i in range(16)]
    err_pos = rng.integers(2, read_len - 2, size=4096)
    err_base = rng.integers(0, 4, size=4096)

    def mutate(seq, fam, ti, flag):
        h = (fam * 31 + ti * 7 + flag) & 4095
        i = int(err_pos[h])
        return seq[:i] + "ACGT"[err_base[h]] + seq[i + 1:]

    recs = stream_duplex_families(
        codes, 120, read_len=read_len,
        templates_for=lambda fam: 1 if fam % 10 < 7 else 2,
        qual_for=lambda fam, ti, flag: pool[(fam + ti * 13 + flag) & 15],
        mutate=mutate, bisulfite=True,
    )
    bam = str(tmp / "input" / "sampleW.bam")
    os.makedirs(os.path.dirname(bam))
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(codes))])
    with BamWriter(bam, header) as w:
        w.write_all(recs)
    env = {"tmp": tmp, "fasta": fasta, "bam": bam}
    env["jax_mol"], env["jax_dup"] = _jax_wire_chain(env)
    return env


def _jax_wire_chain(env):
    """The JAX package's stages on its explicit single-device wire."""
    route = dict(mesh=None, transport="wire", emit="python", vote_kernel="xla")
    mol = str(env["tmp"] / "jax_mol.bam")
    with BamReader(env["bam"]) as r:
        batches = jc.call_molecular_batches(
            r, JaxParams(min_reads=1), mode="self", grouping="coordinate", batch_families=32,
            stats=(st := jc.StageStats()), layout="packed", **route,
        )
        je.write_batch_stream(batches, mol, r.header, "self", sort_engine="python")
    assert st.metrics.counters.get("route_batches_wire", 0) > 0
    dup = str(env["tmp"] / "jax_dup.bam")
    with BamReader(mol) as r, FastaFile(env["fasta"]) as fa:
        names = [n for n, _ in r.header.references]
        batches = jc.call_duplex_batches(
            r, fa.fetch, names, JaxParams(min_reads=0), mode="self", grouping="coordinate",
            batch_families=32, refstore=env["fasta"], **route,
        )
        je.write_batch_stream(batches, dup, r.header, "self", sort_engine="python")
    return mol, dup


def _port_molecular(env, transport, engine, layout="packed"):
    stats = tc.StageStats(stage="molecular")
    out = str(env["tmp"] / f"mol_{transport}_{engine}_{layout}.bam")
    with PortReader(env["bam"]) as r:
        src = pstages.molecular_ingest_stream(env["bam"], r, stats, ingest_choice=engine)
        batches = tc.call_molecular_batches(
            src, ConsensusParams(min_reads=1), mode="self", grouping="coordinate",
            batch_families=32, stats=stats, device="cpu", emit=engine, layout=layout,
            transport=transport,
        )
        te.write_batch_stream(batches, out, r.header, "self", sort_engine=engine,
                              metrics=stats.metrics)
    return out, stats


def _port_duplex(env, src_bam, transport, engine, refstore):
    stats = tc.StageStats(stage="duplex")
    out = str(env["tmp"] / f"dup_{transport}_{engine}_{type(refstore).__name__}.bam")
    with PortReader(src_bam) as r, PortFasta(env["fasta"]) as fa:
        names = [n for n, _ in r.header.references]
        src = pstages.duplex_ingest_stream(src_bam, r, stats, ingest_choice=engine)
        batches = tc.call_duplex_batches(
            src, fa.fetch, names, ConsensusParams(min_reads=0), mode="self",
            grouping="coordinate", batch_families=32, stats=stats, device="cpu",
            emit=engine, transport=transport, refstore=refstore,
        )
        te.write_batch_stream(batches, out, r.header, "self", sort_engine=engine,
                              metrics=stats.metrics)
    return out, stats


@pytest.mark.parametrize("engine", ["native", "python"])
def test_both_stages_write_the_jax_wire_bytes_on_every_transport(env, engine):
    mol = {}
    for transport in ("wire", "auto", "unpacked"):
        mol[transport], stats = _port_molecular(env, transport, engine)
        counters = stats.metrics.counters
        if transport == "wire":
            assert counters["route_batches_wire"] > 0 and "route_batches_single" not in counters
            assert counters["wire_qual_q2"] == counters["route_batches_wire"]  # RTA3
        else:  # 'auto' on the CPU is the unpacked route
            assert counters["route_batches_single"] > 0 and "route_batches_wire" not in counters
        assert _sha(mol[transport]) == _sha(env["jax_mol"]), transport
    padded, _s = _port_molecular(env, "wire", engine, layout="padded")
    assert _sha(padded) == _sha(env["jax_mol"])
    d2h = {}
    for transport, refstore in (("wire", env["fasta"]), ("wire", RefStore.from_fasta(env["fasta"])),
                                ("auto", env["fasta"]), ("unpacked", env["fasta"])):
        dup, stats = _port_duplex(env, env["jax_mol"], transport, engine, refstore)
        counters = stats.metrics.counters
        route = "route_batches_wire" if transport == "wire" else "route_batches_single"
        assert counters[route] == stats.batches > 0
        assert _sha(dup) == _sha(env["jax_dup"]), (transport, type(refstore))
        # the genome is loaded (and timed) only when the wire engages
        assert ("genome_load" in stats.metrics.seconds) == (transport == "wire")
        d2h[transport] = counters["d2h_bytes"]
    # one packed array in on the wire; the same output planes back on both
    assert d2h["wire"] == d2h["unpacked"] > 0


def test_transport_resolution_and_refusals(env):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tc._resolve_transport("auto", cpu) == "off"
    assert tc._resolve_transport("auto", cuda) == "wire"
    assert tc._resolve_transport("wire", cpu) == "wire"
    assert tc._resolve_transport("unpacked", cuda) == "off"
    with pytest.raises(ValueError, match="unknown transport 'tunnel'"):
        tc._resolve_transport("tunnel", cpu)
    with PortReader(env["jax_mol"]) as r:
        with pytest.raises(ValueError, match="needs a refstore"):
            next(tc.call_duplex_batches(r, None, ["chr1"], device="cpu", transport="wire"))
        with pytest.raises(ValueError, match="unknown transport"):
            next(tc.call_duplex_batches(r, None, ["chr1"], device="cpu", transport="tunnel"))
        with pytest.raises(ValueError, match="unknown transport"):
            next(tc.call_molecular_batches(r, device="cpu", transport="tunnel"))
    # 'auto' without a refstore takes the unpacked route, as in the JAX package
    dup, stats = _port_duplex(env, env["jax_mol"], "auto", "native", None)
    assert stats.metrics.counters["route_batches_single"] > 0
    assert _sha(dup) == _sha(env["jax_dup"])


def _bam_parts(path: str):
    raw = gzip.open(path).read()
    (l_text,) = struct.unpack_from("<i", raw, 4)
    lines = raw[8:8 + l_text].decode().splitlines()
    return [ln for ln in lines if not ln.startswith("@PG")], raw[8 + l_text:]


def test_run_over_the_wire_writes_the_jax_packages_bytes(env):
    kw = dict(genome_dir=os.path.dirname(env["fasta"]),
              genome_fasta_file_name=os.path.basename(env["fasta"]),
              backend="cpu", transport="wire", batch_families=32)
    jt, _r, _s = jstages.run_pipeline(jconfig.FrameworkConfig(**kw), env["bam"],
                                      outdir=str(env["tmp"] / "jax_run"))
    pt, _r, stats = pstages.run_pipeline(pconfig.FrameworkConfig(**kw), env["bam"],
                                         outdir=str(env["tmp"] / "port_run"))
    assert _bam_parts(pt) == _bam_parts(jt)
    for stage in ("molecular", "duplex"):
        assert stats[stage].metrics.counters["route_batches_wire"] > 0, stage
    inter = "sampleW_consensus_unfiltered_aunamerged_aligned.bam"
    assert _bam_parts(os.path.join(os.path.dirname(pt), inter)) == \
        _bam_parts(os.path.join(os.path.dirname(jt), inter))
    assert _bam_parts(pt)[1] == _bam_parts(env["jax_dup"])[1]


@pytest.mark.parametrize("stage", ["molecular", "duplex"])
def test_cli_transport_wire(env, stage, tmp_path, capsys):
    src = env["bam"] if stage == "molecular" else env["jax_mol"]
    want = env["jax_mol"] if stage == "molecular" else env["jax_dup"]
    out = str(tmp_path / f"{stage}.bam")
    argv = [stage, "-i", src, "-o", out, "--mode", "self", "--batch-families", "32",
            "--device", "cpu", "--transport", "wire"]
    if stage == "duplex":
        argv += ["--reference", env["fasta"]]
    assert cli.main(argv) == 0
    assert '"route_batches_wire"' in capsys.readouterr().err
    assert _sha(out) == _sha(want)
