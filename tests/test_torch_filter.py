"""The port's consensus filter (pipeline.filter), duplex metrics
(pipeline.metrics), scalar oracles (utils.oracle) and duplex passthrough
on the CPU against the JAX package's.

Tolerance: equality. Filtered records (encoded bytes) and FilterStats,
metrics dicts, oracle outputs; the passthrough BAMs decompressed (@PG
aside where the port's `run` writes one). The consensus inputs are
written by the port's own `run` on the CPU from a seeded mixture with
sequencing errors and low quals, so that every drop reason and the base
masks occur."""

import gzip
import json
import os
import types

import numpy as np
import pytest

from bsseqconsensusreads_tpu import cli as jcli
from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.pipeline import calling as jcalling
from bsseqconsensusreads_tpu.pipeline import filter as jfilter
from bsseqconsensusreads_tpu.pipeline import metrics as jmetrics
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.pipeline import workflow as jwf
from bsseqconsensusreads_tpu.utils import oracle as joracle
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.io import bam as pbam
from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling
from bsseqconsensusreads_tpu_torch.pipeline import filter as pfilter
from bsseqconsensusreads_tpu_torch.pipeline import ingest as pingest
from bsseqconsensusreads_tpu_torch.pipeline import metrics as pmetrics
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.pipeline import workflow as pwf
from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
from bsseqconsensusreads_tpu_torch.pipeline.record_ops import coordinate_sort, name_key
from bsseqconsensusreads_tpu_torch.utils import oracle as poracle
from bsseqconsensusreads_tpu_torch.utils.testing import (
    passthrough_leftovers,
    stream_duplex_families,
    write_fasta,
)
from tests.test_torch_run import assert_same_bam
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def consensus(tmp_path_factory):
    """A grouped bisulfite mixture of 60 families (1-4 templates per
    strand, ~2 substitutions per read, quals 2-37), and the port's `run`
    outputs on it: the aligned molecular consensus and the duplex target
    (aligner self), the duplex target without strand tags, the unaligned
    molecular consensus (aligner none)."""
    tmp = tmp_path_factory.mktemp("torch_filter")
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=20_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes))
    read_len = 90
    pool = [bytes(np.random.default_rng(70 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=read_len)) for i in range(16)]
    err_pos = rng.integers(0, read_len, size=512)
    err_base = rng.integers(0, 4, size=512)

    def mutate(seq, fam, ti, flag):
        h = (fam * 31 + ti * 7 + flag) & 511
        for k in (h, (h * 7) & 511):
            i = int(err_pos[k])
            seq = seq[:i] + "ACGT"[err_base[k]] + seq[i + 1:]
        return seq

    bam = str(tmp / "grouped.bam")
    header = pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(codes))])
    with pbam.BamWriter(bam, header) as w:
        for rec in stream_duplex_families(
            codes, 60, read_len=read_len, bisulfite=True, mutate=mutate,
            templates_for=lambda fam: 1 + fam % 4,
            qual_for=lambda fam, ti, flag: pool[(fam + ti * 3 + flag) & 15],
        ):
            w.write(rec)
    kw = dict(genome_dir=str(tmp), genome_fasta_file_name="genome.fa", backend="cpu")
    out = {"tmp": tmp, "fasta": fasta, "bam": bam}
    duplex, _r, _s = pstages.run_pipeline(pconfig.FrameworkConfig(**kw), bam,
                                          outdir=str(tmp / "self"))
    out["duplex"] = duplex
    out["molecular_aligned"] = str(tmp / "self" / "grouped_consensus_unfiltered_aunamerged_aligned.bam")
    nostrand, _r, _s = pstages.run_pipeline(
        pconfig.FrameworkConfig(**kw, duplex_strand_tags=False), bam,
        outdir=str(tmp / "nostrand"))
    out["duplex_nostrand"] = nostrand
    pstages.run_pipeline(pconfig.FrameworkConfig(**kw, aligner="none"), bam,
                         outdir=str(tmp / "none"))
    out["molecular"] = str(tmp / "none" / "grouped_unalignedConsensus_molecular.bam")
    return out


def _records(lib, path, by_name=False):
    with lib.BamReader(path) as r:
        recs = list(r)
    return sorted(recs, key=name_key) if by_name else recs


PARAMS = {
    "defaults": {},
    "min_reads_2": {"min_reads": (2,)},
    "min_reads_3_2_1": {"min_reads": (3, 2, 1)},
    "min_reads_4_2_2": {"min_reads": (4, 2, 2)},
    "read_error_loose": {"max_read_error_rate": 0.2, "max_no_call_fraction": 0.5},
    "base_error_tight": {"max_base_error_rate": 0.02, "max_no_call_fraction": 0.3},
    "base_quality_30": {"min_base_quality": 30, "max_no_call_fraction": 0.6,
                        "max_read_error_rate": 1.0},
    "mean_quality_40": {"min_mean_base_quality": 40.0, "max_read_error_rate": 1.0},
    "single_strand_agreement": {"require_single_strand_agreement": True,
                                "max_no_call_fraction": 0.5, "max_read_error_rate": 1.0},
}


@pytest.mark.parametrize("name", sorted(PARAMS))
@pytest.mark.parametrize("kind", ["molecular", "duplex"])
@pytest.mark.parametrize("engine", ["records", "blobs"])
def test_filter_consensus_equals_the_jax_packages(consensus, engine, kind, name):
    kw = PARAMS[name]
    # template-adjacent input: the unaligned molecular as written, the
    # coordinate-sorted duplex through a name sort (as the self-mode rule)
    by_name = kind == "duplex"
    prec = _records(pbam, consensus[kind], by_name)
    jrec = _records(jbam, consensus[kind], by_name)
    pstats, jstats = pfilter.FilterStats(), jfilter.FilterStats()
    if engine == "records":
        got = [pbam.encode_record(r) for r in pfilter.filter_consensus(
            prec, pfilter.FilterParams(**kw), stats=pstats)]
    else:
        got = list(pfilter.filter_consensus_raw(
            [pbam.encode_record(r) for r in prec], pfilter.FilterParams(**kw), stats=pstats))
    want = [jbam.encode_record(r) for r in jfilter.filter_consensus(
        jrec, jfilter.FilterParams(**kw), stats=jstats)]
    assert got == want
    assert pstats.as_dict() == jstats.as_dict()
    assert pstats.records_in == pstats.kept_records + pstats.dropped_records == len(prec)


def test_filter_matrix_reaches_every_drop_reason_and_masks(consensus):
    seen = {}
    for kind in ("molecular", "duplex"):
        for kw in PARAMS.values():
            stats = pfilter.FilterStats()
            for _ in pfilter.filter_consensus(_records(pbam, consensus[kind], kind == "duplex"),
                                              pfilter.FilterParams(**kw), stats=stats):
                pass
            for k, v in stats.as_dict().items():
                seen[k] = seen.get(k, 0) + v
    for key in ("dropped_depth", "dropped_error_rate", "dropped_mean_quality",
                "dropped_no_call", "masked_bases", "kept_records"):
        assert seen[key] > 0, key


@pytest.mark.parametrize("kw", [{"min_reads": ()}, {"min_reads": (1, 2, 3, 4)},
                                {"min_reads": (1, 2)}, {"bogus": 1}])
def test_filter_params_validation_raises_like_the_jax_packages(kw):
    for mod in (pfilter, jfilter):
        with pytest.raises((ValueError, TypeError)) as exc:
            mod.FilterParams(**kw)
        kind = exc.type
    with pytest.raises(kind):
        pfilter.FilterParams(**kw)


@pytest.mark.parametrize("src", ["duplex", "duplex_nostrand", "molecular"])
def test_probe_strand_tag_support_equals_the_jax_packages(consensus, src):
    path = consensus[src]
    for require in (False, True):
        outcome = []
        for mod in (pfilter, jfilter):
            try:
                mod.probe_strand_tag_support(
                    path, mod.FilterParams(require_single_strand_agreement=require))
                outcome.append("ok")
            except ValueError as exc:
                outcome.append(str(exc))
        assert outcome[0] == outcome[1]
        assert (outcome[0] == "ok") == (not require or src != "duplex_nostrand")


@pytest.mark.parametrize("src", ["grouped", "molecular_aligned"])
def test_duplex_seq_metrics_equal_the_jax_packages(consensus, src):
    path = consensus["bam"] if src == "grouped" else consensus[src]
    with jbam.BamReader(path) as r:
        want = jmetrics.duplex_seq_metrics(r).as_dict()
    with pbam.BamReader(path) as r:
        python = pmetrics.duplex_seq_metrics(r).as_dict()
    columnar = pmetrics.duplex_seq_metrics(pingest.columnar_records(path)).as_dict()
    assert columnar == python == want
    assert want["molecules"] == 60 and want["duplexes"] == 60


def test_filter_consensus_subcommand_equals_the_jax_cli(consensus, tmp_path, capsys):
    argv = ["filter-consensus", "-i", consensus["duplex"], "-M", "3", "2", "1",
            "-e", "0.05", "-n", "0.3", "-s"]
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        out = str(tmp_path / f"{name}.bam")
        assert main(argv + ["-o", out]) == 0
        doc = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        outs[name] = (gzip.open(out).read(), doc)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["kept_records"] > 0
    with pytest.raises(ValueError, match="ac/bc"):
        cli.main(["filter-consensus", "-i", consensus["duplex_nostrand"], "-o",
                  str(tmp_path / "x.bam"), "-s"])


def test_filter_consensus_subcommand_equals_the_jax_cli_on_non_canonical_input(
        consensus, tmp_path, capsys):
    """A BAM the codec does not round-trip: stale bins, quals whose first
    byte is 0xFF with the rest kept. The JAX CLI decodes and encodes
    every record; the port's must write the same bytes."""
    src = str(tmp_path / "foreign.bam")
    with pbam.BamReader(consensus["duplex"]) as r:
        header, blobs = r.header, list(r.raw_records())
    patched = []
    for i, blob in enumerate(blobs):
        out = bytearray(blob)
        if i % 5 == 0:
            out[14:16] = (4681).to_bytes(2, "little")
        if i % 7 == 0:
            l_seq = int.from_bytes(out[20:24], "little")
            qual_off = 36 + out[12] + 4 * int.from_bytes(out[16:18], "little") + (l_seq + 1) // 2
            out[qual_off] = 0xFF
        patched.append(bytes(out))
    with pbam.BamWriter(src, header) as w:
        w.write_raw_many(patched)
    as_is = list(pfilter.filter_consensus_raw(patched))
    assert as_is != [pbam.encode_record(pbam.decode_record(b[4:])) for b in as_is]
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        out = str(tmp_path / f"{name}.bam")
        assert main(["filter-consensus", "-i", src, "-o", out, "-M", "3", "2", "1"]) == 0
        doc = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        outs[name] = (gzip.open(out).read(), doc)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1]["kept_records"] > 0


def test_oracles_equal_the_jax_packages():
    rng = np.random.default_rng(9)
    params = ConsensusParams(min_reads=1)
    for _ in range(30):
        w, t = int(rng.integers(1, 12)), int(rng.integers(1, 4))
        bases = rng.integers(0, 5, size=(t, 2, w)).tolist()
        quals = rng.integers(0, 45, size=(t, 2, w)).tolist()
        assert poracle.oracle_overlap_cocall(bases, quals) == \
            joracle.oracle_overlap_cocall(bases, quals)
        assert poracle.oracle_molecular_family(bases, quals, params) == \
            joracle.oracle_molecular_family(bases, quals, params)
        col_b, col_q = bases[0][0], quals[0][0]
        for pre, post, mi, mc in ((45.0, 30.0, 0, 0), (30.0, 20.0, 10, 30)):
            assert poracle.oracle_column_vote(col_b, col_q, pre, post, mi, mc) == \
                joracle.oracle_column_vote(col_b, col_q, pre, post, mi, mc)
        genome = "".join("ACGTacgtN"[i] for i in rng.integers(0, 9, size=60))
        seq = "".join("ACGTN"[i] for i in rng.integers(0, 5, size=w))
        pos = int(rng.integers(0, 40))
        for pos0 in ("skip", "shift"):
            assert poracle.oracle_convert_read(seq, quals[0][0], pos, genome, pos0) == \
                joracle.oracle_convert_read(seq, quals[0][0], pos, genome, pos0)
        reads = {f: {"seq": seq, "qual": quals[0][0], "pos": pos, "la": int(f % 2),
                     "rd": int(f > 100)} for f in (99, 163, 83, 147)}
        assert poracle.oracle_extend_group(reads) == joracle.oracle_extend_group(reads)


# ---------------------------------------------------------------- passthrough


@pytest.fixture(scope="module")
def leftover_bam(consensus):
    """The aligned molecular consensus with passthrough_leftovers appended,
    coordinate-sorted (the duplex stage's 'coordinate' grouping input)."""
    recs = _records(pbam, consensus["molecular_aligned"])
    extra = passthrough_leftovers(recs)
    assert len(extra) == 6
    path = str(consensus["tmp"] / "leftovers.bam")
    with pbam.BamReader(consensus["molecular_aligned"]) as r:
        # the @PG of the port's run set aside: the stage adds its own
        text = "".join(ln + "\n" for ln in r.header.text.splitlines() if not ln.startswith("@PG"))
        header = pbam.BamHeader(text, r.header.references)
    with pbam.BamWriter(path, header) as w:
        w.write_all(coordinate_sort(recs + extra))
    return path


# The JAX package's duplex stage on the CPU is not deterministic across
# several batches of this fixture (at 16 families per batch one family's
# B strand now and then leaves unconverted; ROADMAP queue 3), so the JAX
# package is run in one batch and the port's multi-batch runs are held to
# its coordinate-sorted bytes.


@pytest.mark.parametrize("mode", ["self", "unaligned"])
@pytest.mark.parametrize("emit", ["native", "python"])
def test_duplex_passthrough_equals_the_jax_packages(consensus, leftover_bam, emit, mode,
                                                    tmp_path, capsys):
    argv = ["duplex", "-i", leftover_bam, "--reference", consensus["fasta"], "--mode", mode,
            "--passthrough", "--emit", emit]
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jcli.main, [])):
        out = str(tmp_path / f"{name}.bam")
        assert main(argv + extra + ["-o", out]) == 0
        doc = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        outs[name] = (gzip.open(out).read(), doc)
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1]["leftover_records"] == outs["jax"][1]["leftover_records"] == 5
    with pbam.BamReader(str(tmp_path / "port.bam")) as r:
        names = {rec.qname for rec in r}
    kinds = {q.rsplit(":", 1)[1] for q in names if q.endswith(
        ("flag0", "flag1", "dup83", "softclip163", "indel83", "hardclip163"))}
    assert kinds == {"flag0", "flag1", "dup83", "softclip163"}


def test_passthrough_batches_carry_the_block_then_the_records(consensus, leftover_bam):
    """On the native emit a batch with passthrough is [RawRecords] +
    BamRecords; both sorts and the writer take the mix, and 16 families
    per batch write the one-batch run's bytes."""
    runs = {}
    for families in (16, 512):
        with FastaFile(consensus["fasta"]) as fa, pbam.BamReader(leftover_bam) as r:
            names = [n for n, _ in r.header.references]
            header = r.header
            runs[families] = list(pcalling.call_duplex_batches(
                r, fa.fetch, names, mode="self", batch_families=families,
                grouping="coordinate", device="cpu", emit="native", passthrough=True,
            ))
    batches = runs[16]
    mixed = [b for b in batches if len(b) > 1]
    assert len(batches) > 2 and mixed
    assert all(isinstance(b[0], pbam.RawRecords) for b in mixed)
    assert all(isinstance(x, pbam.BamRecord) for b in mixed for x in b[1:])
    outs = []
    for families, engine in ((512, "native"), (16, "native"), (16, "python")):
        out = str(consensus["tmp"] / f"mix_{families}_{engine}.bam")
        write_batch_stream(iter(runs[families]), out, header, "self", sort_engine=engine)
        outs.append(gzip.open(out).read())
    assert outs[1] == outs[2] == outs[0]


@pytest.mark.parametrize("sort_engine", ["native", "python"])
def test_checkpointed_passthrough_stage_equals_the_jax_packages(consensus, leftover_bam,
                                                                 tmp_path, sort_engine):
    """The duplex rule with passthrough, 16 families per batch, straight
    and through the checkpoint's shards (one batch each) and finalize,
    under both sorts: the JAX package's one-batch bytes."""
    kw = dict(genome_dir=os.path.dirname(consensus["fasta"]),
              genome_fasta_file_name="genome.fa", backend="cpu", duplex_passthrough=True,
              sort_engine=sort_engine)
    outs = {}
    for name, cfg_mod, stages, families, every in (("jax", jconfig, jstages, 512, 0),
                                                   ("port", pconfig, pstages, 16, 0),
                                                   ("port_ck", pconfig, pstages, 16, 1)):
        cfg = cfg_mod.FrameworkConfig(**kw, batch_families=families, checkpoint_every=every)
        builder = stages.PipelineBuilder(cfg, leftover_bam, outdir=str(tmp_path))
        out = str(tmp_path / f"{name}.bam")
        builder.run_duplex(types.SimpleNamespace(name="call_duplex_tpu", inputs=[leftover_bam],
                                                 outputs=[out]), mode="self")
        outs[name] = (out, builder.stats["duplex"])
    assert_same_bam(outs["port"][0], outs["jax"][0])
    assert gzip.open(outs["port_ck"][0]).read() == gzip.open(outs["port"][0]).read()
    assert outs["port_ck"][1].batches > 2


def test_passthrough_refusals_match_the_jax_packages(consensus, leftover_bam, tmp_path):
    for calling, lib in ((pcalling, pbam), (jcalling, jbam)):
        kw = {"device": "cpu"} if calling is pcalling else {}
        with lib.BamReader(leftover_bam) as r:
            with pytest.raises(ValueError, match="chemistry='none' is incompatible with "
                                                 "passthrough"):
                next(calling.call_duplex_batches(r, None, [], chemistry="none",
                                                 passthrough=True, **kw))
    base = ["duplex", "-i", leftover_bam, "--reference", consensus["fasta"], "--passthrough",
            "--ingest", "native", "-o", str(tmp_path / "x.bam")]
    for main, extra, err in ((cli.main, ["--device", "cpu"], pwf.WorkflowError),
                             (jcli.main, [], jwf.WorkflowError)):
        with pytest.raises(err, match="passthrough needs full-tag Python records"):
            main(base + extra)
    kw = dict(genome_dir=os.path.dirname(consensus["fasta"]),
              genome_fasta_file_name="genome.fa", backend="cpu", duplex_passthrough=True,
              filter={"min_reads": 1})
    for cfg_mod, stages, err in ((pconfig, pstages, pwf.WorkflowError),
                                 (jconfig, jstages, jwf.WorkflowError)):
        builder = stages.PipelineBuilder(cfg_mod.FrameworkConfig(**kw), consensus["bam"],
                                         outdir=str(tmp_path))
        with pytest.raises(err, match="filter \\+ duplex_passthrough"):
            builder.build()
