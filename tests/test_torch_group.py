"""The port's UMI grouping (pipeline.group_umi, the io.bam tag walkers)
and the raw-BAM entry of `run` on the CPU against the JAX package's.

Tolerance: byte equality. Grouped blobs, GroupStats (wall seconds aside),
cluster maps and tag offsets must equal the JAX package's; the pipeline's
BAMs are compared decompressed, @PG lines aside (tests/test_torch_run.py
assert_same_bam); the CLI's outputs decompressed and its stderr JSON.
Inputs: raw aligned duplex templates (RX only, B strands with swapped
halves) made from a seed with numpy, with UMI errors and shared
positions so that every clustering strategy has neighbours to merge."""

import gzip
import json
import os

import numpy as np
import pytest

from bsseqconsensusreads_tpu import cli as jcli
from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.pipeline import group_umi as jgroup
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.io import bam as pbam
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu_torch.pipeline import group_umi as pgroup
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.utils.testing import (
    bisulfite_convert,
    stream_duplex_families,
    write_fasta,
)
from tests.test_torch_run import assert_same_bam
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


ACGT = "ACGT"


def _umi(rng, k: int = 6) -> str:
    return "".join(ACGT[i] for i in rng.integers(0, 4, size=k))


def _mutate_umi(rng, umi: str, n: int) -> str:
    s = list(umi)
    for i in rng.choice(len(s), size=n, replace=False):
        s[i] = ACGT[(ACGT.index(s[i]) + 1 + int(rng.integers(0, 3))) % 4]
    return "".join(s)


def raw_blobs(seed: int = 7, n_families: int = 24, read_len: int = 40):
    """Encoded raw duplex records (port codec), in coordinate order: each
    family's A/B templates carry RX 'a-b' / 'b-a', some templates with
    one or two UMI errors, families sharing a start three by three (so a
    position bucket holds several UMIs), some softclipped or reversed R1s,
    and a few unmapped, low-mapq, secondary and single-end records."""
    rng = np.random.default_rng(seed)
    genome = "".join(ACGT[i] for i in rng.integers(0, 4, size=4000))
    recs = []
    for fam in range(n_families):
        start = 50 + 97 * (fam // 3)
        frag = read_len + 20 + 3 * (fam // 3)
        r2 = start + frag - read_len
        u1, u2 = _umi(rng), _umi(rng)
        for strand in "AB":
            lf, rf = (99, 147) if strand == "A" else (163, 83)
            for t in range(int(rng.integers(1, 5))):
                err = int(rng.choice([0, 0, 0, 1, 2]))
                a, b = (u1, u2) if strand == "A" else (u2, u1)
                rx = f"{_mutate_umi(rng, a, err)}-{b}" if err else f"{a}-{b}"
                qname = f"q{fam}{strand}{t}"
                for flag, pos, mate, tl in ((lf, start, r2, frag), (rf, r2, start, -frag)):
                    seq = bisulfite_convert(genome[pos:pos + read_len], genome, pos, strand)
                    cigar = [(pbam.CMATCH, read_len)]
                    if t == 2 and flag in (99, 163):
                        cigar = [(pbam.CSOFT_CLIP, 3), (pbam.CMATCH, read_len - 3)]
                    rec = pbam.BamRecord(
                        qname=qname, flag=flag, ref_id=0,
                        pos=pos + (3 if len(cigar) == 2 else 0), mapq=60, cigar=cigar,
                        next_ref_id=0, next_pos=mate, tlen=tl, seq=seq,
                        qual=bytes(rng.integers(2, 41, size=read_len).astype(np.uint8)),
                    )
                    rec.set_tag("RX", rx, "Z")
                    recs.append(rec)
    odd = [r.copy() for r in recs[:4] + recs[:2] + recs[:2]]
    odd[0].flag |= 0x100                       # secondary
    odd[1].qname, odd[1].flag = "unmapped", 0x4 | 0x1 | 0x40
    odd[2].qname, odd[2].mapq = "lowq", 0     # a lone record, low mapq
    odd[3].qname, odd[3].flag = "single", 0    # single-end
    for rec in odd[4:6]:                       # a template without RX
        rec.qname = "noumi"
        del rec.tags["RX"]
    for rec in odd[6:8]:                       # a template with an N in its UMI
        rec.qname, rec.tags["RX"] = "numi", ("Z", "ACNTGA-ACGTAC")
    recs += odd
    recs.sort(key=lambda r: (r.ref_id, r.pos, r.qname))
    header = pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(genome))])
    return header, [pbam.encode_record(r) for r in recs]


def _jheader(header):
    return jbam.BamHeader(header.text, list(header.references))


def _group_both(blobs, header, **kw):
    pstats, jstats = pgroup.GroupStats(), jgroup.GroupStats()
    got = list(pgroup.group_reads_by_umi_raw(list(blobs), header, stats=pstats, **kw))
    want = list(jgroup.group_reads_by_umi_raw(list(blobs), _jheader(header), stats=jstats,
                                              **kw))
    strip = lambda s: {k: v for k, v in s.as_dict().items() if k != "wall_seconds"}  # noqa: E731
    return got, want, strip(pstats), strip(jstats)


@pytest.mark.parametrize("edits", [0, 1, 2])
@pytest.mark.parametrize("strategy", ["identity", "edit", "adjacency", "paired"])
def test_grouped_blobs_and_stats_equal_the_jax_packages(strategy, edits, tmp_path):
    header, blobs = raw_blobs()
    # 17 records per run: both external passes spill several runs
    got, want, ps, js = _group_both(blobs, header, strategy=strategy, edits=edits,
                                    workdir=str(tmp_path), buffer_records=17)
    assert got == want
    assert ps == js
    assert ps["molecules"] > 0 and ps["accepted"] > 0
    assert os.listdir(tmp_path) == []  # spill runs cleaned up
    in_memory, _w, ps2, _j = _group_both(blobs, header, strategy=strategy, edits=edits)
    assert in_memory == got and ps2 == ps


def test_grouping_merges_umi_errors_and_reunites_strands():
    header, blobs = raw_blobs()
    got, _want, stats, _js = _group_both(blobs, header, strategy="paired", edits=2)
    exact = _group_both(blobs, header, strategy="paired", edits=0)[2]
    assert exact["molecules"] > stats["molecules"]  # erroneous UMIs were absorbed
    assert stats["dropped_secondary"] == 1 and stats["dropped_n_umi"] == 1
    assert stats["dropped_no_umi"] == 1 and stats["dropped_unpaired"] >= 1
    mis = {}
    for blob in got:
        rec = pbam.decode_record(blob[4:])
        mis.setdefault(str(rec.get_tag("MI")).split("/")[0], set()).add(
            str(rec.get_tag("MI")).split("/")[1])
    assert any(s == {"A", "B"} for s in mis.values())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cluster_umis_equal_the_jax_packages_on_random_count_tables(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        k = int(rng.integers(3, 6))
        umis = {"".join(ACGT[i] for i in rng.integers(0, 3, size=k))
                for _ in range(int(rng.integers(1, 30)))}
        counts = {u: int(rng.integers(1, 12)) for u in sorted(umis)}
        for strategy in pgroup.STRATEGIES:
            for edits in (0, 1, 2):
                assert pgroup.cluster_umis(counts, strategy, edits) == \
                    jgroup.cluster_umis(counts, strategy, edits)


TAG_VALUES = {
    "A": lambda rng: ("A", "QZ"[int(rng.integers(0, 2))]),
    "c": lambda rng: ("c", int(rng.integers(-128, 128))),
    "C": lambda rng: ("C", int(rng.integers(0, 256))),
    "s": lambda rng: ("s", int(rng.integers(-32768, 32768))),
    "S": lambda rng: ("S", int(rng.integers(0, 65536))),
    "i": lambda rng: ("i", int(rng.integers(-2**31, 2**31))),
    "I": lambda rng: ("I", int(rng.integers(0, 2**32))),
    "f": lambda rng: ("f", float(rng.random())),
    "Z": lambda rng: ("Z", _umi(rng, int(rng.integers(0, 9)))),
    "H": lambda rng: ("H", "DEADBEEF"[: 2 * int(rng.integers(0, 5))]),
    "B": lambda rng: ("B", ("cCsSiIf"[int(rng.integers(0, 7))],
                            [int(v) for v in rng.integers(0, 100, size=int(rng.integers(0, 6)))])),
}


@pytest.mark.parametrize("seed", [4, 5])
def test_skip_tag_and_tag_region_offset_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    for i in range(40):
        n = int(rng.integers(1, 60))
        rec = pbam.BamRecord(
            qname="r" * int(rng.integers(1, 20)), flag=99, ref_id=0, pos=5, mapq=60,
            cigar=[(pbam.CMATCH, n)] if i % 3 or n < 2 else
            [(pbam.CSOFT_CLIP, 1), (pbam.CMATCH, n - 1)],
            seq="".join(ACGT[j] for j in rng.integers(0, 4, size=n)), qual=bytes([30] * n),
        )
        types = list(TAG_VALUES) * 2
        rng.shuffle(types)
        for j, tc in enumerate(types[: int(rng.integers(1, len(types)))]):
            rec.tags[f"x{j % 10}" if j < 10 else f"y{j % 10}"] = TAG_VALUES[tc](rng)
        blob = pbam.encode_record(rec)
        assert blob == jbam.encode_record(jbam.decode_record(blob[4:]))
        off = pbam.tag_region_offset(blob)
        assert off == jbam.tag_region_offset(blob)
        walked = []
        while off < len(blob):
            nxt = pbam.skip_tag(blob, off)
            assert nxt == jbam.skip_tag(blob, off)
            walked.append(blob[off:off + 2].decode())
            off = nxt
        assert off == len(blob) and walked == list(rec.tags)


def _raw_record(lib, rng, mi_tags=()):
    rec = lib.BamRecord(qname="t0", flag=99, ref_id=0, pos=100, mapq=60,
                        cigar=[(lib.CMATCH, 30)], next_ref_id=0, next_pos=150, tlen=80,
                        seq="ACGT" * 7 + "AC", qual=bytes([30] * 30))
    rec.set_tag("RX", "AAAAAA-CCCCCC", "Z")
    rec.set_tag("xi", 7, "i")
    rec.set_tag("xs", 3, "s")
    rec.set_tag("xA", "Q", "A")
    rec.set_tag("xB", ("S", [1, 2, 3]), "B")
    rec.set_tag("xH", "DEADBEEF", "H")
    for i, mi in enumerate(mi_tags):
        if i == 0:
            rec.set_tag("MI", mi, "Z")
    return rec


@pytest.mark.parametrize("n_mi", [0, 1, 2])
def test_patch_mi_splices_the_jax_packages_bytes(n_mi):
    """MI-less records, records with one MI and a malformed record with
    two: the splice leaves exactly the new MI, at the tag tail."""
    import struct

    rng = np.random.default_rng(0)
    rec = _raw_record(pbam, rng, ["old/B", "dup2"][:n_mi])
    blob = pbam.encode_record(rec)
    if n_mi == 2:
        body = blob[4:] + b"MIZdup2\x00"
        blob = struct.pack("<i", len(body)) + body
    got = pgroup._patch_mi(blob, "42/A")
    assert got == jgroup._patch_mi(blob, "42/A")
    assert got.count(b"MIZ") == 1 and got.endswith(b"MIZ42/A\x00")
    if n_mi == 0:
        want = rec.copy()
        want.set_tag("MI", "42/A", "Z")
        assert got == pbam.encode_record(want)


def test_error_cases_raise_the_jax_packages_exception_types():
    # the envelope: a > 4 kb leading clip
    for lib, grp in ((pbam, pgroup), (jbam, jgroup)):
        rec = lib.BamRecord(qname="longclip", flag=0, ref_id=0, pos=10, mapq=60,
                            seq="A" * 5000, qual=b"\x1e" * 5000,
                            cigar=[(lib.CSOFT_CLIP, 4999), (lib.CMATCH, 1)])
        with pytest.raises(ValueError, match="envelope"):
            grp._position_key([rec])
    header, blobs = raw_blobs(n_families=3)

    def with_rx(fn):
        out = []
        for blob in blobs:
            rec = pbam.decode_record(blob[4:])
            if "RX" in rec.tags:
                rec.tags["RX"] = ("Z", fn(rec))
            out.append(pbam.encode_record(rec))
        return out

    malformed = with_rx(lambda rec: "NODASH")
    inconsistent = with_rx(lambda rec: "AAAAAA-CCCCCC" if rec.is_read1 else "AAAAAA-GGGGGG")
    for bad, match in ((malformed, "duplex UMIs"), (inconsistent, "inconsistent RX")):
        for grp, hdr in ((pgroup, header), (jgroup, _jheader(header))):
            with pytest.raises(ValueError, match=match):
                list(grp.group_reads_by_umi_raw(bad, hdr))
    for grp in (pgroup, jgroup):
        with pytest.raises(ValueError, match="unknown strategy"):
            list(grp.group_reads_by_umi_raw([], None, strategy="nope"))
        with pytest.raises(ValueError, match="edits must be"):
            list(grp.group_reads_by_umi_raw([], None, edits=-1))


# ---------------------------------------------------------------- run


@pytest.fixture(scope="module")
def raw_env(tmp_path_factory):
    """A raw aligned BAM (RX, no MI) of 40 bisulfite families, 1-3
    templates per strand, and its genome."""
    tmp = tmp_path_factory.mktemp("torch_group_run")
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=12_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes))
    pool = [bytes(np.random.default_rng(60 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=80)) for i in range(8)]
    bam = str(tmp / "raw.bam")
    header = pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(codes))])
    with pbam.BamWriter(bam, header) as w:
        for rec in stream_duplex_families(
            codes, 40, read_len=80, raw_umis=True, bisulfite=True,
            templates_for=lambda fam: 1 + fam % 3,
            qual_for=lambda fam, ti, flag: pool[(fam + ti + flag) & 7],
        ):
            w.write(rec)
    return {"tmp": tmp, "fasta": fasta, "bam": bam}


def _cfg_kw(env, **over):
    return dict(genome_dir=os.path.dirname(env["fasta"]),
                genome_fasta_file_name=os.path.basename(env["fasta"]),
                backend="cpu", **over)


RUNS = {
    "self": ({}, ["group_reads_by_umi", "call_consensus_molecular_tpu", "call_duplex_tpu"]),
    "self_filter": ({"filter": {"min_reads": [3, 2, 1]}},
                    ["group_reads_by_umi", "call_consensus_molecular_tpu", "call_duplex_tpu",
                     "filter_consensus_duplex"]),
    "none_filter": ({"aligner": "none", "filter": {"min_reads": 2, "max_read_error_rate": 0.01}},
                    ["group_reads_by_umi", "call_consensus_reads_molecular",
                     "filter_consensus_molecular", "consensus_to_fq_unfiltered"]),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_on_a_raw_bam_writes_the_jax_packages_bytes(raw_env, case):
    over, rules = RUNS[case]
    out = {}
    for name, cfg_mod, stages in (("jax", jconfig, jstages), ("port", pconfig, pstages)):
        outdir = str(raw_env["tmp"] / f"{name}_{case}")
        target, results, stats = stages.run_pipeline(
            cfg_mod.FrameworkConfig(**_cfg_kw(raw_env, **over)), raw_env["bam"], outdir=outdir)
        out[name] = (target, outdir, results, stats)
    (pt, pdir, presults, pstats), (jt, jdir, _jr, jstats) = out["port"], out["jax"]
    assert [r.name for r in presults] == rules
    assert os.path.basename(pt) == os.path.basename(jt)
    drop = lambda d: {k: v for k, v in d.items() if k != "wall_seconds"}  # noqa: E731
    assert drop(pstats["group"].as_dict()) == drop(jstats["group"].as_dict())
    assert pstats["group"].molecules == 40
    grouped = "raw_umigrouped.bam"
    assert_same_bam(os.path.join(pdir, grouped), os.path.join(jdir, grouped))
    if case == "none_filter":
        for mate in (1, 2):
            fq = f"raw_unalignedConsensus_unfiltered_{mate}.fq.gz"
            assert gzip.open(os.path.join(pdir, fq)).read() == \
                gzip.open(os.path.join(jdir, fq)).read()
        filtered = "raw_unalignedConsensus_molecular_filtered.bam"
        assert_same_bam(os.path.join(pdir, filtered), os.path.join(jdir, filtered))
    else:
        assert_same_bam(pt, jt)
        unfiltered = "raw_consensus_duplex_unfiltered.bam"
        assert_same_bam(os.path.join(pdir, unfiltered), os.path.join(jdir, unfiltered))
    if "filter" in over:
        assert pstats["filter"].as_dict() == jstats["filter"].as_dict()
        assert pstats["filter"].dropped_records > 0 and pstats["filter"].kept_records > 0


def test_group_umis_always_regroups_a_grouped_input(raw_env, tmp_path):
    # the raw run's grouped intermediate, already carrying MI
    grouped = str(tmp_path / "regroup.bam")
    assert cli.main(["group", "-i", raw_env["bam"], "-o", grouped]) == 0
    kw = _cfg_kw(raw_env, group_umis="always", filter={"min_reads": 1})
    jt, _jr, _js = jstages.run_pipeline(jconfig.FrameworkConfig(**kw), grouped,
                                        outdir=str(tmp_path / "jax"))
    pt, presults, _ps = pstages.run_pipeline(pconfig.FrameworkConfig(**kw), grouped,
                                             outdir=str(tmp_path / "port"))
    assert presults[0].name == "group_reads_by_umi"
    assert_same_bam(pt, jt)
    # 'auto' sees the MI and does not group
    assert not pstages.PipelineBuilder(
        pconfig.FrameworkConfig(**_cfg_kw(raw_env)), grouped)._needs_grouping()


@pytest.mark.parametrize("argv", ["group", "group_identity", "sort_coordinate", "sort_name",
                                  "sort_template-coordinate", "metrics", "metrics_compact"])
def test_subcommands_equal_the_jax_clis(raw_env, tmp_path, argv, capsys):
    src = raw_env["bam"]
    if argv.startswith(("sort", "metrics")):
        src = str(tmp_path / "grouped.bam")
        jcli.main(["group", "-i", raw_env["bam"], "-o", src])
        capsys.readouterr()
    cmd = {
        "group": ["group", "-i", src],
        "group_identity": ["group", "-i", src, "-s", "identity", "-e", "0", "-m", "30"],
        "metrics": ["metrics", "-i", src],
        "metrics_compact": ["metrics", "-i", src, "--compact"],
    }.get(argv) or ["sort", "-i", src, "--order", argv.split("_", 1)[1]]
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        out = str(tmp_path / f"{name}.bam")
        assert main(cmd + ([] if argv.startswith("metrics") else ["-o", out])) == 0
        o, e = capsys.readouterr()
        doc = json.loads(o if argv.startswith("metrics") else e.strip().splitlines()[-1])
        doc.pop("wall_seconds", None)
        outs[name] = (o if argv.startswith("metrics") else
                      gzip.open(out).read(), doc)
    assert outs["port"] == outs["jax"]
    if argv.startswith("metrics"):
        assert outs["port"][1]["molecules"] == 40 and outs["port"][1]["duplexes"] == 40
        assert ("\n" in outs["port"][0].strip()) == (argv == "metrics")
