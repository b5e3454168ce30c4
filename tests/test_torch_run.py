"""The port's `run` pipeline (config, workflow DAG, stage bodies, the
record ops of the bwameth path, the CLI) on the CPU against the JAX
package's.

Tolerance: bit/byte equality. Each BAM is compared decompressed, header
text and record stream; the one stated exception is the @PG lines — the
port's name the port (`PN:bsseqconsensusreads_tpu_torch` with the port's
__version__), so its PG lines must equal the JAX package's once the
program name and version are swapped, and nothing else may differ.
Fixture: the tests/test_pipeline.py pipeline_env recipe (12 families),
and a ~700-family bisulfite mixture for the batch-size invariance."""

import dataclasses
import gzip
import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

import bsseqconsensusreads_tpu as jpkg
import bsseqconsensusreads_tpu_torch as ppkg
from bsseqconsensusreads_tpu import config as jconfig
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.io import fastq as jfastq
from bsseqconsensusreads_tpu.io import sam as jsam
from bsseqconsensusreads_tpu.pipeline import record_ops as jops
from bsseqconsensusreads_tpu.pipeline import stages as jstages
from bsseqconsensusreads_tpu.pipeline import workflow as jwf
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.io import bam as pbam
from bsseqconsensusreads_tpu_torch.io import fastq as pfastq
from bsseqconsensusreads_tpu_torch.io import sam as psam
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling
from bsseqconsensusreads_tpu_torch.pipeline import extsort as pextsort
from bsseqconsensusreads_tpu_torch.pipeline import record_ops as pops
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.pipeline import workflow as pwf
from bsseqconsensusreads_tpu_torch.utils.testing import stream_duplex_families
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    """The JAX package's native libraries load before its reference legs."""
    ensure_reference_natives(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


INTERMEDIATE = "_consensus_unfiltered_aunamerged_aligned.bam"


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _bam_parts(path: str):
    """(header lines without @PG, @PG lines, the decompressed bytes after
    the header text: reference dictionary + records)."""
    raw = gzip.open(path).read()
    assert raw[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", raw, 4)
    lines = raw[8:8 + l_text].decode().splitlines()
    pg = [ln for ln in lines if ln.startswith("@PG")]
    return [ln for ln in lines if not ln.startswith("@PG")], pg, raw[8 + l_text:]


def assert_same_bam(port_path: str, jax_path: str) -> None:
    p_lines, p_pg, p_body = _bam_parts(port_path)
    j_lines, j_pg, j_body = _bam_parts(jax_path)
    assert p_lines == j_lines
    assert p_body == j_body
    with pbam.BamReader(port_path) as r:
        assert sum(1 for _ in r) > 0
    # the stated exception: the port's @PG lines name the port
    assert all("PN:bsseqconsensusreads_tpu_torch" in ln for ln in p_pg)
    assert all(f"VN:{ppkg.__version__}" in ln for ln in p_pg)
    swapped = [
        ln.replace("bsseqconsensusreads_tpu_torch", "bsseqconsensusreads_tpu")
        .replace(f"VN:{ppkg.__version__}", f"VN:{jpkg.__version__}")
        for ln in p_pg
    ]
    assert swapped == j_pg


def _fastq_text(path: str) -> str:
    with gzip.open(path, "rt") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_run")
    rng = np.random.default_rng(31)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(
        rng, name, genome, n_families=12, error_rate=0.01
    )
    bam = str(tmp / "input" / "sampleX.bam")
    os.makedirs(os.path.dirname(bam), exist_ok=True)
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    return {"tmp": tmp, "fasta": fasta, "bam": bam, "jax": {}}


def _kw(env, **over):
    return dict(genome_dir=os.path.dirname(env["fasta"]),
                genome_fasta_file_name=os.path.basename(env["fasta"]),
                backend="cpu", **over)


def jax_run(env, tag, **over):
    """The JAX package's run_pipeline on the CPU, once per (tag, config)."""
    if tag not in env["jax"]:
        outdir = str(env["tmp"] / f"jax_{tag}")
        target, results, stats = jstages.run_pipeline(
            jconfig.FrameworkConfig(**_kw(env, **over)), env["bam"], outdir=outdir
        )
        env["jax"][tag] = (target, outdir)
    return env["jax"][tag]


def port_run(env, tag, **over):
    outdir = str(env["tmp"] / f"port_{tag}")
    target, results, stats = pstages.run_pipeline(
        pconfig.FrameworkConfig(**_kw(env, **over)), env["bam"], outdir=outdir
    )
    return target, outdir, results, stats


# ---------------------------------------------------------------- run, self


@pytest.mark.parametrize("via", ["run_pipeline", "cli"])
def test_run_self_writes_the_jax_packages_target_and_intermediate(env, via, capsys):
    jt, jdir = jax_run(env, "self")
    outdir = str(env["tmp"] / f"port_self_{via}")
    if via == "cli":
        rc = cli.main(["run", "--bam", env["bam"], "--reference", env["fasta"],
                       "--outdir", outdir, "--device", "cpu"])
        assert rc == 0
        out, err = capsys.readouterr()
        doc = json.loads(out.strip().splitlines()[-1])
        target = doc["target"]
        assert set(doc["stats"]) == {"molecular", "duplex"}
        assert doc["stats"]["molecular"]["deep_skipped_families"] == 0
        assert doc["stats"]["duplex"]["families"] == 12
        assert "[ran] call_consensus_molecular_tpu" in err
        assert "[ran] call_duplex_tpu" in err
    else:
        target, results, stats = pstages.run_pipeline(
            pconfig.FrameworkConfig(**_kw(env)), env["bam"], outdir=outdir
        )
        assert [r.name for r in results if r.ran] == [
            "call_consensus_molecular_tpu", "call_duplex_tpu",
        ]
        assert stats["molecular"].families == 24 and stats["duplex"].families == 12
    assert os.path.basename(target) == os.path.basename(jt) == "sampleX_consensus_duplex_unfiltered.bam"
    assert_same_bam(target, jt)
    assert_same_bam(os.path.join(outdir, "sampleX" + INTERMEDIATE),
                    os.path.join(jdir, "sampleX" + INTERMEDIATE))
    # a second run: both rules up to date, the target untouched
    before = (_sha(target), os.path.getmtime(target))
    _t, results, _s = pstages.run_pipeline(
        pconfig.FrameworkConfig(**_kw(env)), env["bam"], outdir=outdir
    )
    assert [(r.ran, r.reason) for r in results] == [(False, "up to date")] * 2
    assert (_sha(target), os.path.getmtime(target)) == before


@pytest.fixture(scope="module")
def mixture(tmp_path_factory):
    """~700 families of 1 and 2 templates per strand, RTA3-binned quals:
    more than one batch at batch_families 512 in both stages."""
    tmp = tmp_path_factory.mktemp("torch_run_mix")
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=120_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes))
    pool = [bytes(np.random.default_rng(50 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=100)) for i in range(16)]
    bam = str(tmp / "mix.bam")
    header = pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(codes))])
    with pbam.BamWriter(bam, header) as w:
        for rec in stream_duplex_families(
            codes, 700, read_len=100,
            templates_for=lambda fam: 1 if fam % 10 < 7 else 2,
            qual_for=lambda fam, ti, flag: pool[(fam + ti * 5 + flag) & 15],
            bisulfite=True,
        ):
            w.write(rec)
    return {"tmp": tmp, "fasta": fasta, "bam": bam}


def test_target_bytes_do_not_depend_on_batch_families(mixture):
    shas = {}
    for bf in (512, 2048):
        cfg = pconfig.FrameworkConfig(
            genome_dir=os.path.dirname(mixture["fasta"]), genome_fasta_file_name="genome.fa",
            backend="cpu", batch_families=bf,
        )
        target, _results, stats = pstages.run_pipeline(
            cfg, mixture["bam"], outdir=str(mixture["tmp"] / f"bf{bf}"))
        if bf == 512:
            assert stats["molecular"].batches > 2 and stats["duplex"].batches > 1
        shas[bf] = _sha(target)
    assert shas[512] == shas[2048]


# ------------------------------------------------- aligner none and bwameth


def test_aligner_none_writes_the_jax_packages_fastqs(env):
    jt, jdir = jax_run(env, "none", aligner="none")
    target, outdir, results, _stats = port_run(env, "none", aligner="none")
    assert [r.name for r in results] == ["call_consensus_reads_molecular",
                                         "consensus_to_fq_unfiltered"]
    for suffix in ("_unalignedConsensus_unfiltered_1.fq.gz",
                   "_unalignedConsensus_unfiltered_2.fq.gz"):
        p, j = (os.path.join(d, "sampleX" + suffix) for d in (outdir, jdir))
        assert _fastq_text(p) == _fastq_text(j) != ""
    assert target.endswith("_unalignedConsensus_unfiltered_1.fq.gz")
    mol = "sampleX_unalignedConsensus_molecular.bam"
    assert_same_bam(os.path.join(outdir, mol), os.path.join(jdir, mol))


# A stand-in for bwameth: "aligns" each FASTQ pair of `@<MI>/1` / `@<MI>/2`
# entries at a position derived from the MI number, A strands as 99/147 and
# B strands as 83/163 — enough for the zipper, filter-mapped and duplex
# stages after it to do real work, the same on both packages.
FAKE_BWAMETH = r'''
import gzip, sys
args = sys.argv[1:]
sys.stderr.write("fake-bwameth " + " ".join(args) + "\n")
ref = args[args.index("--reference") + 1]
name, length = None, 0
for line in open(ref):
    if line.startswith(">"):
        name = line[1:].split()[0]
    else:
        length += len(line.strip())
def entries(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    for i in range(0, len(lines), 4):
        yield lines[i][1:].rsplit("/", 1)[0], lines[i + 1], lines[i + 3]
comp = str.maketrans("ACGTN", "TGCAN")
out = sys.stdout
out.write("@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:%s\tLN:%d\n" % (name, length))
for (q, s1, q1), (_q2, s2, q2) in zip(entries(args[-2]), entries(args[-1])):
    fam = int(q.split("/")[0])
    pos = 200 + (fam * 97) % (length - 800)
    b = q.endswith("/B")
    f1, f2 = (83, 163) if b else (99, 147)
    p1, p2 = (pos + 40, pos) if b else (pos, pos + 40)
    for flag, p, mp, s, ql in ((f1, p1, p2, s1, q1), (f2, p2, p1, s2, q2)):
        if flag & 16:
            s, ql = s.translate(comp)[::-1], ql[::-1]
        tlen = (abs(p2 - p1) + len(s)) * (1 if p < mp or (p == mp and flag & 64) else -1)
        out.write("\t".join([q, str(flag), name, str(p + 1), "60", "%dM" % len(s),
                             "=", str(mp + 1), str(tlen), s, ql]) + "\n")
'''


def test_aligner_bwameth_with_a_fake_aligner_writes_the_jax_packages_bam(env, tmp_path):
    fake = tmp_path / "fake_bwameth.py"
    fake.write_text(FAKE_BWAMETH)
    cmd = f"{sys.executable} {fake}"
    jt, jdir = jax_run(env, "bwameth", aligner="bwameth", bwameth=cmd)
    target, outdir, results, stats = port_run(env, "bwameth", aligner="bwameth", bwameth=cmd)
    assert [r.name for r in results if r.ran] == [
        "call_consensus_reads_molecular", "consensus_to_fq_unfiltered",
        "align_consensus_unfiltered", "mergeAunA_consensus",
        "mergeAunA_consensus_grepaligned", "callduplex_tpu", "consensusduplex_to_fq",
        "align_consensus_unfiltered_duplex",
    ]
    assert stats["duplex"].families == 12 and stats["duplex"].consensus_out > 0
    assert os.path.basename(target) == "sampleX_consensus_duplex_unfiltered_bwameth.bam"
    assert _sha(target) == _sha(jt)  # no @PG on the aligner's output
    for name in ("sampleX_consensus_unfiltered_aunamerged.bam",
                 "sampleX" + INTERMEDIATE,
                 "sampleX_consensus_unfiltered_aunamerged_converted_extended_duplexconsensus.bam"):
        assert_same_bam(os.path.join(outdir, name), os.path.join(jdir, name))
    for d in (outdir, jdir):  # the first alignment's stderr, at the reference's path
        assert os.listdir(os.path.join(d, "log", "bwameth_results")) == [
            "sampleX_consensus_unfiltered.log"]
    logs = [open(os.path.join(d, "log", "bwameth_results",
                              "sampleX_consensus_unfiltered.log")).read() for d in (outdir, jdir)]
    assert logs[0].startswith("fake-bwameth --reference ")
    assert logs[0].replace(outdir, "@") == logs[1].replace(jdir, "@")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_bwameth_shellout_contract(env, tmp_path, pkg):
    """tests/test_pipeline.py's contract stub on each package: the exact
    argv (shell quoting surviving spaces), stdout a real pipe into the
    SAM->BAM writer, stderr teed to the reference's log path."""
    stages, config, bam = ((jstages, jconfig, jbam) if pkg == "jax"
                           else (pstages, pconfig, pbam))
    Rule = (jwf if pkg == "jax" else pwf).Rule
    argv_out = tmp_path / "argv.json"
    fake = tmp_path / "fake_bwameth.py"
    fake.write_text(
        "import json, os, stat, sys\n"
        "json.dump({'argv': sys.argv[1:],\n"
        "           'stdout_is_pipe': stat.S_ISFIFO(os.fstat(1).st_mode)},\n"
        f"          open({str(argv_out)!r}, 'w'))\n"
        "sys.stderr.write('contract-stderr-line\\n')\n"
        "sys.stdout.write('@HD\\tVN:1.6\\tSO:unsorted\\n')\n"
        "sys.stdout.write('@SQ\\tSN:chr1\\tLN:1000\\n')\n"
        "sys.stdout.write('r1\\t0\\tchr1\\t1\\t60\\t4M\\t*\\t0\\t0\\tACGT\\tIIII\\n')\n"
        "sys.stdout.write('r2\\t16\\tchr1\\t9\\t60\\t4M\\t*\\t0\\t0\\tTTTT\\tIIII\\n')\n"
    )
    fqdir = tmp_path / "fq dir"
    fqdir.mkdir()
    fq1, fq2 = str(fqdir / "in_1.fq.gz"), str(fqdir / "in_2.fq.gz")
    for fq in (fq1, fq2):
        with gzip.open(fq, "wt") as fh:
            fh.write("@r1\nACGT\n+\nIIII\n")
    cfg = config.FrameworkConfig(**{**_kw(env, aligner="bwameth",
                                          bwameth=f"{sys.executable} {fake}"),
                                    "backend": "cpu"})
    outdir = str(tmp_path / "output")
    builder = stages.PipelineBuilder(cfg, env["bam"], outdir=outdir)
    out_bam = str(tmp_path / "aligned.bam")
    builder.run_bwameth(Rule(name="align_consensus_unfiltered",
                             inputs=[fq1, fq2], outputs=[out_bam], run=None))
    seen = json.load(open(argv_out))
    assert seen["argv"] == ["--reference", env["fasta"], "-t", "8", fq1, fq2]
    assert seen["stdout_is_pipe"] is True
    with bam.BamReader(out_bam) as r:
        assert [(x.qname, x.flag, x.pos) for x in r] == [("r1", 0, 0), ("r2", 16, 8)]
    log = os.path.join(outdir, "log", "bwameth_results", "sampleX_consensus_unfiltered.log")
    assert open(log).read() == "contract-stderr-line\n"


def test_missing_bwameth_raises(env, tmp_path):
    cfg = pconfig.FrameworkConfig(**_kw(env, aligner="bwameth"))
    with pytest.raises(pwf.WorkflowError, match="bwameth"):
        pstages.run_pipeline(cfg, env["bam"], outdir=str(tmp_path / "out"))


# ---------------------------------------------------------- config variants


VARIANTS = {
    "single_strand": {"single_strand": True},
    "chemistry_none": {"chemistry": "none"},
    "chemistry_emseq": {"chemistry": "emseq"},
    "no_strand_tags": {"duplex_strand_tags": False},
    "no_base_counts": {"base_count_tags": False},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_variant_writes_the_jax_packages_bytes(env, variant):
    over = VARIANTS[variant]
    jt, jdir = jax_run(env, variant, **over)
    target, outdir, _results, _stats = port_run(env, variant, **over)
    assert os.path.basename(target) == os.path.basename(jt)
    assert_same_bam(target, jt)
    inter = "sampleX" + INTERMEDIATE
    if not over.get("single_strand"):
        assert_same_bam(os.path.join(outdir, inter), os.path.join(jdir, inter))
    # the setting reached the bytes: each variant differs from the default
    default_t, _d = jax_run(env, "self")
    if variant != "chemistry_emseq":  # emseq is provenance only
        assert _bam_parts(jt)[2] != _bam_parts(default_t)[2]


# ------------------------------------------------------------------ config


def test_config_has_the_jax_fields_and_defaults_but_backend():
    jf = dataclasses.fields(jconfig.FrameworkConfig)
    pf = dataclasses.fields(pconfig.FrameworkConfig)
    assert [f.name for f in pf] == [f.name for f in jf]
    jd, pd = jconfig.FrameworkConfig(backend="cpu"), pconfig.FrameworkConfig()
    for f in jf:
        want, got = getattr(jd, f.name), getattr(pd, f.name)
        if f.name == "backend":  # the stated exception: the card by default
            assert jconfig.FrameworkConfig().backend == "tpu" and got == "cuda"
        elif f.name in ("molecular", "duplex"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name


def test_config_from_yaml_matches_the_jax_reader(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text("aligner: none\nbatch_families: 64\ncheckpoint_every: 3\n"
                    "backend: cpu\nmolecular:\n  min_reads: 2\n")
    j = jconfig.FrameworkConfig.from_yaml(str(path), max_window=2048)
    p = pconfig.FrameworkConfig.from_yaml(str(path), max_window=2048)
    for f in dataclasses.fields(p):
        got, want = getattr(p, f.name), getattr(j, f.name)
        if f.name in ("molecular", "duplex"):
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    # a JAX config asking for the TPU is refused, naming the card
    path.write_text("backend: tpu\n")
    with pytest.raises(pwf.WorkflowError, match="'cuda'"):
        pconfig.FrameworkConfig.from_yaml(str(path))
    with pytest.raises(pwf.WorkflowError, match="'cuda'"):
        pconfig.FrameworkConfig(backend="tpu")
    # PyYAML is imported only here, and its absence is a clear error
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(pwf.WorkflowError, match="PyYAML"):
        pconfig.FrameworkConfig.from_yaml(str(path))


INDEL_POLICY = {
    "indel_policy_align": "align",
    "indel_policy_unknown": "realign",
}


@pytest.mark.parametrize("key", sorted(INDEL_POLICY))
def test_keys_the_port_lacks_raise_at_build_naming_their_item(env, key):
    """indel_policy 'align' builds and runs to the JAX package's target and
    intermediate; an unknown policy still raises at build time."""
    policy = INDEL_POLICY[key]
    builder = pstages.PipelineBuilder(
        pconfig.FrameworkConfig(**_kw(env, indel_policy=policy)), env["bam"],
        outdir=str(env["tmp"] / f"port_build_{policy}"))
    if policy != "align":
        with pytest.raises(pwf.WorkflowError, match="unknown indel_policy 'realign'"):
            builder.build()
        return
    builder.build()
    target, outdir, _results, _stats = port_run(env, "indel_align", indel_policy="align")
    jtarget, joutdir = jax_run(env, "indel_align", indel_policy="align")
    assert_same_bam(target, jtarget)
    assert_same_bam(os.path.join(outdir, "sampleX" + INTERMEDIATE),
                    os.path.join(joutdir, "sampleX" + INTERMEDIATE))


def test_auto_grouping_on_rx_only_input_prepends_the_group_rule(tmp_path):
    codes = np.random.default_rng(3).integers(0, 4, size=5000).astype(np.int8)
    bam = str(tmp_path / "raw.bam")
    header = pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", 5000)])
    with pbam.BamWriter(bam, header) as w:
        for rec in stream_duplex_families(codes, 4, raw_umis=True):
            w.write(rec)
    builder = pstages.PipelineBuilder(pconfig.FrameworkConfig(backend="cpu"), bam,
                                      outdir=str(tmp_path / "o"))
    wf, _target = builder.build()
    assert [r.name for r in wf.rules][:2] == ["group_reads_by_umi",
                                              "call_consensus_molecular_tpu"]
    assert builder.molecular_grouping == "adjacent"
    # 'never' does not probe, and a grouped input never needs grouping
    assert not pstages.PipelineBuilder(
        pconfig.FrameworkConfig(backend="cpu", group_umis="never"), bam)._needs_grouping()


def test_calling_refuses_the_routes_the_port_lacks(env):
    with pbam.BamReader(env["bam"]) as r:
        with pytest.raises(ValueError, match="unknown indel_policy 'realign'"):
            next(pcalling.call_molecular_batches(r, device="cpu", indel_policy="realign"))
        with pytest.raises(ValueError, match="unknown indel_policy 'realign'"):
            pcalling.check_route("auto", "realign")
        pcalling.check_route("auto", "align")  # the JAX package's policy runs
        # the wire needs the genome on the device: no refstore, no wire
        with pytest.raises(ValueError, match="needs a refstore"):
            next(pcalling.call_duplex_batches(r, None, [], device="cpu", transport="wire"))
        with pytest.raises(ValueError, match="pos0='shift'"):
            next(pcalling.call_duplex_batches(r, None, [], device="cpu",
                                              chemistry="none", pos0="shift"))


def test_stream_interstage_falls_back_loudly_to_the_two_pass_bytes(env, capsys):
    target, _o, results, _s = port_run(env, "interstage", stream_interstage=True)
    err = capsys.readouterr().err
    assert "stream_interstage disabled: sort_engine must resolve to 'bucket'" in err
    assert [r.name for r in results] == ["call_consensus_molecular_tpu", "call_duplex_tpu"]
    jt, _jdir = jax_run(env, "self")
    assert_same_bam(target, jt)


def test_run_without_a_card_raises_unless_asked_for_the_cpu(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    outdir = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", "--bam", env["bam"], "--reference", env["fasta"], "--outdir", outdir])
    cfg = pconfig.FrameworkConfig(**{**_kw(env), "backend": "cuda"})
    with pytest.raises(RuntimeError, match="CUDA"):
        pstages.run_pipeline(cfg, env["bam"], outdir=outdir)
    assert not os.path.exists(outdir)


# --------------------------------------------------- record ops, SAM, FASTQ


def _rec(bam, qname, flag, pos=0, ref_id=0, **kw):
    return bam.BamRecord(qname=qname, flag=flag, ref_id=ref_id, pos=pos,
                         seq=kw.pop("seq", "ACGT"), qual=kw.pop("qual", bytes([30] * 4)),
                         cigar=kw.pop("cigar", [(0, 4)]), **kw)


def _ops_case(case, bam, ops, sam, fastq, tmp):
    """One tests/test_pipeline.py record-ops / SAM case on one package;
    returns a plain-data result."""
    rec = lambda *a, **k: _rec(bam, *a, **k)  # noqa: E731
    if case == "filter_mapped":
        return [r.qname for r in ops.filter_mapped([rec("a", 0), rec("b", 4), rec("c", 99)])]
    if case == "sorts":
        recs = [rec("b", 99, pos=50), rec("a", 147, pos=10), rec("a", 99, pos=5)]
        return ([r.qname for r in ops.name_sort(recs)],
                [r.pos for r in ops.coordinate_sort(recs)])
    if case == "template_coordinate":
        a1, other, b1 = rec("x", 99, pos=100), rec("y", 99, pos=105), rec("z", 163, pos=100)
        for r, mi in ((a1, "7/A"), (other, "9/A"), (b1, "7/B")):
            r.set_tag("MI", mi, "Z")
        return [str(r.get_tag("MI")) for r in ops.template_coordinate_sort([other, b1, a1])]
    if case == "zipper":
        aligned = [rec("q1", 99, pos=10), rec("q2", 83, pos=4, seq="ACGA"), rec("solo", 99, pos=5)]
        unaligned = [rec("q1", 77), rec("q2", 77, seq="TCGT")]
        for u, mi in zip(unaligned, ("5/A", "6/B")):
            u.set_tag("MI", mi, "Z")
            u.set_tag("cD", 7, "i")
            u.set_tag("cd", ("S", [1, 2, 3, 4]), "B")
            u.set_tag("ac", "ACGN", "Z")
        header = bam.BamHeader("@HD\tVN:1.6\n", [("c", 1000)])
        streamed = ops.zipper_bams_stream(aligned, unaligned, header, buffer_records=1,
                                          workdir=str(tmp))
        return [(r.qname, r.pos, sorted(r.tags.items())) for r in streamed]
    if case == "sam_round_trip":
        header = bam.BamHeader("@HD\tVN:1.6\n", [("chr1", 1000)])
        r = rec("q", 99, pos=42, seq="ACGTA", qual=bytes([30, 31, 32, 33, 34]),
                cigar=[(0, 5)], next_ref_id=0, next_pos=100, tlen=62)
        r.set_tag("MI", "3/A", "Z")
        r.set_tag("cD", 4, "i")
        r.set_tag("cd", ("S", [1, 2, 3]), "B")
        line = sam.format_sam_record(r, header)
        back = sam.parse_sam_line(line, header)
        import io as _io

        text = "@HD\tVN:1.6\n@SQ\tSN:c\tLN:100\nq\t99\tc\t11\t60\t4M\t=\t20\t13\tACGT\tIIII\tMI:Z:1/A\n"
        h2, recs = sam.read_sam(_io.StringIO(text))
        recs = list(recs)
        out = _io.StringIO()
        sam.write_sam([back, *recs], header, out)
        return (line, back.qname, back.pos, back.seq, back.qual, sorted(back.tags.items()),
                h2.references, [(x.pos, x.get_tag("MI")) for x in recs], out.getvalue())
    if case == "sam_to_fastq":
        records = [rec("x", 0x41, seq="AAAA"), rec("orphan", 0x41, seq="CCCC"),
                   rec("y", 0x41 | 0x10, seq="ACGG"), rec("y", 0x81, seq="GGGG"),
                   rec("x", 0x81, seq="TTTT")]
        fq1, fq2 = str(tmp / "r1.fq.gz"), str(tmp / "r2.fq.gz")
        n = fastq.sam_to_fastq(iter(records), fq1, fq2)
        return n, _fastq_text(fq1), _fastq_text(fq2)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["filter_mapped", "sorts", "template_coordinate",
                                  "zipper", "sam_round_trip", "sam_to_fastq"])
def test_record_ops_and_sam_equal_the_jax_packages(case, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _ops_case(case, jbam, jops, jsam, jfastq, tmp_path / "j")
    got = _ops_case(case, pbam, pops, psam, pfastq, tmp_path / "p")
    assert got == want
    if case == "filter_mapped":
        assert got == ["a", "c"]
    if case == "template_coordinate":
        assert [mi.split("/")[0] for mi in got] == ["7", "7", "9"]


def test_external_sort_spills_and_merges_like_the_in_memory_sort(tmp_path):
    recs = [_rec(pbam, f"q{i % 37}", 99 if i % 2 else 147, pos=(i * 7919) % 500)
            for i in range(300)]
    header = pbam.BamHeader("@HD\tVN:1.6\n", [("c", 1000)])
    for key in (pops.name_key, pops.coordinate_key):
        got = list(pextsort.external_sort(iter(recs), key, header, workdir=str(tmp_path),
                                          buffer_records=7))
        assert [(r.qname, r.flag, r.pos) for r in got] == [
            (r.qname, r.flag, r.pos) for r in sorted(recs, key=key)]
    assert os.listdir(tmp_path) == []  # spill runs cleaned up


@pytest.mark.parametrize("argv", ["zipper", "sam-to-fastq", "filter-mapped"])
def test_record_op_subcommands(env, tmp_path, argv, capsys):
    jt, jdir = jax_run(env, "none", aligner="none")
    mol = os.path.join(jdir, "sampleX_unalignedConsensus_molecular.bam")
    out = str(tmp_path / "out.bam")
    if argv == "sam-to-fastq":
        from bsseqconsensusreads_tpu.cli import main as jmain

        fq = [str(tmp_path / f"r{i}.fq.gz") for i in (1, 2)]
        jfq = [str(tmp_path / f"j{i}.fq.gz") for i in (1, 2)]
        assert cli.main(["sam-to-fastq", "-i", mol, "--fq1", fq[0], "--fq2", fq[1]]) == 0
        assert json.loads(capsys.readouterr().err.strip().splitlines()[-1]) == {"r1": 24, "r2": 24}
        assert jmain(["sam-to-fastq", "-i", mol, "--fq1", jfq[0], "--fq2", jfq[1]]) == 0
        for a, b in zip(fq, jfq):  # both name-sort first: the same text
            assert _fastq_text(a) == _fastq_text(b) != ""
        return
    # the self run's aligned molecular consensus beside the unaligned one
    _self_t, self_dir = jax_run(env, "self")
    aligned = os.path.join(self_dir, "sampleX" + INTERMEDIATE)
    if argv == "zipper":
        assert cli.main(["zipper", "-i", aligned, "--unmapped", mol, "-o", out]) == 0
        with jbam.BamReader(aligned) as a, jbam.BamReader(mol) as u:
            want = list(jops.zipper_bams_stream(a, u, a.header.with_sort_order("coordinate")))
    else:
        mixed = str(tmp_path / "mixed.bam")  # unmapped and mapped records
        with jbam.BamReader(aligned) as a, jbam.BamReader(mol) as u:
            recs = [x for pair in zip(u, a) for x in pair]
            with jbam.BamWriter(mixed, a.header) as w:
                w.write_all(recs)
        assert cli.main(["filter-mapped", "-i", mixed, "-o", out]) == 0
        want = list(jops.filter_mapped(recs))
        assert 0 < len(want) < len(recs)
    with pbam.BamReader(out) as r:
        got = list(r)
    assert [pbam.encode_record(x) for x in got] == [jbam.encode_record(x) for x in want]
    n = json.loads(capsys.readouterr().err.strip().splitlines()[-1])["records"]
    assert n == len(got)


# ---------------------------------------------------------------- workflow


def _workflow_case(case, wf_mod, tmp):
    """One tests/test_pipeline.py workflow case on one package's Workflow;
    returns its RuleResults as (name, ran, reason) with tmp stripped, or
    the error it raised."""
    src, mid, out = tmp / "in.txt", tmp / "mid.txt", tmp / "out.txt"
    src.write_text("1")

    def step(name, inp, outp):
        def run(rule):
            outp.write_text(inp.read_text() + name)
        return run

    def norm(results):
        return [(r.name, r.ran, r.reason.replace(str(tmp), "@")) for r in results]

    wf = wf_mod.Workflow()
    try:
        if case == "skip_and_rerun":
            wf.rule("a", [str(src)], [str(mid)], step("a", src, mid))
            wf.rule("b", [str(mid)], [str(out)], step("b", mid, out))
            first, second = norm(wf.run([str(out)])), norm(wf.run([str(out)]))
            os.utime(src, (os.path.getmtime(src) + 10,) * 2)
            return first, second, norm(wf.run([str(out)])), out.read_text()
        if case == "upstream_reran":
            def old_mid(rule):  # a rewrites mid but leaves it older than out
                mid.write_text("m")
                os.utime(mid, (1.0, 1.0))
            wf.rule("a", [str(src)], [str(mid)], old_mid)
            wf.rule("b", [str(mid)], [str(out)], step("b", mid, out))
            wf.run([str(out)])
            os.unlink(mid)
            return norm(wf.run([str(out)]))
        if case == "temp_cleanup":
            wf.rule("a", [str(src)], [str(mid)], lambda r: mid.write_text("m"),
                    temp_outputs=[str(mid)])
            wf.rule("b", [str(mid)], [str(out)], lambda r: out.write_text("o"))
            return norm(wf.run([str(out)])), out.exists(), mid.exists()
        if case == "partial_output_removed":
            def boom(rule):
                out.write_text("partial")
                raise KeyboardInterrupt
            wf.rule("a", [str(src)], [str(out)], boom)
            try:
                wf.run([str(out)])
            except KeyboardInterrupt:
                return "interrupted", out.exists()
        if case == "missing_input":
            wf.rule("a", [str(tmp / "ghost")], [str(tmp / "x")], lambda r: None)
            wf.run([str(tmp / "x")])
        if case == "duplicate_output":
            wf.rule("a", [], [str(tmp / "x")], lambda r: None)
            wf.rule("b", [], [str(tmp / "x")], lambda r: None)
        if case == "forced":
            wf.rule("a", [str(src)], [str(mid)], step("a", src, mid))
            wf.run([str(mid)])
            return norm(wf.run([str(mid)], force=True))
    except wf_mod.WorkflowError as exc:
        return "WorkflowError", str(exc).replace(str(tmp), "@")
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["skip_and_rerun", "upstream_reran", "temp_cleanup",
                                  "partial_output_removed", "missing_input",
                                  "duplicate_output", "forced"])
def test_workflow_behaves_as_the_jax_packages(case, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _workflow_case(case, jwf, tmp_path / "j")
    got = _workflow_case(case, pwf, tmp_path / "p")
    assert got == want
    if case == "skip_and_rerun":
        assert [r[1] for r in got[1]] == [False, False]
        assert [r[1] for r in got[2]] == [True, True]
    if case == "upstream_reran":
        assert got[1] == ("b", True, "upstream rule re-ran")
    if case in ("missing_input", "duplicate_output"):
        assert got[0] == "WorkflowError"


def test_cli_duplex_chemistry_none_matches_the_jax_cli(env, tmp_path):
    from bsseqconsensusreads_tpu.cli import main as jmain

    _t, self_dir = jax_run(env, "self")
    src = os.path.join(self_dir, "sampleX" + INTERMEDIATE)
    outs = {}
    for name, fn, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jmain, [])):
        outs[name] = str(tmp_path / f"{name}.bam")
        assert fn(["duplex", "-i", src, "-o", outs[name], "--reference", env["fasta"],
                   "--mode", "self", "--chemistry", "none", *extra]) == 0
    # the stage subcommands add no @PG: the headers are the input's
    assert _bam_parts(outs["port"]) == _bam_parts(outs["jax"])
    chem_t, _d = jax_run(env, "chemistry_none", chemistry="none")
    assert _bam_parts(outs["port"])[2] == _bam_parts(chem_t)[2]
