"""The port's pysam shim (compat/) and its four drop-in tools
(bsseqconsensusreads_tpu_torch/tools/) on the CPU, held against the JAX
package's (tests/test_golden_reference.py, tests/test_dropin_tools.py):

* a pysam-style script written here (read, re-sequence with pysam's
  quality-clearing semantics, re-tag, re-CIGAR, FASTA fetch, write) run
  through both packages' shims: the same bytes;
* the reference's own tools (1.convert_AG_to_CT.py, 2.extend_gap.py)
  through both shims on the golden fixture: the same bytes — skipped, as
  the JAX package's golden test is, when the reference tools are not
  mounted;
* each drop-in run as a script in the Snakemake rule shape (a fresh
  interpreter, the JAX tool's arguments plus `--device cpu`): the bytes
  of the in-process subcommand and of the JAX package's subcommand
  (molecular, duplex, group, filter-consensus), the stats JSON on stderr.

Tolerance: equality (SHA-256 of the outputs; decompressed with the @PG
lines set aside where a writer adds its program name).
"""

import contextlib
import gzip
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from bsseqconsensusreads_tpu import cli as jcli
from bsseqconsensusreads_tpu.compat import refrunner as jrefrunner
from bsseqconsensusreads_tpu.io.bam import BamHeader, BamWriter
from bsseqconsensusreads_tpu.utils.testing import (
    make_aligned_duplex_group,
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import cli
from bsseqconsensusreads_tpu_torch.compat import pysam_shim
from bsseqconsensusreads_tpu_torch.compat import refrunner as prefrunner
from bsseqconsensusreads_tpu_torch.io import bam as pbam
from bsseqconsensusreads_tpu_torch.utils.testing import stream_duplex_families
from test_golden_reference import REF_TOOL1, REF_TOOL2, golden_env  # noqa: F401
from test_torch_serve import _reference_natives  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "bsseqconsensusreads_tpu_torch", "tools")


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _body(path: str) -> tuple[list, bytes]:
    """(header lines without @PG, the decompressed stream after the
    header text) of a BAM."""
    raw = gzip.open(path).read()
    l_text = int.from_bytes(raw[4:8], "little")
    lines = raw[8:8 + l_text].decode().splitlines()
    return [ln for ln in lines if not ln.startswith("@PG")], raw[8 + l_text:]


@contextlib.contextmanager
def _shim(runner):
    """`runner`'s package's pysam shim installed as `pysam` for the block;
    the previous module (if any) restored after."""
    saved = {k: sys.modules.pop(k) for k in ("pysam", "pysam.bcftools") if k in sys.modules}
    try:
        yield runner
    finally:
        for k in ("pysam", "pysam.bcftools"):
            sys.modules.pop(k, None)
        sys.modules.update(saved)


SCRIPT = '''
import pysam


def main(input_bam, output_bam, reference):
    fa = pysam.FastaFile(reference)
    with pysam.AlignmentFile(input_bam, "rb") as bam:
        out = pysam.AlignmentFile(output_bam, "wb", template=bam)
        for seg in bam:
            name = bam.get_reference_name(seg.reference_id)
            quals = seg.qual
            ref = fa.fetch(name, seg.reference_start, seg.reference_end)
            seg.query_sequence = ref[: len(seg.query_sequence)].replace("C", "T")
            assert seg.query_qualities is None
            seg.qual = quals
            seg.set_tag("XR", len(ref), "i")
            seg.set_tag("XS", name + ":" + str(seg.pos), "Z")
            if seg.cigartuples and seg.flag & 16:
                seg.cigar = [(pysam.CMATCH, len(seg.query_sequence))]
            if seg.has_tag("RX"):
                seg.set_tag("RX", None)
            out.write(seg)
        out.close()
    fa.close()
    return "done"
'''


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_compat")
    rng = np.random.default_rng(77)
    name, genome = random_genome(rng, 6000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=8)
    inp = str(tmp / "grouped.bam")
    with BamWriter(inp, header) as w:
        w.write_all(records)
    return tmp, inp, fasta


def test_a_pysam_script_writes_the_same_bytes_through_both_shims(grouped):
    tmp, inp, fasta = grouped
    script = tmp / "pysam_script.py"
    script.write_text(SCRIPT)
    outs = {}
    for tag, runner in (("port", prefrunner), ("jax", jrefrunner)):
        with _shim(runner):
            out = str(tmp / f"script_{tag}.bam")
            assert runner.run_pysam_script(str(script), input_bam=inp, output_bam=out,
                                           reference=fasta) == "done"
            outs[tag] = _sha(out)
    assert outs["port"] == outs["jax"]
    with pbam.BamReader(str(tmp / "script_port.bam")) as r:
        recs = list(r)
    assert recs and all(rec.get_tag("XS").startswith("chr") or ":" in rec.get_tag("XS")
                        for rec in recs)


def test_the_shim_is_a_pysam_module_over_the_ports_io():
    mod = pysam_shim.build_module()
    assert mod.AlignmentFile is pysam_shim.AlignmentFile
    assert mod.CSOFT_CLIP == 4 and mod.CDIFF == 8
    seg = pysam_shim.AlignedSegment(pbam.BamRecord(qname="q", seq="ACGT", qual=bytes([30] * 4),
                                                   cigar=[(0, 4)], pos=10))
    assert (seg.reference_end, seg.qual) == (14, "????")
    seg.query_sequence = "AC"
    assert seg.query_qualities is None
    assert seg.to_record().qual == bytes([0xFF, 0xFF])
    with pytest.raises(ValueError, match="template"):
        pysam_shim.AlignmentFile("x.bam", "wb")


@pytest.mark.skipif(not (os.path.exists(REF_TOOL1) and os.path.exists(REF_TOOL2)),
                    reason="reference tools not mounted")
def test_the_reference_tools_write_the_same_bytes_through_both_shims(golden_env, tmp_path):
    with _shim(prefrunner):
        out1 = str(tmp_path / "converted.bam")
        prefrunner.run_pysam_script(REF_TOOL1, input_bam=golden_env["inp"], output_bam=out1,
                                    reference=golden_env["fasta"])
        out2 = str(tmp_path / "extended.bam")
        prefrunner.run_pysam_script(REF_TOOL2, input_bam=out1, output_bam=out2)
    assert _sha(out1) == _sha(golden_env["out1"])
    assert _sha(out2) == _sha(golden_env["out2"])


# ---------------------------------------------------------------------------
# the drop-ins, as scripts


@pytest.fixture(scope="module")
def dropins(grouped):
    """Every drop-in run as a script (four interpreters at once), with the
    inputs the JAX package's drop-in tests use."""
    tmp, inp, _fasta = grouped
    rng = np.random.default_rng(78)
    name, genome = random_genome(rng, 4000)
    fasta = str(tmp / "dup_genome.fa")
    write_fasta(fasta, name, genome)
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [(name, len(genome))])
    records = []
    for gi in range(5):
        records += make_aligned_duplex_group(rng, name, genome, gi, 100 + 300 * gi, 60)
    aligned = str(tmp / "aligned.bam")
    with BamWriter(aligned, header) as w:
        w.write_all(records)
    codes = np.random.default_rng(5).integers(0, 4, size=4000).astype(np.uint8)
    raw = str(tmp / "raw.bam")
    with pbam.BamWriter(raw, pbam.BamHeader("@HD\tVN:1.6\tSO:coordinate\n",
                                            [("chr1", 4000)])) as w:
        w.write_all(stream_duplex_families(codes, 12, read_len=60, raw_umis=True,
                                           templates_for=lambda f: 1 + f % 2))
    consensus = str(tmp / "consensus_ref.bam")
    assert jcli.main(["molecular", "-i", inp, "-o", consensus]) == 0
    jobs = {
        "molecular": ("call_molecular_consensus_tpu.py", ["-i", inp]),
        "duplex": ("call_duplex_consensus_tpu.py", ["-i", aligned, "--reference", fasta]),
        "group": ("group_reads_by_umi_tpu.py", ["-s", "paired", "-e", "1", "-i", raw]),
        "filter-consensus": ("filter_consensus_reads_tpu.py", ["-i", consensus, "-M", "2"]),
    }
    env = dict(os.environ, PYTHONPATH="")  # the tools find the package themselves
    procs = {}
    for cmd, (script, argv) in jobs.items():
        out = str(tmp / f"sub_{cmd}.bam")
        procs[cmd] = (subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, script), *argv, "-o", out, "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp)),
            argv, out)
    done = {}
    for cmd, (proc, argv, out) in procs.items():
        _stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2000:]
        done[cmd] = (argv, out, stderr)
    return tmp, done


@pytest.mark.parametrize("cmd", ["molecular", "duplex", "group", "filter-consensus"])
def test_dropin_script_equals_in_process_and_the_jax_packages(dropins, cmd, capsys):
    tmp, done = dropins
    argv, sub_out, stderr = done[cmd]
    device = ["--device", "cpu"] if cmd in ("molecular", "duplex") else []
    port_out, jax_out = str(tmp / f"in_{cmd}.bam"), str(tmp / f"jax_{cmd}.bam")
    assert cli.main([cmd, *argv, "-o", port_out, *device]) == 0
    assert jcli.main([cmd, *argv, "-o", jax_out]) == 0
    capsys.readouterr()
    assert _sha(sub_out) == _sha(port_out)
    assert _body(sub_out) == _body(jax_out)
    key = {"molecular": '"families"', "duplex": '"families"', "group": '"molecules"',
           "filter-consensus": '"kept_records"'}[cmd]
    assert key in stderr
    with pbam.BamReader(sub_out) as r:
        assert sum(1 for _ in r) > 0


def test_dropin_refuses_a_bad_device(grouped, tmp_path):
    tmp, inp, _fasta = grouped
    cp = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "group_reads_by_umi_tpu.py"), "-i", inp, "-o",
         str(tmp_path / "x.bam"), "--device", "tpu"],
        capture_output=True, text=True, timeout=120)
    assert cp.returncode == 2 and "--device must be cuda or cpu" in cp.stderr
