"""indel_policy 'align' in the port (ops/banded.py, the encode's
_align_pending, the molecular stage and `run`) on the CPU against the JAX
package's.

Tolerances: banded_scores bit-equal to the jitted JAX function (the
scores are small integers and -1e9, added in the same order);
banded_align's bases, quals and ok array-equal; the encoded arrays and
indel_aligned / indel_dropped equal; the molecular BAMs SHA-equal, the
`run` BAMs decompressed-equal with the @PG lines aside (they name the
port). Fixture: a bisulfite stream_duplex_families mixture where 15% of
reads carry a 1-3 bp insertion or deletion (the port's generator,
indel_rate), with one family deep enough for a lowered deep threshold.
"""

import gzip
import hashlib
import os
import struct

import numpy as np
import pytest

from bsseqconsensusreads_tpu_torch.alphabet import BASE_CODE, NBASE
from bsseqconsensusreads_tpu_torch.io.bam import CDEL, CINS, BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu_torch.ops import banded as pb
from bsseqconsensusreads_tpu_torch.ops import encode as penc
from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu_torch.pipeline import calling as pcalling
from bsseqconsensusreads_tpu_torch.pipeline import extsort as pextsort
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.utils.testing import stream_duplex_families, write_fasta

MATCH, MISMATCH, GAP, BS = 4.0, -6.0, -8.0, 1.0


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def codes(s):
    return BASE_CODE[np.frombuffer(s.encode(), dtype=np.uint8)].astype(np.int8)


def _dp_case(name: str):
    """(reads, quals, ref, offsets, band) of one seeded DP case: reads cut
    from the anchor with 1-3 bp indels and substitutions, or random."""
    seed, n, l, w, mid_n, past, mixed = {
        "l40": (1, 24, 40, 64, 0.0, False, False),
        "l40_mid_n_mixed": (2, 24, 40, 64, 0.05, False, True),
        "l150": (3, 64, 150, 192, 0.0, False, False),
        "l150_mid_n_mixed_past_window": (4, 64, 150, 192, 0.02, True, True),
    }[name]
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=(n, w)).astype(np.int8)
    ref[:, : rng.integers(0, 8)] = NBASE  # uncovered anchor columns
    offsets = rng.integers(-4, 40, size=n).astype(np.int32)
    if past:
        offsets[:4] = [-12, w - l // 2, w + 3, -l]  # reads past the window
    reads = np.full((n, l), NBASE, np.int8)
    for i in range(n):
        src = np.roll(ref[i], -int(offsets[i]))[: l + 3].copy()
        src[src == NBASE] = rng.integers(0, 4)
        k, p = int(rng.integers(1, 4)), int(rng.integers(5, l - 10))
        if i % 3 == 0:  # deletion
            seq = np.concatenate([src[:p], src[p + k:]])[:l]
        elif i % 3 == 1:  # insertion
            seq = np.concatenate([src[:p], rng.integers(0, 4, k).astype(np.int8), src[p:]])[:l]
        else:
            seq = src[:l]
        if i % 7 == 6:
            seq = rng.integers(0, 4, size=l).astype(np.int8)  # garbage
        sub = rng.random(l) < 0.03
        seq = np.where(sub, rng.integers(0, 4, size=l), seq).astype(np.int8)
        reads[i] = seq
    if mid_n:
        reads[rng.random(reads.shape) < mid_n] = NBASE
    if mixed:
        lens = rng.integers(l // 2, l + 1, size=n)
        for i in range(n):
            reads[i, lens[i]:] = NBASE
    quals = rng.integers(2, 41, size=(n, l)).astype(np.uint8)
    return reads, quals, ref, offsets, 8


DP_CASES = ["l40", "l40_mid_n_mixed", "l150", "l150_mid_n_mixed_past_window"]


@pytest.mark.parametrize("case", DP_CASES)
def test_banded_scores_are_bit_equal_to_the_jitted_jax_function(case):
    from bsseqconsensusreads_tpu.ops.banded import banded_scores

    reads, _q, ref, offsets, band = _dp_case(case)
    want = np.asarray(banded_scores(reads, ref, offsets, band, MATCH, MISMATCH, GAP, BS))
    got = pb.banded_scores(reads, ref, offsets, band, MATCH, MISMATCH, GAP, BS,
                           device="cpu").numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", DP_CASES)
@pytest.mark.parametrize("min_score", [0.0, 1.0])
def test_banded_align_is_array_equal_to_the_jax_packages(case, min_score):
    from bsseqconsensusreads_tpu.ops.banded import banded_align

    reads, quals, ref, offsets, band = _dp_case(case)
    want = banded_align(reads, quals, ref, offsets, band, min_score_per_base=min_score)
    got = pb.banded_align(reads, quals, ref, offsets, band, min_score_per_base=min_score,
                          device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2].any() and (min_score == 0.0 or not got[2].all())


def _window(anchor, w, at):
    ref = np.full(w, NBASE, np.int8)
    ref[at:at + len(anchor)] = anchor
    return ref


def _unit_case(name):
    """The cases of tests/test_banded.py: (reads, quals, ref, offsets,
    band, min_score, check(bases, quals, ok))."""
    q20 = lambda n: np.full((1, n), 30, np.uint8)  # noqa: E731
    if name == "exact_read":
        a = codes("ACGTACGTACGTACGTACGT")

        def check(b, q, ok):
            assert ok[0] and (b[0, 4:24] == a).all() and (q[0, 4:24] == 30).all()
            assert (b[0, :4] == NBASE).all() and (b[0, 24:] == NBASE).all()
        return a[None], q20(20), _window(a, 32, 4)[None], np.array([4], np.int32), 4, 0.0, check
    if name == "deletion_shifts_right":
        a = codes("ACGTTGCAACGTTGCAACGT")
        read = np.concatenate([a[:10], a[11:]])[None]

        def check(b, q, ok):
            assert ok[0] and (b[0, 4:14] == a[:10]).all() and b[0, 14] == NBASE
            assert (b[0, 15:24] == a[11:]).all()
        return read, q20(19), _window(a, 32, 4)[None], np.array([4], np.int32), 4, 0.0, check
    if name == "insertion_dropped":
        a = codes("ACGTTGCAACGTTGCAACGT")
        read = np.concatenate([a[:10], [3], a[10:]]).astype(np.int8)[None]

        def check(b, q, ok):
            assert ok[0] and (b[0, 4:24] == a).all()
        return read, q20(21), _window(a, 32, 4)[None], np.array([4], np.int32), 4, 0.0, check
    if name == "t_over_c":
        a = codes("ACCCCACCCCACCCCACCCC")
        read = np.where(a == 1, 3, a).astype(np.int8)[None]

        def check(b, q, ok):
            assert ok[0] and (b[0, 2:22] == read[0]).all()
        return read, q20(20), _window(a, 28, 2)[None], np.array([2], np.int32), 3, 0.0, check
    if name == "garbage_refused":
        ref = np.random.default_rng(9).integers(0, 4, size=(1, 40)).astype(np.int8)
        read = ((ref[0, 5:25] + 2) % 4)[None].astype(np.int8)

        def check(b, q, ok):
            assert not ok[0]
        return read, q20(20), ref, np.array([5], np.int32), 4, 1.0, check
    assert name == "mid_read_n"
    a = codes("ACGTACGTACGTACGTACGT")
    read = a.copy()
    read[7] = NBASE

    def check(b, q, ok):
        assert ok[0] and b[0, 10] == NBASE
        assert (b[0, 3:10] == a[:7]).all() and (b[0, 11:23] == a[8:]).all()
    return read[None], q20(20), _window(a, 30, 3)[None], np.array([3], np.int32), 3, 0.0, check


@pytest.mark.parametrize("name", ["exact_read", "deletion_shifts_right", "insertion_dropped",
                                  "t_over_c", "garbage_refused", "mid_read_n"])
def test_the_jax_packages_banded_cases(name):
    from bsseqconsensusreads_tpu.ops.banded import banded_align

    reads, quals, ref, offsets, band, min_score, check = _unit_case(name)
    got = pb.banded_align(reads, quals, ref, offsets, band=band, min_score_per_base=min_score,
                          device="cpu")
    check(*got)
    want = banded_align(reads, quals, ref, offsets, band=band, min_score_per_base=min_score)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- encode and stages


@pytest.fixture(scope="module")
def indel_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_banded")
    rng = np.random.default_rng(11)
    codes_ = rng.integers(0, 4, size=20_000).astype(np.int8)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", codes_to_seq(codes_))
    recs = list(stream_duplex_families(
        codes_, 80, read_len=100,
        templates_for=lambda fam: 40 if fam == 17 else (1 if fam % 10 < 6 else 3),
        bisulfite=True, indel_rate=0.15,
    ))
    n_indel = sum(any(op in (CINS, CDEL) for op, _ in r.cigar) for r in recs)
    bam = str(tmp / "sampleI.bam")
    with BamWriter(bam, BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", 20_000)])) as w:
        w.write_all(recs)
    return {"tmp": tmp, "fasta": fasta, "bam": bam, "n_indel": n_indel, "jax": {}}


def _groups(bam: str, engine: str, policy: str):
    """(port groups, JAX groups) of the molecular stage's ingest on one
    engine: FamilyRuns with the C scan of `policy`, or (mi, records)."""
    from bsseqconsensusreads_tpu.io.bam import BamReader as JaxReader
    from bsseqconsensusreads_tpu.pipeline import calling as jc
    from bsseqconsensusreads_tpu.pipeline import stages as jstages

    with BamReader(bam) as r, JaxReader(bam) as jr:
        src = pstages.molecular_ingest_stream(bam, r, pcalling.StageStats(),
                                              ingest_choice=engine, indel_policy=policy)
        jsrc = jstages.molecular_ingest_stream(bam, jr, jc.StageStats(),
                                               ingest_choice=engine, indel_policy=policy)
        return (list(pcalling.stream_mi_groups(src, grouping="coordinate")),
                list(jc.stream_mi_groups(jsrc, grouping="coordinate")))


@pytest.mark.parametrize("engine", ["native", "python"])
def test_encode_align_arrays_and_counts_equal_the_jax_packages(indel_env, engine):
    from bsseqconsensusreads_tpu.ops.encode import encode_molecular_families

    groups, jgroups = _groups(indel_env["bam"], engine, "align")
    assert len(groups) == len(jgroups) == 160  # 80 families x 2 strands
    total = [0, 0]
    for i in range(0, 160, 32):
        got, gskip = penc.encode_molecular_families(groups[i:i + 32], indel_policy="align",
                                                    device="cpu")
        want, wskip = encode_molecular_families(jgroups[i:i + 32], indel_policy="align")
        np.testing.assert_array_equal(got.bases, want.bases)
        np.testing.assert_array_equal(got.quals, want.quals)
        assert gskip == wskip
        assert [m.mi for m in got.meta] == [m.mi for m in want.meta]
        assert (got.indel_aligned, got.indel_dropped) == (want.indel_aligned, want.indel_dropped)
        total[0] += got.indel_aligned
        total[1] += got.indel_dropped
    # every indel read is either placed or refused
    assert total[0] > 0 and total[1] > 0 and sum(total) == indel_env["n_indel"]
    # 'drop' places none of them
    drop, _ = penc.encode_molecular_families(groups[:16], indel_policy="drop")
    assert (drop.indel_aligned, drop.indel_dropped) == (0, 0)


def _jax_molecular(env, engine: str, deep_threshold):
    from bsseqconsensusreads_tpu.io.bam import BamReader as JaxReader
    from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
    from bsseqconsensusreads_tpu.pipeline import calling as jc
    from bsseqconsensusreads_tpu.pipeline import extsort as je
    from bsseqconsensusreads_tpu.pipeline import stages as jstages

    key = (engine, deep_threshold)
    if key not in env["jax"]:
        out = str(env["tmp"] / f"jax_mol_{engine}_{deep_threshold}.bam")
        stats = jc.StageStats()
        with JaxReader(env["bam"]) as r:
            src = jstages.molecular_ingest_stream(env["bam"], r, stats, ingest_choice=engine,
                                                  indel_policy="align")
            batches = jc.call_molecular_batches(
                src, JaxParams(min_reads=1), mode="self", grouping="coordinate",
                batch_families=16, stats=stats, mesh=None, transport="unpacked",
                emit=engine, indel_policy="align", deep_threshold=deep_threshold,
            )
            je.write_batch_stream(batches, out, r.header, "self", sort_engine=engine)
        env["jax"][key] = (out, stats)
    return env["jax"][key]


@pytest.mark.parametrize("deep_threshold", [None, 16])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_molecular_cli_align_is_sha_equal_to_the_jax_packages(indel_env, engine,
                                                              deep_threshold, capsys):
    import json

    from bsseqconsensusreads_tpu_torch import cli

    jout, jstats = _jax_molecular(indel_env, engine, deep_threshold)
    out = str(indel_env["tmp"] / f"port_mol_{engine}_{deep_threshold}.bam")
    if deep_threshold is None:
        rc = cli.main(["molecular", "-i", indel_env["bam"], "-o", out, "--mode", "self",
                       "--indel-policy", "align", "--device", "cpu", "--batch-families", "16",
                       "--ingest", engine, "--emit", engine, "--grouping", "coordinate"])
        assert rc == 0
        stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
        aligned, dropped = stats["indel_aligned"], stats["indel_dropped"]
    else:  # the deep route: the 40-template family (with indel reads) goes deep
        st = pcalling.StageStats()
        with BamReader(indel_env["bam"]) as r:
            src = pstages.molecular_ingest_stream(indel_env["bam"], r, st, ingest_choice=engine,
                                                  indel_policy="align")
            batches = pcalling.call_molecular_batches(
                src, ConsensusParams(min_reads=1), mode="self", grouping="coordinate",
                batch_families=16, stats=st, device="cpu", emit=engine,
                indel_policy="align", deep_threshold=deep_threshold,
            )
            pextsort.write_batch_stream(batches, out, r.header, "self", sort_engine=engine)
        assert st.counter("deep_routed_families") == 2  # both strands of the family
        aligned, dropped = st.indel_aligned, st.indel_dropped
    assert _sha(out) == _sha(jout)
    assert (aligned, dropped) == (jstats.indel_aligned, jstats.indel_dropped)
    assert aligned + dropped == indel_env["n_indel"]


def _bam_body(path: str):
    raw = gzip.open(path).read()
    (l_text,) = struct.unpack_from("<i", raw, 4)
    lines = raw[8:8 + l_text].decode().splitlines()
    return [ln for ln in lines if not ln.startswith("@PG")], raw[8 + l_text:]


def test_run_align_equals_the_jax_packages_run(indel_env, monkeypatch):
    from bsseqconsensusreads_tpu import config as jconfig
    from bsseqconsensusreads_tpu.pipeline import stages as jstages
    from bsseqconsensusreads_tpu_torch import config as pconfig

    kw = dict(genome_dir=os.path.dirname(indel_env["fasta"]),
              genome_fasta_file_name=os.path.basename(indel_env["fasta"]),
              backend="cpu", indel_policy="align", batch_families=32)
    # the JAX package's host pool races two encodes on one FASTA handle
    # across duplex batches (ROADMAP queue 3): its inline bytes are the
    # reference
    with monkeypatch.context() as m:
        m.setenv("BSSEQ_TPU_HOST_WORKERS", "0")
        jt, _r, jstats = jstages.run_pipeline(jconfig.FrameworkConfig(**kw), indel_env["bam"],
                                              outdir=str(indel_env["tmp"] / "jax_run"))
    pt, _r, pstats = pstages.run_pipeline(pconfig.FrameworkConfig(**kw), indel_env["bam"],
                                          outdir=str(indel_env["tmp"] / "port_run"))
    assert _bam_body(pt) == _bam_body(jt)
    inter = "sampleI_consensus_unfiltered_aunamerged_aligned.bam"
    assert _bam_body(os.path.join(os.path.dirname(pt), inter)) == \
        _bam_body(os.path.join(os.path.dirname(jt), inter))
    assert pstats["molecular"].indel_aligned == jstats["molecular"].indel_aligned > 0
