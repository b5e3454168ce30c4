"""Synthetic data generators for tests and the chip smoke.

The port's copy of random_genome, write_fasta, bisulfite_convert and
stream_duplex_families from the JAX package's utils/testing.py, so that
chip_smoke.py can make its input without the JAX package. Same generation
scheme, same records for the same arguments.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from bsseqconsensusreads_tpu_torch.io.bam import BamRecord, CMATCH

BASES = "ACGT"


def random_genome(rng: np.random.Generator, length: int = 5000, name: str = "chr1") -> tuple[str, str]:
    seq = "".join(BASES[i] for i in rng.integers(0, 4, size=length))
    return name, seq


def write_fasta(path: str, name: str, seq: str, width: int = 60) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), width):
            fh.write(seq[i : i + width] + "\n")


def bisulfite_convert(seq: str, genome: str, start: int, strand: str, meth_cpg: bool = True) -> str:
    """Apply bisulfite chemistry to a fragment in top-strand coordinates.

    Top ('A') strand: unmethylated C -> T; CpG Cs stay C when methylated.
    Bottom ('B') strand: the complementary strand converts, which reads out on
    the top-strand coordinates as G -> A (except methylated CpG Gs).
    """
    out = list(seq)
    n = len(genome)
    for i, b in enumerate(out):
        gpos = start + i
        if strand == "A" and b == "C":
            in_cpg = gpos + 1 < n and genome[gpos + 1] == "G"
            if not (meth_cpg and in_cpg):
                out[i] = "T"
        elif strand == "B" and b == "G":
            in_cpg = gpos - 1 >= 0 and genome[gpos - 1] == "C"
            if not (meth_cpg and in_cpg):
                out[i] = "A"
    return "".join(out)


def stream_duplex_families(
    codes: np.ndarray,
    n_families: int,
    *,
    read_len: int = 100,
    frag_extra: int = 30,
    templates_for=None,
    qual_for=None,
    mutate=None,
    rx: str = "ACGTACGT-TGCATGCA",
    bisulfite: bool = False,
    raw_umis: bool = False,
    indel_rate: float = 0.0,
):
    """Stream a coordinate-sorted synthetic grouped-duplex record stream.

    One MI family per `fam` index: A/B strands x both mates (flags
    99/147/163/83), `templates_for(fam)` read pairs per strand (default 1).
    Family start positions are MONOTONE NON-DECREASING —
    ``10 + (fam * span) // n_families`` — so the stream satisfies the
    'coordinate' grouping contract (pipeline.calling.stream_mi_groups) for
    ANY family count.

    Memory is O(1 family): records are built lazily.

    qual_for(fam, ti, flag) -> bytes[read_len]; mutate(seq, fam, ti, flag)
    -> str lets callers inject sequencing errors without paying per-record
    rng costs here.

    bisulfite=True emits each strand's reads in that strand's bisulfite
    space (bisulfite_convert A/B, CpGs methylated) — the chemistry the
    duplex convert stage is built for (reference tools/1 semantics); raw
    genome reads fed through the convert stage would trip its
    content-dependent rewrite rules pseudo-randomly.

    raw_umis=True emits the stream one step EARLIER than the reference's
    input contract: per-family duplex UMIs in RX (B-strand halves
    swapped, as sequenced) and NO MI tag — the input of UMI grouping.
    UMIs are fam-deterministic with pairwise mismatch distance >= 2.

    indel_rate > 0 gives that share of reads one 1-3 bp insertion or
    deletion (indel_read), chosen by a hash of (fam, ti, flag), with the
    CIGAR to match; 0 (the default) leaves every record as before.
    """
    from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq

    genome_len = len(codes)
    frag_len = read_len + frag_extra
    span = genome_len - frag_len - 30
    if span <= 0:
        raise ValueError(f"genome too short: {genome_len} for {frag_len}-bp fragments")
    genome_str = codes_to_seq(codes) if bisulfite else None
    default_qual = bytes([35] * read_len)

    if raw_umis and n_families > 4 ** 12:
        raise ValueError(
            f"raw_umis encodes fam in 12 base-4 digits; {n_families} "
            f"families would wrap and repeat UMIs"
        )

    def _fam_umi(fam: int) -> tuple[str, str]:
        # base-4 digits of fam, and the same digits +1 mod 4: two distinct
        # fams differ in >=1 position of EACH half => pair distance >= 2
        digits = [(fam >> (2 * i)) & 3 for i in range(12)]
        u1 = "".join(BASES[d] for d in digits)
        u2 = "".join(BASES[(d + 1) & 3] for d in digits)
        return u1, u2

    ext = read_len + INDEL_MAX  # a deletion reads past the read length
    for fam in range(n_families):
        start = 10 + (fam * span) // n_families
        r2 = start + frag_len - read_len
        if not bisulfite:
            left = codes_to_seq(codes[start : start + ext])
            right = codes_to_seq(codes[r2 : r2 + ext])
        t = templates_for(fam) if templates_for else 1
        for strand, (lf, rf) in (("A", (99, 147)), ("B", (163, 83))):
            if bisulfite:
                left = bisulfite_convert(
                    genome_str[start : start + ext], genome_str, start, strand
                )
                right = bisulfite_convert(
                    genome_str[r2 : r2 + ext], genome_str, r2, strand
                )
            for ti in range(t):
                for flag, pos, mate, span_seq, tl in (
                    (lf, start, r2, left, frag_len),
                    (rf, r2, start, right, -frag_len),
                ):
                    seq, cigar = span_seq[:read_len], [(CMATCH, read_len)]
                    if indel_rate > 0:
                        seq, cigar = indel_read(span_seq, read_len, fam, ti, flag, indel_rate)
                    if mutate is not None:
                        seq = mutate(seq, fam, ti, flag)
                    rec = BamRecord(
                        qname=f"f{fam}:{strand}:{ti}", flag=flag, ref_id=0,
                        pos=pos, mapq=60, cigar=cigar,
                        next_ref_id=0, next_pos=mate, tlen=tl, seq=seq,
                        qual=qual_for(fam, ti, flag) if qual_for else default_qual,
                    )
                    if raw_umis:
                        u1, u2 = _fam_umi(fam)
                        a, b = (u1, u2) if strand == "A" else (u2, u1)
                        rec.set_tag("RX", f"{a}-{b}", "Z")
                    else:
                        rec.set_tag("RX", rx, "Z")
                        rec.set_tag("MI", f"{fam}/{strand}", "Z")
                    yield rec


#: longest indel indel_read makes
INDEL_MAX = 3


def _indel_hash(fam: int, ti: int, flag: int) -> int:
    h = ((fam * 1_000_003) ^ (ti * 7_919) ^ (flag * 104_729)) & 0xFFFFFFFF
    h = (h * 2_654_435_761) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 2_246_822_519) & 0xFFFFFFFF
    return h ^ (h >> 13)


def has_indel(fam: int, ti: int, flag: int, rate: float) -> bool:
    """Whether indel_read gives read (fam, ti, flag) an indel at `rate`."""
    return (_indel_hash(fam, ti, flag) % 100_000) < rate * 100_000


def indel_read(span_seq: str, read_len: int, fam: int, ti: int, flag: int,
               rate: float) -> tuple[str, list]:
    """(seq, cigar) of one read of `read_len` bases whose reference span
    starts span_seq (read_len + INDEL_MAX bases of its strand's sequence).
    A hash of (fam, ti, flag) gives `rate` of reads one 1-3 bp insertion
    or deletion: at the first homopolymer run of 3 or more that starts in
    a 30-base window past a hashed offset in 20..read_len-50 (PCR stutter;
    else at the offset), an insertion repeating the base there or a
    deletion of the next bases, the CIGAR M/I/D to match. One in 16 indel
    reads turns random past the indel (a read the banded aligner must
    refuse). Every other read is the span's first read_len bases, all M."""
    from bsseqconsensusreads_tpu_torch.io.bam import CDEL, CINS

    h = _indel_hash(fam, ti, flag)
    if not has_indel(fam, ti, flag, rate):
        return span_seq[:read_len], [(CMATCH, read_len)]
    k = 1 + (h >> 17) % INDEL_MAX
    p = 20 + (h >> 3) % max(read_len - 70, 1)
    for q in range(p, min(p + 30, read_len - 25)):
        if span_seq[q] == span_seq[q + 1] == span_seq[q + 2]:
            p = q
            break
    if (h >> 20) & 1:  # deletion of k reference bases at read offset p
        seq = span_seq[:p] + span_seq[p + k : read_len + k]
        cigar = [(CMATCH, p), (CDEL, k), (CMATCH, read_len - p)]
    else:  # insertion of k copies of the base at p
        seq = span_seq[:p] + span_seq[p] * k + span_seq[p : read_len - k]
        cigar = [(CMATCH, p), (CINS, k), (CMATCH, read_len - p - k)]
    if (h >> 24) % 16 == 0:  # garbage past the indel
        tail = "".join(BASES[(h >> (2 * (i % 12))) & 3 ^ (i & 3)] for i in range(read_len - p - k))
        seq = seq[: p + k] + tail
    return seq, cigar


def passthrough_leftovers(records) -> list:
    """Records the duplex stage cannot tensorize, made from an aligned
    molecular consensus stream (MI-tagged 99/147/163/83 records): for
    successive families, a flag-0 and a flag-1 copy, a duplicated 83, a
    softclipped duplicate 163, an 83 with an insertion and a hard-clipped
    163 — each a new qname in its source family. Under duplex passthrough
    the first two pass verbatim / convert, the duplicate and the softclip
    convert, the indel read is dropped, and the hard-clipped read never
    becomes a leftover (the stage drops it)."""
    from bsseqconsensusreads_tpu_torch.io.bam import CHARD_CLIP, CINS, CSOFT_CLIP

    by_family: dict = {}
    for rec in records:
        by_family.setdefault(str(rec.get_tag("MI")).split("/")[0], {})[rec.flag] = rec
    out = []
    # each kind and the flag of the family record it copies
    kinds = (("flag0", 99), ("flag1", 163), ("dup83", 83), ("softclip163", 163),
             ("indel83", 83), ("hardclip163", 163))
    fams = [f for f in by_family.values() if 83 in f and 163 in f and 99 in f]
    for (kind, flag), fam in zip(kinds, fams[1::2]):
        src = fam[flag]
        rec = src.copy()
        rec.qname = f"{src.qname}:{kind}"
        n = len(rec.seq)
        if kind == "flag0":
            rec.flag = 0
        elif kind == "flag1":
            rec.flag = 1
        elif kind == "softclip163":
            rec.cigar = [(CSOFT_CLIP, 5), (CMATCH, n - 5)]
            rec.pos += 5
        elif kind == "indel83":
            rec.cigar = [(CMATCH, 10), (CINS, 2), (CMATCH, n - 12)]
        elif kind == "hardclip163":
            rec.cigar = [(CHARD_CLIP, 5), (CMATCH, n)]
        out.append(rec)
    return out


#: the JAX package's native libraries its reference legs load, and the
#: modules that cache their load (a failed load is cached per process)
REFERENCE_NATIVES = {
    "libbamio.so": "bsseqconsensusreads_tpu.io.native",
    "libwirepack.so": "bsseqconsensusreads_tpu.io.wirepack",
}


def _stale(so_path: str, source: str) -> bool:
    """make's rule for one library: missing, or older than its source."""
    try:
        return os.path.getmtime(so_path) < os.path.getmtime(source)
    except FileNotFoundError:
        return True


def ensure_reference_natives(repo: str, timeout: float = 180.0) -> None:
    """Make the JAX package's native/ libraries loadable before a test's
    reference leg takes them (tests only: this imports nothing of that
    package). A library that is missing or older than its source is built
    by native/Makefile's own rule, under a file lock, into a directory of
    its own, then renamed over native/<so> (os.replace): a process that
    loads native/<so> meanwhile sees the old file or the whole new one,
    never a file this build is still writing ("file too short"). The JAX
    package's loader still builds a missing library in place, so each
    library is then loaded until it loads (bounded by `timeout`), and a
    failed load that a reference module cached is cleared, so its next
    use loads again. Raises RuntimeError when a library never loads."""
    native = os.path.join(repo, "native")
    lock_dir = os.path.join(repo, "build", "torch_kernels")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "reference_natives.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        for so in REFERENCE_NATIVES:
            path = os.path.join(native, so)
            if not _stale(path, os.path.join(native, so[3:-3] + ".cpp")):
                continue
            out = tempfile.mkdtemp(prefix="native-", dir=lock_dir)
            try:
                subprocess.run(["make", "-C", out, "-f", os.path.join(native, "Makefile"),
                                f"--eval=vpath %.cpp {native}", so],
                               capture_output=True, timeout=timeout)
                if os.path.exists(os.path.join(out, so)):
                    os.replace(os.path.join(out, so), path)
            finally:
                shutil.rmtree(out, ignore_errors=True)
    deadline = time.monotonic() + timeout
    for so in REFERENCE_NATIVES:
        path = os.path.join(native, so)
        while True:
            try:
                # graftlint: disable=kernel-rebuild -- test helper: loads each reference
                # library once, a bounded wait for another process's build
                ctypes.CDLL(path)
                break
            except OSError as exc:
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"{path} does not load: {exc}") from None
                time.sleep(0.2)
    for module in REFERENCE_NATIVES.values():
        mod = sys.modules.get(module)
        if mod is not None and getattr(mod, "_lib", None) is None:
            mod._load_error = None
