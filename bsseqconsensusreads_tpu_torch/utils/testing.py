"""Synthetic data generators for tests and the chip smoke.

The port's copy of random_genome, write_fasta, bisulfite_convert and
stream_duplex_families from the JAX package's utils/testing.py, so that
chip_smoke.py can make its input without the JAX package. Same generation
scheme, same records for the same arguments.
"""

from __future__ import annotations

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

    for fam in range(n_families):
        start = 10 + (fam * span) // n_families
        r2 = start + frag_len - read_len
        if not bisulfite:
            left = codes_to_seq(codes[start : start + read_len])
            right = codes_to_seq(codes[r2 : r2 + read_len])
        t = templates_for(fam) if templates_for else 1
        for strand, (lf, rf) in (("A", (99, 147)), ("B", (163, 83))):
            if bisulfite:
                left = bisulfite_convert(
                    genome_str[start : start + read_len], genome_str, start, strand
                )
                right = bisulfite_convert(
                    genome_str[r2 : r2 + read_len], genome_str, r2, strand
                )
            for ti in range(t):
                for flag, pos, mate, seq, tl in (
                    (lf, start, r2, left, frag_len),
                    (rf, r2, start, right, -frag_len),
                ):
                    if mutate is not None:
                        seq = mutate(seq, fam, ti, flag)
                    rec = BamRecord(
                        qname=f"f{fam}:{strand}:{ti}", flag=flag, ref_id=0,
                        pos=pos, mapq=60, cigar=[(CMATCH, read_len)],
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
