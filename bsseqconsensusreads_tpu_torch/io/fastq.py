"""FASTQ writing — replacement for Picard SamToFastq.

The port's copy of the JAX package's io/fastq.py. The reference shells
out to `java -jar picard SamToFastq I=… F=… F2=…` (main.snake.py:67,79,176)
to split an unaligned consensus BAM into a gzipped R1/R2 FASTQ pair. This
module does the same from BamRecords: read1 -> F, read2 -> F2,
reverse-strand records are reverse-complemented back to sequencing
orientation (Picard's default behavior).
"""

from __future__ import annotations

import gzip
from typing import Iterable

from bsseqconsensusreads_tpu_torch.io.bam import FREAD2, FREVERSE, BamRecord

_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def qual_to_ascii(qual: bytes | None, length: int) -> str:
    if qual is None:
        return "!" * length
    return "".join(chr(min(q, 93) + 33) for q in qual)


def _fq_entry(rec: BamRecord, role: int) -> str:
    seq, qual = rec.seq, qual_to_ascii(rec.qual, len(rec.seq))
    if rec.flag & FREVERSE:
        seq = reverse_complement(seq)
        qual = qual[::-1]
    return f"@{rec.qname}/{role}\n{seq}\n+\n{qual}\n"


def sam_to_fastq(records: Iterable[BamRecord], fq1_path: str, fq2_path: str) -> tuple[int, int]:
    """Split records into paired gzipped FASTQs; returns (n_r1, n_r2).

    Pairs are matched by qname and written in step: the two files always
    hold the same templates at the same line offsets, because paired
    aligners pair entries positionally. Records without a same-name mate
    of the opposite read-of-pair are skipped, as Picard SamToFastq
    refuses incomplete pairs."""
    n1 = n2 = 0
    pending: dict[str, BamRecord] = {}
    with gzip.open(fq1_path, "wt") as f1, gzip.open(fq2_path, "wt") as f2:
        for rec in records:
            if rec.flag & 0x900:  # secondary/supplementary never exported
                continue
            mate = pending.get(rec.qname)
            if mate is None or bool(mate.flag & FREAD2) == bool(rec.flag & FREAD2):
                pending[rec.qname] = rec  # first of the pair (or duplicate)
                continue
            del pending[rec.qname]
            r1, r2 = (mate, rec) if rec.flag & FREAD2 else (rec, mate)
            f1.write(_fq_entry(r1, 1))
            f2.write(_fq_entry(r2, 2))
            n1 += 1
            n2 += 1
    return n1, n2
