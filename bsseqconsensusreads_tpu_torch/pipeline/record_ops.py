"""Record-level BAM operations replacing the reference's external tools.

The port's copy of the JAX package's pipeline/record_ops.py. Each function
is the in-process equivalent of one shell step of the reference pipeline
(the rule that invokes the original is cited). Two tiers:

* in-memory list sorts (name_sort / coordinate_sort / …) for small inputs
  and tests;
* streaming variants over pipeline.extsort.external_sort — the
  production path, bounded host memory at any input size.
"""

from __future__ import annotations

from typing import Iterable, Iterator

from bsseqconsensusreads_tpu_torch.io.bam import (
    FREAD2,
    FREVERSE,
    FUNMAP,
    BamHeader,
    BamRecord,
)
from bsseqconsensusreads_tpu_torch.pipeline.extsort import (
    DEFAULT_BUFFER_RECORDS,
    external_sort,
)

#: Consensus/UMI tags ZipperBams grafts from the unaligned onto the aligned
#: record (attributes of the source molecule, not the alignment).
GRAFT_TAGS = (
    "MI", "RX", "cD", "cM", "cE", "cd", "ce", "cB",
    "aD", "bD", "aM", "bM", "ad", "bd", "ac", "bc",
)

#: Per-base tags that track record base order: when the aligner mapped the
#: read to the reverse strand, the grafted arrays flip with it.
_REVERSE_ARRAY_TAGS = frozenset(("cd", "ce", "ad", "bd"))
_REVCOMP_STRING_TAGS = frozenset(("ac", "bc"))


def _flip_tag(tag: str, val):
    """Reorient one per-base tag value for a reverse-strand graft target."""
    if tag in _REVERSE_ARRAY_TAGS:
        sub, vals = val[1]
        return (val[0], (sub, list(vals)[::-1]))
    if tag == "cB":
        # 4 plane-major runs: complement the plane order (A<->T, C<->G)
        # and reverse columns
        sub, vals = val[1]
        vals = list(vals)
        n = len(vals) // 4
        planes = [vals[p * n : (p + 1) * n][::-1] for p in (3, 2, 1, 0)]
        return (val[0], (sub, [v for plane in planes for v in plane]))
    if tag in _REVCOMP_STRING_TAGS:
        from bsseqconsensusreads_tpu_torch.io.fastq import reverse_complement

        return (val[0], reverse_complement(val[1]))
    return val


def filter_mapped(records: Iterable[BamRecord]) -> Iterator[BamRecord]:
    """`samtools view -F 4` — drop unmapped records (main.snake.py:118)."""
    for rec in records:
        if not rec.flag & FUNMAP:
            yield rec


# ---- sort keys (shared by the in-memory and external sorts) ---------------


def name_key(r: BamRecord) -> tuple:
    """`samtools sort -n` order (main.snake.py:106): queryname, R1 before R2
    within a name."""
    return (r.qname, bool(r.flag & FREAD2), r.flag)


def coordinate_key(r: BamRecord) -> tuple:
    """Coordinate order: by (ref, pos); unmapped records go last."""
    return (
        r.ref_id if r.ref_id >= 0 else 1 << 30,
        r.pos if r.pos >= 0 else 1 << 30,
        r.qname,
        r.flag,
    )


def template_coordinate_key(r: BamRecord) -> tuple:
    """`fgbio SortBam -s TemplateCoordinate` (main.snake.py:152): both
    strands of a duplex group become adjacent. Key: (ref, min(pos,
    matepos), MI-without-suffix, qname, flag)."""
    mi = str(r.get_tag("MI")).split("/")[0] if r.has_tag("MI") else ""
    lo = min(
        r.pos if r.pos >= 0 else 1 << 30,
        r.next_pos if r.next_pos >= 0 else 1 << 30,
    )
    return (r.ref_id if r.ref_id >= 0 else 1 << 30, lo, mi, r.qname, r.flag)


# ---- in-memory sorts (small inputs / tests) -------------------------------


def name_sort(records: Iterable[BamRecord]) -> list[BamRecord]:
    return sorted(records, key=name_key)


def coordinate_sort(records: Iterable[BamRecord]) -> list[BamRecord]:
    return sorted(records, key=coordinate_key)


def template_coordinate_sort(records: Iterable[BamRecord]) -> list[BamRecord]:
    return sorted(records, key=template_coordinate_key)


# ---- streaming production path --------------------------------------------


def _graft(rec: BamRecord, src: BamRecord, tags: tuple[str, ...]) -> None:
    # the unaligned source stores SEQ in sequencing orientation; a
    # reverse-strand alignment stores revcomp(SEQ), so per-base tags
    # reorient with it (see _flip_tag)
    flip = bool(rec.flag & FREVERSE) and not bool(src.flag & FREVERSE)
    for tag in tags:
        if src.has_tag(tag) and not rec.has_tag(tag):
            val = src.tags[tag]
            rec.tags[tag] = _flip_tag(tag, val) if flip else val


def zipper_bams_stream(
    aligned: Iterable[BamRecord],
    unaligned: Iterable[BamRecord],
    header: BamHeader,
    tags: tuple[str, ...] = GRAFT_TAGS,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
) -> Iterator[BamRecord]:
    """`fgbio ZipperBams --unmapped … --sort Coordinate` (main.snake.py:106)
    with bounded memory: graft molecule-level tags from the unaligned
    consensus BAM onto the aligned records, emit in coordinate order.
    Both sides are externally name-sorted and joined by a streaming
    two-pointer walk on (qname, read-of-pair); aligned records with no
    unaligned partner pass through untouched."""

    def join_key(r: BamRecord) -> tuple:
        return (r.qname, bool(r.flag & FREAD2))

    def joined() -> Iterator[BamRecord]:
        a_iter = external_sort(aligned, name_key, header, workdir, buffer_records)
        u_iter = external_sort(unaligned, name_key, header, workdir, buffer_records)
        u = next(u_iter, None)
        for rec in a_iter:
            ka = join_key(rec)
            while u is not None and join_key(u) < ka:
                u = next(u_iter, None)
            if u is not None and join_key(u) == ka:
                _graft(rec, u, tags)
            yield rec

    yield from external_sort(joined(), coordinate_key, header, workdir, buffer_records)


def zipper_bams(
    aligned: Iterable[BamRecord],
    unaligned: Iterable[BamRecord],
    tags: tuple[str, ...] = GRAFT_TAGS,
) -> list[BamRecord]:
    """In-memory zipper (see zipper_bams_stream for the production path)."""
    lookup: dict[tuple[str, bool], BamRecord] = {}
    for rec in unaligned:
        lookup[(rec.qname, bool(rec.flag & FREAD2))] = rec
    out = []
    for rec in aligned:
        src = lookup.get((rec.qname, bool(rec.flag & FREAD2)))
        if src is not None:
            _graft(rec, src, tags)
        out.append(rec)
    return coordinate_sort(out)
