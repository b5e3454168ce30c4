"""Streaming UMI grouping — fgbio GroupReadsByUmi equivalent.

The port's copy of the JAX package's pipeline/group_umi.py, over the
port's io.bam codec and pipeline.extsort spill/merge machinery; the same
bytes for the same input.

The reference pipeline *assumes* its input BAM was produced by
`fgbio GroupReadsByUmi -s Paired` (reference README.md:7,51-55: RX = raw
UMI pair, MI = molecule id with an /A or /B strand suffix). That step is
the last fgbio capability a user of this framework would still need the
JVM for; this module removes it, so the framework covers the whole path
from a raw aligned duplex BAM to unfiltered duplex consensus.

Semantics are built from fgbio's published strategy descriptions (the
tool help for GroupReadsByUmi) and the umi_tools "directional adjacency"
method its Adjacency/Paired strategies derive from — not from fgbio
source code:

* Templates are grouped by the unclipped 5' positions + strands of both
  ends (both strands of one duplex molecule share that key: the A-strand
  template 99/147 and B-strand template 83/163 cover the same fragment).
* Within a position group, raw UMIs cluster by at most `edits`
  mismatches.  `identity` = exact match; `edit` = connected components;
  `adjacency` = count-directional absorption (a lower-count UMI joins a
  higher-count neighbor when count(parent) >= 2*count(child) - 1,
  chained breadth-first from the most-observed UMI);
  `paired` = adjacency over *strand-canonicalized* duplex pairs.
* `paired` canonical form: a template whose R1 maps to the forward
  strand (the 99/147 orientation) reads its RX `a-b` as-is; the
  opposite orientation (83/163) observed `b-a` off the other physical
  strand, so its halves swap before clustering.  Members keep their
  orientation as the MI suffix: /A for the forward-R1 orientation, /B
  for the reverse — deterministic, and symmetric downstream (the duplex
  caller treats the strands identically; fgbio documents the A/B
  labels as arbitrary strand designations).

Like every sort-shaped stage here, the implementation is two bounded-
memory external passes (pipeline.extsort) instead of fgbio's in-heap
grouping: a queryname pass to see both ends of each template, then a
position-key pass that streams one position bucket at a time.  Host RAM
is O(buffer + largest position bucket), never O(file).  Both passes run
over RAW encoded record blobs (keys at fixed byte offsets, template
metadata in a sortable composite prefix, MI spliced into the blob's tag
region), so records decode exactly once and spill shards never pay an
object round-trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import struct
import time

import numpy as np

from bsseqconsensusreads_tpu_torch.io.bam import (
    BamHeader,
    BamRecord,
    CHARD_CLIP,
    CSOFT_CLIP,
    FREAD2,
    decode_record,
    skip_tag,
    tag_region_offset,
)
from bsseqconsensusreads_tpu_torch.pipeline.extsort import (
    DEFAULT_BUFFER_RECORDS,
    external_sort_raw,
    iter_record_blobs,
    raw_name_key,
)

STRATEGIES = ("identity", "edit", "adjacency", "paired")

#: fixed byte width of _position_key's packed string (two ends of
#: 7+9+1 hex chars each) — the composite key parser slices on it.
_POSKEY_WIDTH = 34


@dataclass
class GroupStats:
    """Counters for one grouping run (surfaced by the CLI / stage)."""

    records_in: int = 0
    templates: int = 0
    accepted: int = 0
    dropped_secondary: int = 0
    dropped_unmapped: int = 0
    dropped_mapq: int = 0
    dropped_no_umi: int = 0
    dropped_n_umi: int = 0
    dropped_unpaired: int = 0
    molecules: int = 0
    position_groups: int = 0
    wall_seconds: float = 0.0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["wall_seconds"] = round(d["wall_seconds"], 3)
        return d


# ---- template geometry ----------------------------------------------------


def _clips(cigar: list[tuple[int, int]]) -> tuple[int, int]:
    """(leading, trailing) soft+hard clipped bases of a CIGAR."""
    lead = trail = 0
    for op, ln in cigar:
        if op in (CSOFT_CLIP, CHARD_CLIP):
            lead += ln
        else:
            break
    for op, ln in reversed(cigar):
        if op in (CSOFT_CLIP, CHARD_CLIP):
            trail += ln
        else:
            break
    return lead, trail


def unclipped_end5(rec: BamRecord) -> int:
    """Unclipped 5'-most reference position of a mapped record: the
    coordinate the first sequenced base would occupy had the aligner not
    clipped it.  Clip-invariant, so both strands of a duplex molecule
    agree on it even when their softclips differ."""
    lead, trail = _clips(rec.cigar)
    if rec.is_reverse:
        return rec.reference_end - 1 + trail
    return rec.pos - lead


def _end_key(rec: BamRecord) -> tuple[int, int, int]:
    return (rec.ref_id, unclipped_end5(rec), int(rec.is_reverse))


def _position_key(reads: list[BamRecord]) -> str:
    """Orientation-normalized both-end key, packed as a fixed-width string
    (so it string-sorts in genomic order through the raw spill shards).
    Single-end templates use a sentinel upper end."""
    ends = sorted(_end_key(r) for r in reads)
    if len(ends) == 1:
        ends.append((0x7FFFFFF, 0, 0))
    for ref, pos, _rev in ends:
        # The packed fields are fixed-width (7 hex ref, 9 hex pos) so the
        # composite sorts lexicographically == genomically and pass 2 can
        # slice on _POSKEY_WIDTH.  An unclipped 5' start below -4096
        # (>4 kb leading clip — long-read input, outside this pipeline's
        # short-read envelope) or past 9 hex digits would format out of
        # width and silently corrupt bucket boundaries; fail loudly.
        if not (0 <= pos + 4096 <= 0xFFFFFFFFF) or not (
            0 <= ref + 1 <= 0xFFFFFFF
        ):
            raise ValueError(
                f"unclipped template end (ref={ref}, pos={pos}) outside "
                "the packable grouping envelope "
                "(-4096 <= pos < 16**9 - 4096); input is not short-read "
                "duplex data this grouper supports"
            )
    return "".join(
        f"{ref + 1:07x}{pos + 4096:09x}{rev:d}" for ref, pos, rev in ends
    )


def _is_top_strand(reads: list[BamRecord]) -> bool:
    """/A vs /B orientation: a template is top-strand when its R1 maps
    forward (the 99/147 duplex orientation; 83/163 is the bottom strand).
    Deterministic for every input; for the FR duplex libraries this
    pipeline targets it matches the physical strand of the source
    molecule."""
    for r in reads:
        if r.is_read1:
            return not r.is_reverse
    return not reads[0].is_reverse  # fragment read / R1 missing


# ---- UMI clustering -------------------------------------------------------


class _UmiIndex:
    """Mismatch-neighbor queries over one position bucket's distinct UMIs,
    vectorized per length class (one uint8 matrix compare per query
    instead of a Python loop — deep buckets in high-duplication libraries
    hold hundreds of distinct UMIs)."""

    def __init__(self, umis: list[str]):
        self.by_len: dict[int, tuple[list[str], np.ndarray]] = {}
        for ln in {len(u) for u in umis}:
            same = [u for u in umis if len(u) == ln]
            mat = np.frombuffer(
                "".join(same).encode("ascii"), dtype=np.uint8
            ).reshape(len(same), ln)
            self.by_len[ln] = (same, mat)

    def neighbors(self, umi: str, edits: int) -> list[str]:
        entry = self.by_len.get(len(umi))
        if entry is None:
            return []
        same, mat = entry
        q = np.frombuffer(umi.encode("ascii"), dtype=np.uint8)
        dist = (mat != q).sum(axis=1)
        return [same[i] for i in np.nonzero(dist <= edits)[0]]


def cluster_umis(
    counts: dict[str, int], strategy: str, edits: int
) -> dict[str, str]:
    """Map each UMI to its cluster root.  Roots are visited most-observed
    first (ties lexicographic), so molecule numbering is deterministic."""
    if strategy == "identity" or edits == 0:
        return {u: u for u in counts}
    order = sorted(counts, key=lambda u: (-counts[u], u))
    index = _UmiIndex(order)
    assigned: dict[str, str] = {}
    directional = strategy in ("adjacency", "paired")
    for root in order:
        if root in assigned:
            continue
        assigned[root] = root
        frontier = [root]
        while frontier:
            parent = frontier.pop()
            for cand in index.neighbors(parent, edits):
                if cand in assigned:
                    continue
                if directional and counts[parent] < 2 * counts[cand] - 1:
                    continue
                assigned[cand] = root
                frontier.append(cand)
    return assigned


# ---- the two-pass streaming grouper ---------------------------------------
#
# Both passes run over RAW encoded record blobs (pipeline.extsort
# external_sort_raw): pass 1 sorts by queryname at fixed blob offsets
# without decoding anything; pass 2 sorts composite blobs whose byte
# prefix IS the (position key, canonical UMI, qname, read2, flag)
# ordering, with the untouched record blob riding behind it.  Records
# decode exactly once (template annotation; the MI emit is a raw tag
# splice, _patch_mi) regardless of how many spill passes the sorts take —
# the object-per-record spill cost that dominates at the 100M-read scale
# never occurs.


def _iter_raw_templates(
    blobs: Iterable[bytes],
) -> Iterator[list[tuple[BamRecord, bytes]]]:
    """Group a queryname-sorted raw-blob stream into per-template
    (decoded record, original blob) lists."""
    bucket: list[tuple[BamRecord, bytes]] = []
    qname: bytes | None = None
    for blob in blobs:
        q = blob[36 : 36 + blob[12] - 1]
        if bucket and q != qname:
            yield bucket
            bucket = []
        qname = q
        bucket.append((decode_record(blob[4:]), blob))
    if bucket:
        yield bucket


def _composite(poskey: str, umi: str, strand: str, rec: BamRecord,
               blob: bytes) -> bytes:
    """[u32 size][u16 keylen][key][record blob].  The key byte string —
    poskey (fixed width) ++ umi ++ NUL ++ qname ++ NUL ++ read2-bit ++
    flag(be16) ++ strand — compares lexicographically exactly like the
    record_ops.name_key ordering extended with (poskey, umi) in front,
    so pass 2 orders on a bytes slice and a template's records leave it
    name-ordered (R1 before R2 whatever other flag bits are set)."""
    key = (
        poskey.encode("ascii")
        + umi.encode("ascii") + b"\x00"
        + rec.qname.encode("ascii") + b"\x00"
        + bytes([bool(rec.flag & FREAD2)])
        + rec.flag.to_bytes(2, "big")
        + strand.encode("ascii")
    )
    payload = struct.pack("<H", len(key)) + key + blob
    return struct.pack("<i", len(payload)) + payload


def _composite_key(blob: bytes) -> bytes:
    (klen,) = struct.unpack_from("<H", blob, 4)
    return blob[6 : 6 + klen]


def _parse_composite(blob: bytes) -> tuple[str, str, str, str, bytes]:
    """(poskey, umi, qname, strand, record blob) of a composite."""
    (klen,) = struct.unpack_from("<H", blob, 4)
    key = blob[6 : 6 + klen]
    poskey = key[:_POSKEY_WIDTH].decode("ascii")
    umi_end = key.index(0, _POSKEY_WIDTH)
    qname_end = key.index(0, umi_end + 1)
    return (
        poskey,
        key[_POSKEY_WIDTH:umi_end].decode("ascii"),
        key[umi_end + 1 : qname_end].decode("ascii"),
        chr(key[-1]),
        blob[6 + klen :],
    )


def _annotate_composites(
    records,
    header: BamHeader,
    strategy: str,
    raw_tag: str,
    min_map_q: int,
    stats: GroupStats,
    workdir: str | None,
    buffer_records: int,
) -> Iterator[bytes]:
    """Pass 1: queryname raw external sort, then emit every accepted
    template's records as position-keyed composite blobs, applying
    fgbio's input filters."""
    raw = getattr(records, "raw_records", None)
    blobs = raw() if raw is not None else iter_record_blobs(records)

    def counted(src: Iterable[bytes]) -> Iterator[bytes]:
        for blob in src:
            # graftlint: disable=thread-unsafe-mutation -- the grouping stage runs on
            # one thread; the worker edge is a basename match
            stats.records_in += 1
            yield blob

    name_sorted = external_sort_raw(
        counted(blobs), header,
        workdir=workdir, buffer_records=buffer_records, key=raw_name_key,
    )
    for template in _iter_raw_templates(name_sorted):
        stats.templates += 1
        primaries = []
        for rec, blob in template:
            if rec.is_secondary or rec.is_supplementary:
                stats.dropped_secondary += 1
            else:
                primaries.append((rec, blob))
        if not primaries:
            continue
        if any(r.is_unmapped for r, _ in primaries):
            stats.dropped_unmapped += 1
            continue
        if any(r.mapq < min_map_q for r, _ in primaries):
            stats.dropped_mapq += 1
            continue
        if strategy == "paired" and len(primaries) != 2:
            stats.dropped_unpaired += 1
            continue
        reads = [r for r, _ in primaries]
        umis = {
            str(r.get_tag(raw_tag)) for r in reads if r.has_tag(raw_tag)
        }
        if len(umis) > 1:  # fgbio errors on R1/R2 UMI disagreement too
            raise ValueError(
                f"inconsistent {raw_tag} tags within template "
                f"{reads[0].qname}: {sorted(umis)}"
            )
        rx = umis.pop() if umis else None
        if not rx:
            stats.dropped_no_umi += 1
            continue
        if strategy == "paired":
            halves = str(rx).split("-")
            if len(halves) != 2:
                raise ValueError(
                    f"paired strategy needs duplex UMIs 'a-b'; "
                    f"{reads[0].qname} has {raw_tag}={rx!r}"
                )
            top = _is_top_strand(reads)
            a, b = halves if top else halves[::-1]
            canonical = f"{a}-{b}"
            strand = "A" if top else "B"
        else:
            canonical = str(rx)
            strand = "A"
        if "N" in canonical.upper():
            # fgbio GroupReadsByUmi drops templates whose UMI contains an
            # N base (it cannot participate in mismatch clustering); keep
            # parity rather than letting it seed its own molecule.  After
            # the format checks so a malformed duplex UMI still raises.
            stats.dropped_n_umi += 1
            continue
        poskey = _position_key(reads)
        stats.accepted += 1
        for rec, blob in primaries:
            yield _composite(poskey, canonical, strand, rec, blob)


def _patch_mi(blob: bytes, mi: str) -> bytes:
    """Rewrite a record blob's MI tag without decoding the record: walk
    the tag region (io.bam.skip_tag — the codec's own tag widths),
    splice out any existing MI, append the new one, and fix the
    block_size prefix.  For MI-less input (the normal grouping case) the
    bytes equal what decode -> set_tag -> encode would produce; a
    replaced MI moves to the tag tail (tag order is not semantic)."""
    off = tag_region_offset(blob)
    n = len(blob)
    spans = []  # every existing MI (malformed duplicates included)
    while off < n:
        start = off
        off = skip_tag(blob, off)
        if blob[start : start + 2] == b"MI":
            spans.append((start, off))
    body = bytearray()
    prev = 4
    for start, end in spans:
        body += blob[prev:start]
        prev = end
    body += blob[prev:]
    body += b"MIZ" + mi.encode("ascii") + b"\x00"
    return struct.pack("<i", len(body)) + bytes(body)


def _emit_bucket(
    bucket: dict[str, tuple[str, str, list[bytes]]],
    strategy: str,
    edits: int,
    next_mi: int,
    stats: GroupStats,
) -> tuple[list[bytes], int]:
    """Cluster one position bucket's templates and emit them MI-grouped
    (as patched raw blobs): molecules in root order, /A templates before
    /B, reads name-ordered within a template (pass 2's composite order
    already interleaves a template's records name-contiguously)."""
    stats.position_groups += 1
    counts: dict[str, int] = {}
    for umi, _strand, _blobs in bucket.values():
        counts[umi] = counts.get(umi, 0) + 1
    roots = cluster_umis(counts, strategy, edits)
    root_order = sorted(
        set(roots.values()), key=lambda u: (-counts[u], u)
    )
    mi_of = {}
    for root in root_order:
        mi_of[root] = next_mi
        next_mi += 1
    stats.molecules += len(root_order)

    def sort_key(item):
        qname, (umi, strand, _blobs) = item
        return (mi_of[roots[umi]], strand, qname)

    out: list[bytes] = []
    for qname, (umi, strand, blobs) in sorted(
        bucket.items(), key=sort_key
    ):
        mi = str(mi_of[roots[umi]])
        if strategy == "paired":
            mi = f"{mi}/{strand}"
        for blob in blobs:
            out.append(_patch_mi(blob, mi))
    return out, next_mi


def group_reads_by_umi_raw(
    records,
    header: BamHeader,
    strategy: str = "paired",
    edits: int = 1,
    raw_tag: str = "RX",
    min_map_q: int = 1,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    stats: GroupStats | None = None,
) -> Iterator[bytes]:
    """Stream `records` (a BamReader, BamRecord iterable, or raw-blob
    source — any order) back out MI-grouped as ENCODED record blobs —
    the fgbio GroupReadsByUmi equivalent (reference README.md:51-55
    input contract).  Output records carry MI = sequential molecule id
    (with /A|/B strand suffixes under the paired strategy), grouped
    molecule-contiguously in genomic position order.  Bounded host
    memory at any input size; no per-record encode on the way out
    (BamWriter.write_raw_many takes the blobs as-is)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    if edits < 0:
        raise ValueError(f"edits must be >= 0, got {edits}")
    stats = stats if stats is not None else GroupStats()
    t0 = time.monotonic()

    composites = _annotate_composites(
        records, header, strategy, raw_tag, min_map_q, stats,
        workdir, buffer_records,
    )
    by_position = external_sort_raw(
        composites, header,
        workdir=workdir, buffer_records=buffer_records, key=_composite_key,
    )

    next_mi = 0
    bucket: dict[str, tuple[str, str, list[bytes]]] = {}
    bucket_poskey: str | None = None
    for comp in by_position:
        poskey, umi, qname, strand, blob = _parse_composite(comp)
        if bucket_poskey is not None and poskey != bucket_poskey:
            out, next_mi = _emit_bucket(bucket, strategy, edits, next_mi, stats)
            yield from out
            bucket = {}
        bucket_poskey = poskey
        entry = bucket.get(qname)
        if entry is None:
            bucket[qname] = (umi, strand, [blob])
        else:
            entry[2].append(blob)
    if bucket:
        out, _ = _emit_bucket(bucket, strategy, edits, next_mi, stats)
        yield from out
    stats.wall_seconds += time.monotonic() - t0


def group_reads_by_umi(
    records,
    header: BamHeader,
    strategy: str = "paired",
    edits: int = 1,
    raw_tag: str = "RX",
    min_map_q: int = 1,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    stats: GroupStats | None = None,
) -> Iterator[BamRecord]:
    """Record-object view of group_reads_by_umi_raw (same arguments).
    Production writers should prefer the raw variant + write_raw_many;
    this wrapper decodes each emitted blob once."""
    for blob in group_reads_by_umi_raw(
        records, header, strategy, edits, raw_tag, min_map_q,
        workdir, buffer_records, stats,
    ):
        yield decode_record(blob[4:])


def grouped_header(header: BamHeader) -> BamHeader:
    """Output header: grouping invalidates any coordinate sort; records
    leave template-grouped (the property fgbio's downstream consumers —
    and this framework's molecular stage — rely on)."""
    return header.with_sort_order("unsorted", "unsorted:umi-group")
