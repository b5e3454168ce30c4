"""Consensus filtering — fgbio FilterConsensusReads equivalent.

The port's copy of the JAX package's pipeline/filter.py; the same records
and counters for the same input. One engine, filter_consensus_raw, runs
_evaluate over encoded record blobs: a kept record leaves as its input
bytes with the masked bases' nibbles and quals patched. That is what the
JAX package's decode -> mask -> encode writes for every record the codec
round-trips — the consensus stages' own output, which the stages filter
as it is. filter_consensus is the JAX package's record-object API over
that engine; the `filter-consensus` subcommand re-encodes each record it
reads first, so a file from another writer gets the JAX package's bytes.

The reference pipeline is deliberately UNFILTERED (`--min-reads=0`,
reference README.md:9), but its authors left behind the evidence of a
filtered variant: a dead rule reading `…_molecular_filtered.bam` that no
rule produces (reference main.snake.py:70-80; SURVEY.md §7.3 "known
quirks").  This module supplies that missing step from fgbio's published
FilterConsensusReads semantics, so users who filter consensus output
(most production duplex workflows do) stay inside the framework.

Semantics (from the fgbio tool's published docs, not its source):

* read-level: a consensus read is DROPPED when its depth is below
  ``min_reads`` (a 1-3 value triplet ``M [A B]``; for duplex reads the
  total, larger-strand, and smaller-strand depths are tested against
  M/A/B respectively, using the cD / aD / bD tags) or its error rate
  exceeds ``max_read_error_rate`` — tested against the duplex cE AND
  each single-strand rate (aE/bE) when present, as fgbio does;
  optionally when its mean base quality is below
  ``min_mean_base_quality``.  If any read of a template fails, the
  WHOLE template is dropped — consensus BAMs must stay pair-complete.
* base-level: a base is MASKED to N (qual 2) when its per-base depth
  (cd, and ad/bd for duplex, against the same M/A/B triplet) falls
  short, its per-base error rate (ce/cd, and the per-strand ae/ad,
  be/bd on duplex input) exceeds ``max_base_error_rate``, or its
  quality is below ``min_base_quality``.  After masking, reads whose
  no-call fraction exceeds ``max_no_call_fraction`` are dropped (with
  their mates).

Deviations (documented per the §7.3 mandate):

* ``--require-single-strand-agreement`` consumes the ac/bc per-strand
  consensus call strings this framework's duplex emitter writes
  (pipeline.calling._duplex_rawize, the fgbio tag surface): a base is
  masked when BOTH strands called and the calls differ. Requesting it
  on input without ac/bc (foreign duplex BAMs, strand_tags=False
  output) raises — silently skipping the check would pass disagreeing
  bases through a filter the user asked for.
* Per-base arrays are taken in the record's emitted base order (this
  framework's own emitters, pipeline.calling, write them that way).
* **Duplex depth units are RAW** (fgbio's): the duplex stage threads the
  molecular stage's cd/ce tags through its emitters
  (pipeline.calling._duplex_rawize), so ad/bd/cd on duplex output count
  raw per-read strand depths and fgbio-style ``-M 3 2 1`` floors work
  directly.  Only when the duplex input lacks cd/ce (consensus reads
  produced outside this framework) do ad/bd degrade to strand-consensus
  presence (0/1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

import struct

from bsseqconsensusreads_tpu_torch.io.bam import (
    _NT16_PAIRS,
    _TAG_NP_DTYPE,
    BamHeader,
    BamRecord,
    _decode_tags,
    decode_record,
    encode_record,
    skip_tag,
    tag_region_offset,
)

#: Phred score written into masked (no-call) positions, fgbio convention.
_MASK_QUAL = 2


@dataclass(frozen=True)
class FilterParams:
    """Knobs of the fgbio tool, defaults following its published ones."""

    min_reads: tuple[int, ...] = (1,)
    max_read_error_rate: float = 0.025
    max_base_error_rate: float = 0.1
    min_base_quality: int = 1
    max_no_call_fraction: float = 0.1
    min_mean_base_quality: float | None = None
    require_single_strand_agreement: bool = False

    def __post_init__(self):
        if not 1 <= len(self.min_reads) <= 3:
            raise ValueError(
                f"min_reads takes 1-3 values (M [A B]), got {self.min_reads}"
            )
        if list(self.min_reads) != sorted(self.min_reads, reverse=True):
            raise ValueError(
                f"min_reads triplet must be non-increasing (M >= A >= B), "
                f"got {self.min_reads}"
            )

    @property
    def triplet(self) -> tuple[int, int, int]:
        m = self.min_reads[0]
        a = self.min_reads[1] if len(self.min_reads) > 1 else m
        b = self.min_reads[2] if len(self.min_reads) > 2 else a
        return m, a, b


@dataclass
class FilterStats:
    """Counters: records_in = kept_records + dropped_records always
    reconciles; the dropped_* reason counters are per TEMPLATE (first
    failing read's reason — drops are template-atomic)."""

    records_in: int = 0
    templates: int = 0
    kept_records: int = 0
    dropped_records: int = 0
    dropped_depth: int = 0
    dropped_error_rate: int = 0
    dropped_mean_quality: int = 0
    dropped_no_call: int = 0
    masked_bases: int = 0
    total_bases: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def _tag_array(rec: _RawView, key: str) -> np.ndarray | None:
    if not rec.has_tag(key):
        return None
    _sub, vals = rec.get_tag(key)
    return np.asarray(vals, dtype=np.int64)


def _evaluate(
    rec: _RawView, params: FilterParams
) -> tuple[bool, str | None, np.ndarray | None]:
    """(keep, drop_reason, mask) for one consensus read.  mask is the
    boolean no-call vector to apply when the whole template survives."""
    m, a, b = params.triplet
    cd = _tag_array(rec, "cd")
    if cd is None:
        raise ValueError(
            f"{rec.qname} has no cd per-base depth tag; input must be "
            "consensus output (CallMolecular/CallDuplex equivalents)"
        )
    ad, bd = _tag_array(rec, "ad"), _tag_array(rec, "bd")
    ad_lab, bd_lab = ad, bd  # strand-LABELED refs (pre depth-swap)
    duplex = ad is not None and bd is not None
    if duplex and int(bd.sum()) > int(ad.sum()):
        # fgbio assigns the A threshold to the deeper strand PER READ
        # (total reads), then tests each strand's own per-base array
        ad, bd = bd, ad

    # ---- read-level drops ------------------------------------------------
    depth_ok = int(cd.max(initial=0)) >= m
    if duplex:
        depth_ok = (
            depth_ok
            and int(ad.max(initial=0)) >= a
            and int(bd.max(initial=0)) >= b
        )
    if not depth_ok:
        return False, "depth", None
    if rec.has_tag("cE") and float(rec.get_tag("cE")) > params.max_read_error_rate:
        return False, "error_rate", None
    # fgbio applies the read-level error threshold to the duplex AND each
    # single-strand consensus (aE/bE — emitted by this framework's duplex
    # stage in strand-vs-own-call units)
    if duplex:
        for key in ("aE", "bE"):
            if rec.has_tag(key) and (
                float(rec.get_tag(key)) > params.max_read_error_rate
            ):
                return False, "error_rate", None
    qual = np.frombuffer(rec.qual, dtype=np.uint8) if rec.qual else np.zeros(0, np.uint8)
    if (
        params.min_mean_base_quality is not None
        and qual.size
        and float(qual.mean()) < params.min_mean_base_quality
    ):
        return False, "mean_quality", None

    # ---- base-level mask -------------------------------------------------
    n = len(rec.seq)
    mask = np.zeros(n, dtype=bool)
    L = min(n, len(cd))
    mask[:L] |= cd[:L] < m
    if duplex:
        Ld = min(n, len(ad), len(bd))
        mask[:Ld] |= (ad[:Ld] < a) | (bd[:Ld] < b)
    ce = _tag_array(rec, "ce")
    if ce is not None:
        Le = min(L, len(ce))
        with np.errstate(divide="ignore", invalid="ignore"):
            rate = np.where(cd[:Le] > 0, ce[:Le] / np.maximum(cd[:Le], 1), 1.0)
        mask[:Le] |= rate > params.max_base_error_rate
    if duplex:
        # per-strand base error rates (ae/ad, be/bd) against the same
        # threshold — fgbio masks a base when EITHER strand's consensus
        # exceeds it (positions a strand does not cover pass: no rate).
        # Paired by STRAND LABEL (the depth-floor ad/bd above may have
        # been swapped deeper-strand-first).
        for ekey, darr in (("ae", ad_lab), ("be", bd_lab)):
            earr = _tag_array(rec, ekey)
            if earr is None or darr is None:
                continue
            Ls = min(n, len(earr), len(darr))
            with np.errstate(divide="ignore", invalid="ignore"):
                srate = np.where(
                    darr[:Ls] > 0,
                    earr[:Ls] / np.maximum(darr[:Ls], 1),
                    0.0,
                )
            mask[:Ls] |= srate > params.max_base_error_rate
    if params.require_single_strand_agreement and duplex:
        # fgbio -s: mask duplex bases where the two single-strand
        # consensus calls disagree. The ac/bc strand-call strings are the
        # duplex emitter's fgbio-style tag surface; a strand that made no
        # call (N) cannot disagree.
        if not (rec.has_tag("ac") and rec.has_tag("bc")):
            raise ValueError(
                f"{rec.qname}: require_single_strand_agreement needs the "
                "ac/bc per-strand call tags (this framework's duplex "
                "output carries them unless strand_tags was disabled)"
            )
        ac = np.frombuffer(str(rec.get_tag("ac")).encode("ascii"), np.uint8)
        bc = np.frombuffer(str(rec.get_tag("bc")).encode("ascii"), np.uint8)
        Ls = min(n, len(ac), len(bc))
        nn = ord("N")
        mask[:Ls] |= (
            (ac[:Ls] != bc[:Ls]) & (ac[:Ls] != nn) & (bc[:Ls] != nn)
        )
    if qual.size:
        Lq = min(n, qual.size)
        mask[:Lq] |= qual[:Lq] < params.min_base_quality
    seq_n = np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8) == ord("N")
    no_call = int((mask | seq_n).sum())
    if n and no_call / n > params.max_no_call_fraction:
        return False, "no_call", None
    return True, None, mask


class _RawView:
    """The read-only record surface _evaluate reads, over one encoded
    record blob (with its block_size prefix): qname, seq, qual and the
    tags, located by one walk of the tag region; 'B' arrays come back as
    numpy views of the blob."""

    __slots__ = ("blob", "l_seq", "seq_off", "qual_off", "tags")

    def __init__(self, blob: bytes):
        self.blob = blob
        (n_cigar,) = struct.unpack_from("<H", blob, 16)
        (self.l_seq,) = struct.unpack_from("<i", blob, 20)
        self.seq_off = 36 + blob[12] + 4 * n_cigar
        self.qual_off = self.seq_off + (self.l_seq + 1) // 2
        self.tags: dict = {}
        off, n = tag_region_offset(blob), len(blob)
        while off < n:
            end = skip_tag(blob, off)
            self.tags[blob[off:off + 2].decode("ascii")] = (off, end)
            off = end

    @property
    def qname(self) -> str:
        return self.blob[36:36 + self.blob[12] - 1].decode("ascii")

    @property
    def seq(self) -> str:
        nbytes = (self.l_seq + 1) // 2
        data = self.blob[self.seq_off:self.seq_off + nbytes]
        return "".join([_NT16_PAIRS[b] for b in data])[:self.l_seq]

    @property
    def qual(self) -> bytes | None:
        q = self.blob[self.qual_off:self.qual_off + self.l_seq]
        return None if (self.l_seq == 0 or q[0] == 0xFF) else q

    def has_tag(self, key: str) -> bool:
        return key in self.tags

    def get_tag(self, key: str):
        start, end = self.tags[key]
        if self.blob[start + 2] == ord("B"):
            sub = chr(self.blob[start + 3])
            (count,) = struct.unpack_from("<I", self.blob, start + 4)
            return sub, np.frombuffer(self.blob, _TAG_NP_DTYPE[sub], count, start + 8)
        return _decode_tags(self.blob[start:end], 0)[key][1]


def _mask_blob(view: _RawView, mask: np.ndarray, stats: FilterStats) -> bytes:
    """Apply one kept record's mask: masked bases' nibbles set to N (15)
    and their quals to _MASK_QUAL; the blob itself when nothing is
    masked."""
    stats.total_bases += view.l_seq
    if not mask.any():
        return view.blob
    out = bytearray(view.blob)
    nbytes = (view.l_seq + 1) // 2
    packed = np.frombuffer(view.blob, np.uint8, nbytes, view.seq_off)
    codes = np.empty(2 * nbytes, np.uint8)
    codes[0::2], codes[1::2] = packed >> 4, packed & 0xF
    codes[:view.l_seq][mask] = 15
    out[view.seq_off:view.seq_off + nbytes] = ((codes[0::2] << 4) | codes[1::2]).tobytes()
    if view.qual is not None:
        qual = np.frombuffer(view.qual, np.uint8).copy()
        qual[mask] = _MASK_QUAL
        out[view.qual_off:view.qual_off + view.l_seq] = qual.tobytes()
    stats.masked_bases += int(mask.sum())
    return bytes(out)


#: FilterStats counter of each drop reason _evaluate returns
_REASON_FIELD = {
    "depth": "dropped_depth",
    "error_rate": "dropped_error_rate",
    "mean_quality": "dropped_mean_quality",
    "no_call": "dropped_no_call",
}


def filter_consensus_raw(
    blobs: Iterable[bytes],
    params: FilterParams = FilterParams(),
    stats: FilterStats | None = None,
) -> Iterator[bytes]:
    """Stream encoded consensus records (with their block_size prefixes,
    template-adjacent — the order this framework's consensus stages
    emit) through the fgbio FilterConsensusReads semantics above. Drops
    are template-atomic; masking is per-base; kept records leave as
    blobs (_mask_blob)."""
    stats = stats if stats is not None else FilterStats()
    template: list[_RawView] = []

    def flush():
        # graftlint: disable=thread-unsafe-mutation -- the filter stage runs on one
        # thread; the worker edge is a basename match (flush)
        stats.records_in += len(template)
        # graftlint: disable=thread-unsafe-mutation -- one-thread filter stats, as above
        stats.templates += 1
        verdicts = [_evaluate(view, params) for view in template]
        failed = [v for v in verdicts if not v[0]]
        if failed:
            stats.__dict__[_REASON_FIELD[failed[0][1]]] += 1
            # graftlint: disable=thread-unsafe-mutation -- one-thread filter stats, as
            # above
            stats.dropped_records += len(template)
            return []
        # graftlint: disable=thread-unsafe-mutation -- one-thread filter stats, as above
        stats.kept_records += len(template)
        return [_mask_blob(view, mask, stats) for view, (_, _, mask) in zip(template, verdicts)]

    qname = None
    for blob in blobs:
        q = blob[36:36 + blob[12] - 1]
        if template and q != qname:
            yield from flush()
            template = []
        qname = q
        template.append(_RawView(blob))
    if template:
        yield from flush()


def filter_consensus(
    records: Iterable[BamRecord],
    params: FilterParams = FilterParams(),
    stats: FilterStats | None = None,
) -> Iterator[BamRecord]:
    """filter_consensus_raw over BamRecord objects (the JAX package's
    API): each record is encoded, filtered and decoded back."""
    blobs = filter_consensus_raw((encode_record(r) for r in records), params, stats)
    return (decode_record(b[4:]) for b in blobs)


def probe_strand_tag_support(path: str, params: FilterParams,
                             n_probe: int = 50) -> None:
    """Fail BEFORE any output is written when -s is requested on input
    that cannot support it: peek the lead records — a duplex record
    (ad/bd present) without ac/bc means the whole file will raise
    mid-stream, after kept records were already written."""
    if not params.require_single_strand_agreement:
        return
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    with BamReader(path) as reader:
        for i, rec in enumerate(reader):
            if rec.has_tag("ad") and rec.has_tag("bd"):
                if not (rec.has_tag("ac") and rec.has_tag("bc")):
                    raise ValueError(
                        f"{path}: require_single_strand_agreement needs "
                        "the ac/bc per-strand call tags on duplex input "
                        "(this framework's duplex output carries them "
                        "unless strand_tags was disabled)"
                    )
                return
            if i >= n_probe - 1:
                return


def filtered_header(header: BamHeader) -> BamHeader:
    """Filtering preserves record order; the header passes through (a PG
    line is added by the callers that write BAMs)."""
    return header.copy()
