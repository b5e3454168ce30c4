"""Tensorization: UMI-family records -> padded family tensors.

The port's own copy of the JAX package's ops/encode.py (indel_policy
'align' is a later slice of the port). Two engines fill the same arrays:
the Python pass over (mi, records) groups, and the native fill over
pipeline.ingest.FamilyRun groups, whose per-record pass already ran in C
at ingest (io.native.encode_scan / duplex_scan). Each MI family packs
into fixed-shape numpy arrays laid out in
*genome window space* (offset = pos - window_start), so every downstream
transform (overlap co-call, consensus vote, AG->CT conversion, gap extension,
duplex merge) is a dense per-column tensor op on the device.

Bucketed padding bounds pad waste across the 1-2-read cfDNA tail and deep
families: template counts round up to powers of two and window lengths to
multiples of WINDOW_GRAN.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Sequence

import numpy as np

from bsseqconsensusreads_tpu_torch.io.bam import (
    BamRecord,
    CHARD_CLIP,
    CINS,
    CDEL,
    CSOFT_CLIP,
    FREAD2,
    FREVERSE,
)

from bsseqconsensusreads_tpu_torch.alphabet import BASE_CHAR, BASE_CODE, NBASE
from bsseqconsensusreads_tpu_torch.utils.flags import CONVERT_FLAGS, GROUP_ORDER

# Padding granularities. Template counts bucket to powers of two, window
# widths to 32 columns (the JAX package's buckets, so both packages cut
# identical batches).
LANE = 128
WINDOW_GRAN = 32
MAX_TEMPLATES_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def seq_to_codes(seq: str) -> np.ndarray:
    return BASE_CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    return BASE_CHAR[np.clip(codes, 0, NBASE)].tobytes().decode("ascii")


def trim_softclips(rec: BamRecord) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Return (codes, quals, pos) with soft clips removed, or None when the
    read must be dropped (indel or hardclip CIGAR ops — the reference drops
    these too: tools/1.convert_AG_to_CT.py:79-80, tools/2.extend_gap.py:160).
    """
    # columnar views (pipeline.ingest.ColumnarRecordView): the C parser
    # digested the CIGAR, and the codes/quals are buffer views
    info = getattr(rec, "clip_info", None)
    if info is not None:
        start, rclip, has_indel, has_hard = info
        if has_indel or has_hard:
            return None
        codes, quals = rec.codes_quals
        return codes[start : len(codes) - rclip], quals[start : len(codes) - rclip], rec.pos
    cigar = rec.cigar
    if any(op in (CINS, CDEL, CHARD_CLIP) for op, _ in cigar):
        return None
    codes = seq_to_codes(rec.seq)
    quals = (
        np.frombuffer(rec.qual, dtype=np.uint8)
        if rec.qual is not None
        else np.zeros(len(rec.seq), dtype=np.uint8)
    )
    start, end = 0, len(codes)
    if cigar and cigar[0][0] == CSOFT_CLIP:
        start = cigar[0][1]
    if cigar and cigar[-1][0] == CSOFT_CLIP:
        end -= cigar[-1][1]
    return codes[start:end], quals[start:end], rec.pos


@dataclasses.dataclass
class FamilyMeta:
    """Host-side metadata for one encoded family (one MI group, one strand)."""

    mi: str
    ref_id: int
    window_start: int
    n_templates: int
    rx: str = ""
    #: majority mapped-orientation per role (R1, R2): True = reverse strand.
    #: Needed to emit unaligned consensus in sequencing orientation.
    role_reverse: tuple = (False, True)


@dataclasses.dataclass
class MolecularBatch:
    """[F, T, 2, W] family tensors for the molecular consensus kernel.

    bases==4 marks "no observation" (pad, N, or no coverage); role axis is
    (R1, R2). All arrays are numpy; the kernel takes them as device arrays.
    """

    bases: np.ndarray  # int8 [F, T, 2, W]
    quals: np.ndarray  # uint8 [F, T, 2, W]
    meta: list[FamilyMeta]
    #: segment-packed twin (pack_molecular_rows), filled by the encode phase
    #: when the packed kernel layout is active; None under layout=padded
    packed: "PackedRows | None" = None

    @property
    def shape(self) -> tuple[int, int, int]:
        f, t, _, w = self.bases.shape
        return f, t, w


@dataclasses.dataclass
class PackedRows:
    """Segment-packed twin of a MolecularBatch: every real template's read
    pair concatenated on one dense row axis, plus the per-row family id.

    The padding envelope is gone — a 70%-singleton mixture that padded to
    T=4 issues 4x the data FLOPs in [F, T, 2, W] form but exactly N rows
    here. Rows are sorted by family (seg ascending), so the vote adds each
    family's rows in the same order as the padded sum and stays
    bit-identical. Row count and family count are both padded to power-of-
    two buckets (the JAX package's compile-bounding buckets, kept so both
    packages issue identical shapes): pad rows carry no observation
    (bases NBASE, quals 0) and the sentinel family id `num_families`,
    which no segment covers.
    """

    bases: np.ndarray  # int8 [N, 2, W], N power-of-two bucketed
    quals: np.ndarray  # uint8 [N, 2, W]
    seg: np.ndarray  # int32 [N] ascending family ids; pad rows = num_families
    num_families: int  # pow2-bucketed family count the kernel is called with
    n_real_rows: int  # rows carrying data (before the row-bucket pad)


#: Row-bucket floor: batches below this pad up to one shared tiny shape
#: (the JAX package's value, so both packages issue identical shapes).
MIN_PACKED_ROWS = 16


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(n, floor, 1)
    return 1 << (n - 1).bit_length()


def pack_molecular_rows(batch: "MolecularBatch") -> PackedRows | None:
    """Build the segment-packed view of an encoded molecular batch.

    The encoder places each family's real templates in slots
    [0, n_templates), so the pack is a boolean-mask gather — no
    per-family Python loop. Returns None for an empty batch (nothing to
    dispatch).
    """
    f, t, _, w = batch.bases.shape
    if f == 0:
        return None
    n_tpl = np.fromiter((m.n_templates for m in batch.meta), np.int32, f)
    keep = np.arange(t, dtype=np.int32)[None, :] < n_tpl[:, None]  # [F, T]
    rows_b = batch.bases[keep]  # [N, 2, W]
    rows_q = batch.quals[keep]
    seg = np.repeat(np.arange(f, dtype=np.int32), n_tpl)
    n = int(rows_b.shape[0])
    f_pad = bucket_pow2(f)
    n_pad = bucket_pow2(n, MIN_PACKED_ROWS)
    if n_pad > n:
        fill = n_pad - n
        rows_b = np.concatenate(
            [rows_b, np.full((fill, 2, w), NBASE, np.int8)]
        )
        rows_q = np.concatenate([rows_q, np.zeros((fill, 2, w), np.uint8)])
        seg = np.concatenate([seg, np.full(fill, f_pad, np.int32)])
    else:
        seg = seg.copy()
    # real-family ids stay < f <= f_pad; only pad rows use the sentinel
    return PackedRows(rows_b, rows_q, seg, f_pad, n)


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def bucket_templates(t: int) -> int:
    for b in MAX_TEMPLATES_BUCKETS:
        if t <= b:
            return b
    return _round_up(t, 1024)


def bucket_window(w: int) -> int:
    return max(WINDOW_GRAN, _round_up(w, WINDOW_GRAN))


#: Default template cap of one encode: deeper families are routed to the
#: deep-family path (pipeline.calling._split_deep, up to
#: DEEP_TEMPLATE_CAP) or, past a cap given here, skipped AND reported
#: (never silent).
MAX_TEMPLATES = 4096

#: band half-width of the JAX package's indel_policy='align'; the C encode
#: scan takes it as an argument (unused under 'drop', the port's policy)
INDEL_BAND = 8


def scan_matches(group, policy: str) -> bool:
    """True when `group` is a pipeline.ingest.FamilyRun carrying a C encode
    digest computed under `policy` ('drop' or 'duplex') — the one gate of
    every native fast path (the bucketed batcher, the deep-family splitter
    and the encoders must classify a group alike)."""
    return (
        getattr(group, "scan", None) is not None
        and getattr(group, "scan_policy", None) == policy
    )


def _iter_batch_segments(fams: list):
    """(i, j) index ranges of maximal same-ColumnarBatch runs — one native
    fill call each (fill pointers are per batch)."""
    i, n = 0, len(fams)
    while i < n:
        j = i
        b = fams[i].batch
        while j < n and fams[j].batch is b:
            j += 1
        yield i, j
        i = j


def _segment_runs(fams: list, i: int, j: int) -> tuple[np.ndarray, np.ndarray]:
    """(fam_start, fam_nrec) arrays for one same-batch segment."""
    return (
        np.fromiter((g.start for g in fams[i:j]), np.int64, j - i),
        np.fromiter((g.n for g in fams[i:j]), np.int32, j - i),
    )


def _run_multi_ref(fam) -> bool:
    """True when a FamilyRun's mapped records span more than one contig
    (ref_id -1 ignored, as the Python encoders' `rid >= 0` guard does)."""
    run_refs = fam.batch.ref_id[fam.start : fam.start + fam.n]
    mapped = run_refs[run_refs >= 0]
    return bool(mapped.size and (mapped != mapped[0]).any())


def _decode_fixed(raw: bytes) -> str:
    """Decode a NUL-padded fixed-width field (ColumnarBatch qname/mi/rx)."""
    return raw.rstrip(b"\x00").decode("ascii", "replace")


def encode_molecular_families(
    families: Sequence[tuple[str, Sequence[BamRecord]]],
    max_window: int = 4096,
    max_templates: int = MAX_TEMPLATES,
) -> tuple[MolecularBatch, list[str]]:
    """Encode MI families (already grouped, e.g. by io streaming) into one
    padded batch. Families whose window exceeds max_window or whose template
    count exceeds max_templates are skipped and reported (never silently
    dropped). Indel reads are dropped, as the reference drops them
    (tools/1.convert_AG_to_CT.py:79-80). A chunk of FamilyRuns carrying
    the C scan takes the native fill; the batch is the same.

    Returns (batch, skipped_mi_list).
    """
    fams = families if isinstance(families, list) else list(families)
    if fams and all(scan_matches(f, "drop") for f in fams):
        return _encode_molecular_native(fams, max_window, max_templates)
    families = fams
    placed = []
    skipped: list[str] = []
    max_t = 1
    max_w = LANE
    for mi, records in families:
        templates: dict[str, dict[int, tuple]] = defaultdict(dict)
        ref_id = -1
        rx_counts: dict[str, int] = defaultdict(int)
        lo, hi = None, None
        multi_ref = False
        for rec in records:
            rid = rec.ref_id
            if rid >= 0:
                if ref_id < 0:
                    ref_id = rid
                elif rid != ref_id:
                    multi_ref = True
            trimmed = trim_softclips(rec)
            if trimmed is None:
                continue
            codes, quals, pos = trimmed
            if len(codes) == 0:
                continue
            role = 1 if rec.flag & FREAD2 else 0
            # columnar views key templates by their raw qname bytes: only
            # template identity matters here
            templates[getattr(rec, "qname_key", None) or rec.qname][role] = (
                codes, quals, pos, bool(rec.flag & FREVERSE)
            )
            try:  # one tag parse, not a has_tag/get_tag pair
                rx_counts[rec.get_tag("RX")] += 1
            except KeyError:
                pass
            lo = pos if lo is None else min(lo, pos)
            e = pos + len(codes)
            hi = e if hi is None else max(hi, e)
        if lo is None:
            skipped.append(mi)
            continue
        window = hi - lo
        # multi_ref: a window is one contiguous interval of ONE contig; a
        # chimeric family whose mates land on different refs cannot be
        # windowed and is skipped+counted like an over-wide one
        if window > max_window or len(templates) > max_templates or multi_ref:
            skipped.append(mi)
            continue
        rx = max(rx_counts, key=rx_counts.get) if rx_counts else ""
        # majority orientation over the records actually kept (one vote per
        # (template, role) slot; duplicates overwrite, so vote the survivor)
        rev_votes = [[0, 0], [0, 0]]
        for roles in templates.values():
            for role, (_, _, _, rev) in roles.items():
                rev_votes[role][1 if rev else 0] += 1
        role_rev = (rev_votes[0][1] > rev_votes[0][0], rev_votes[1][1] > rev_votes[1][0])
        placed.append((mi, ref_id, lo, window, rx, templates, role_rev))
        max_t = max(max_t, len(templates))
        max_w = max(max_w, window)

    f = len(placed)
    t_pad = bucket_templates(max_t)
    w_pad = bucket_window(max_w)
    bases = np.full((f, t_pad, 2, w_pad), NBASE, dtype=np.int8)
    quals = np.zeros((f, t_pad, 2, w_pad), dtype=np.uint8)
    meta: list[FamilyMeta] = []
    for fi, (mi, ref_id, lo, window, rx, templates, role_rev) in enumerate(placed):
        for ti, (qname, roles) in enumerate(templates.items()):
            for role, (codes, q, pos, _rev) in roles.items():
                off = pos - lo
                bases[fi, ti, role, off : off + len(codes)] = codes
                quals[fi, ti, role, off : off + len(codes)] = q
        meta.append(FamilyMeta(mi, ref_id, lo, len(templates), rx, role_reverse=role_rev))
    return MolecularBatch(bases, quals, meta), skipped


def _encode_molecular_native(
    fams: list, max_window: int, max_templates: int
) -> tuple[MolecularBatch, list[str]]:
    """encode_molecular_families over FamilyRuns: the per-record pass ran
    in C at ingest (io.native.encode_scan; semantics in csrc/host/bamio.cpp
    bamio_encode_scan), so this reads the per-family digests and fills the
    tensors with one C call per contiguous batch segment
    (io.native.encode_fill). The batch equals the Python path's."""
    from bsseqconsensusreads_tpu_torch.io import native

    skipped: list[str] = []
    placed: list = []
    rows = np.empty(len(fams), np.int64)
    max_t, max_w = 1, LANE
    for i, fam in enumerate(fams):
        s, k = fam.scan, fam.fidx
        ntpl = int(s["ntpl"][k])
        window = int(s["window"][k])
        if ntpl == 0 or window > max_window or ntpl > max_templates or _run_multi_ref(fam):
            skipped.append(fam.mi)
            rows[i] = -1
            continue
        rows[i] = len(placed)
        placed.append(fam)
        max_t = max(max_t, ntpl)
        max_w = max(max_w, window)

    f = len(placed)
    t_pad = bucket_templates(max_t)
    w_pad = bucket_window(max_w)
    bases = np.full((f, t_pad, 2, w_pad), NBASE, dtype=np.int8)
    quals = np.zeros((f, t_pad, 2, w_pad), dtype=np.uint8)
    for i, j in _iter_batch_segments(fams):
        scan = fams[i].scan
        fam_start, fam_nrec = _segment_runs(fams, i, j)
        native.encode_fill(
            fams[i].batch, scan, fam_start, fam_nrec, rows[i:j],
            np.ascontiguousarray(scan["lo"][[g.fidx for g in fams[i:j]]]),
            bases, quals,
        )
    meta: list[FamilyMeta] = []
    for fam in placed:
        s, k = fam.scan, fam.fidx
        rxr = int(s["rx_rec"][k])
        rx = _decode_fixed(fam.batch.rx[rxr]) if rxr >= 0 else ""
        rr = int(s["rolerev"][k])
        meta.append(FamilyMeta(
            fam.mi, int(s["refid"][k]), int(s["lo"][k]), int(s["ntpl"][k]),
            rx, role_reverse=(bool(rr & 1), bool(rr & 2)),
        ))
    return MolecularBatch(bases, quals, meta), skipped


#: Flags the duplex stage accepts, and their row in the family tensor —
#: derived from the single flag vocabulary in utils.flags (GROUP_ORDER is the
#: reference's output order, tools/2.extend_gap.py:136). The conversion tool
#: passes 0/99/147 through, converts 1/83/163, and silently drops everything
#: else (tools/1.convert_AG_to_CT.py:70-73).
DUPLEX_ROW_OF_FLAG = {f: i for i, f in enumerate(GROUP_ORDER)}
CONVERT_ROWS = tuple(
    i for i, f in enumerate(GROUP_ORDER) if f in CONVERT_FLAGS
)  # rows for flags 163 and 83: B-strand reads needing AG->CT


@dataclasses.dataclass
class DuplexBatch:
    """[F, 4, W] family tensors for the convert -> extend -> duplex stages.

    Row order (99, 163, 83, 147); ref carries W+1 reference codes per family
    (one extra column for the CpG / trailing-trim lookahead). convert_mask
    marks B-strand rows that are present.
    """

    bases: np.ndarray  # int8 [F, 4, W]
    quals: np.ndarray  # float32 [F, 4, W]
    cover: np.ndarray  # bool [F, 4, W]
    ref: np.ndarray  # int8 [F, W+1]
    convert_mask: np.ndarray  # bool [F, 4]
    extend_eligible: np.ndarray  # bool [F] — group had exactly 4 reads
    meta: list[FamilyMeta]


def encode_duplex_families(
    families: Sequence[tuple[str, Sequence[BamRecord]]],
    ref_fetch,
    ref_names: Sequence[str],
    max_window: int = 4096,
    fetch_ref: bool = True,
    pos0: str = "skip",
) -> tuple[DuplexBatch, list[BamRecord], list[str]]:
    """Encode duplex MI groups (strand suffix already stripped) for the fused
    convert+extend+duplex device stage.

    ref_fetch(name, start, end) -> str is a FastaFile.fetch-compatible
    callable; a failed fetch falls back to all-N, matching the reference
    (tools/1.convert_AG_to_CT.py:106-109).

    Returns (batch, leftovers, skipped): leftovers are records this stage
    cannot tensorize (flags outside {99,163,83,147}, duplicate flags, indel
    reads, or reads empty after softclip trimming) for the caller to handle
    host-side; skipped lists MI groups dropped entirely (window too large /
    no usable reads).

    Reference-parity gate: the reference only harmonizes groups of exactly 4
    reads, passing every other group through unextended
    (tools/2.extend_gap.py:114-115). Group size counts reads surviving the
    hardclip drop, like the reference's grouping pass; the resulting
    per-family extend_eligible flag gates extend_gap downstream.

    fetch_ref=False leaves batch.ref all-N.

    pos0: what a convert-row read mapped at reference position 0 does about
    the conversion prepend (there is no column to its left).  'skip' (the
    default) skips the prepend — the sane behavior documented in
    ops/convert.py.  'shift' reproduces the reference exactly
    (tools/1.convert_AG_to_CT.py:87-92: prepend anyway, clamp pos to 0,
    shifting the whole read one base out of register): the read is placed
    one window column right, so the standard prepend path then writes the
    reference base at its original start column and every comparison runs
    at the reference's shifted register. 'shift' keeps the Python
    placement (the C duplex scan places at the recorded position).

    A chunk of FamilyRuns carrying the C duplex scan takes the native
    fill; the batch, leftovers and skips are the same.
    """
    if pos0 not in ("skip", "shift"):
        raise ValueError(f"pos0 must be 'skip'|'shift', got {pos0!r}")
    fams = families if isinstance(families, list) else list(families)
    if pos0 == "skip" and fams and all(scan_matches(f, "duplex") for f in fams):
        return _encode_duplex_native(fams, ref_fetch, ref_names, max_window, fetch_ref)
    families = fams
    placed = []
    leftovers: list[BamRecord] = []
    skipped: list[str] = []
    max_w = LANE
    for mi, records in families:
        rows: dict[int, tuple] = {}
        rx = ""
        ref_id = -1
        lo, hi = None, None
        group_size = 0
        multi_ref = False
        for rec in records:
            rid = rec.ref_id
            if rid >= 0:
                if ref_id < 0:
                    ref_id = rid
                elif rid != ref_id:
                    multi_ref = True
            info = getattr(rec, "clip_info", None)  # columnar CIGAR digest
            if (info[3] if info is not None
                    else any(op == CHARD_CLIP for op, _ in rec.cigar)):
                continue  # reference drops hardclipped reads (2.extend_gap.py:160)
            group_size += 1
            row = DUPLEX_ROW_OF_FLAG.get(rec.flag)
            trimmed = trim_softclips(rec)
            if row is None or row in rows or trimmed is None or len(trimmed[0]) == 0:
                leftovers.append(rec)
                continue
            codes, quals, pos = trimmed
            if pos0 == "shift" and pos == 0 and row in CONVERT_ROWS:
                # reference pos-0 register shift (see docstring): place one
                # column right; the conversion prepend then fills column 0
                pos = 1
            rows[row] = (codes, quals, pos)
            if not rx:
                try:  # one tag parse, not a has_tag/get_tag pair
                    rx = rec.get_tag("RX")
                except KeyError:
                    pass
            lo = pos if lo is None else min(lo, pos)
            e = pos + len(codes)
            hi = e if hi is None else max(hi, e)
        if lo is None:
            skipped.append(mi)
            continue
        start = max(lo - 1, 0)  # one margin column for the conversion prepend
        window = hi - start
        # multi_ref: same one-contig window-space rule as the molecular
        # encoder — chimeric groups skip+count, never a cross-ref window
        if window > max_window or multi_ref:
            skipped.append(mi)
            continue
        placed.append((mi, ref_id, start, window, rows, rx, group_size == 4))
        max_w = max(max_w, window)

    f = len(placed)
    w_pad = bucket_window(max_w)
    bases = np.full((f, 4, w_pad), NBASE, dtype=np.int8)
    quals = np.zeros((f, 4, w_pad), dtype=np.float32)
    cover = np.zeros((f, 4, w_pad), dtype=bool)
    ref = np.full((f, w_pad + 1), NBASE, dtype=np.int8)
    convert_mask = np.zeros((f, 4), dtype=bool)
    eligible = np.zeros(f, dtype=bool)
    meta: list[FamilyMeta] = []
    for fi, (mi, ref_id, start, window, rows, rx, is_4) in enumerate(placed):
        eligible[fi] = is_4
        for row, (codes, q, pos) in rows.items():
            off = pos - start
            bases[fi, row, off : off + len(codes)] = codes
            quals[fi, row, off : off + len(codes)] = q
            cover[fi, row, off : off + len(codes)] = True
            if row in CONVERT_ROWS:
                convert_mask[fi, row] = True
        if fetch_ref and 0 <= ref_id < len(ref_names):
            # only window+1 columns are ever read by the kernels (the rest
            # stay N-padded): don't fetch the whole bucket width
            codes = _fetch_ref_codes(ref_fetch, ref_names[ref_id], start, start + window + 1)
            ref[fi, : len(codes)] = codes
        meta.append(FamilyMeta(mi, ref_id, start, len(rows), rx))
    return (
        DuplexBatch(bases, quals, cover, ref, convert_mask, eligible, meta),
        leftovers,
        skipped,
    )


def _fetch_ref_codes(ref_fetch, name: str, start: int, end: int) -> np.ndarray:
    """Reference codes of [start, end); a failed fetch is all-N, as in the
    reference (tools/1.convert_AG_to_CT.py:106-109)."""
    try:
        ref_str = ref_fetch(name, start, end)
    except Exception:
        ref_str = ""
    return seq_to_codes(ref_str)


def _encode_duplex_native(
    fams: list, ref_fetch, ref_names: Sequence[str], max_window: int,
    fetch_ref: bool = True,
) -> tuple[DuplexBatch, list, list[str]]:
    """encode_duplex_families over FamilyRuns carrying the C duplex scan
    (io.native.duplex_scan): per-family start / window / row mask and
    per-record row placement were computed at ingest, so only leftover
    records (row -1) become per-record views, and the tensors fill with
    one C call per contiguous batch segment. The reference windows are
    fetched per family on the host, as in the Python path."""
    from bsseqconsensusreads_tpu_torch.io import native
    from bsseqconsensusreads_tpu_torch.pipeline.ingest import ColumnarRecordView

    skipped: list[str] = []
    leftovers: list = []
    placed: list = []
    rows = np.empty(len(fams), np.int64)
    max_w = LANE
    for i, fam in enumerate(fams):
        s, k = fam.scan, fam.fidx
        window = int(s["window"][k])
        # leftovers count from every family, skipped or not (the Python
        # pass collects them before the family-level gates)
        if int(s["nleft"][k]):
            row_of = s["row"][fam.start : fam.start + fam.n]
            leftovers.extend(ColumnarRecordView(fam.batch, fam.start + int(dj))
                             for dj in np.nonzero(row_of == -1)[0])
        if window < 0 or window > max_window or _run_multi_ref(fam):
            skipped.append(fam.mi)
            rows[i] = -1
            continue
        rows[i] = len(placed)
        placed.append(fam)
        max_w = max(max_w, window)

    f = len(placed)
    w_pad = bucket_window(max_w)
    bases = np.full((f, 4, w_pad), NBASE, dtype=np.int8)
    quals = np.zeros((f, 4, w_pad), dtype=np.float32)
    cover = np.zeros((f, 4, w_pad), dtype=bool)
    ref = np.full((f, w_pad + 1), NBASE, dtype=np.int8)
    convert_mask = np.zeros((f, 4), dtype=bool)
    eligible = np.zeros(f, dtype=bool)
    for i, j in _iter_batch_segments(fams):
        scan = fams[i].scan
        fam_start, fam_nrec = _segment_runs(fams, i, j)
        native.duplex_fill(
            fams[i].batch, scan, fam_start, fam_nrec, rows[i:j],
            np.ascontiguousarray(scan["start"][[g.fidx for g in fams[i:j]]]),
            bases, quals, cover.view(np.uint8),
        )
    meta: list[FamilyMeta] = []
    for row, fam in enumerate(placed):
        s, k = fam.scan, fam.fidx
        mask = int(s["rowmask"][k])
        eligible[row] = int(s["gsize"][k]) == 4
        for r in CONVERT_ROWS:
            convert_mask[row, r] = bool(mask & (1 << r))
        rxr = int(s["rx_rec"][k])
        rx = _decode_fixed(fam.batch.rx[rxr]) if rxr >= 0 else ""
        ref_id = int(s["refid"][k])
        start = int(s["start"][k])
        window = int(s["window"][k])
        if fetch_ref and 0 <= ref_id < len(ref_names):
            codes = _fetch_ref_codes(ref_fetch, ref_names[ref_id], start, start + window + 1)
            ref[row, : len(codes)] = codes
        meta.append(FamilyMeta(fam.mi, ref_id, start, bin(mask).count("1"), rx))
    return (
        DuplexBatch(bases, quals, cover, ref, convert_mask, eligible, meta),
        leftovers,
        skipped,
    )


def iter_mi_groups(records: Iterable[BamRecord], strip_suffix: bool = False):
    """Group a record stream by MI tag, preserving first-seen order.

    strip_suffix drops the /A |/B strand suffix (like tools/2.extend_gap.py:166)
    so both strands of a duplex land in one group. Records without an MI tag
    raise, matching the reference (tools/2.extend_gap.py:180).
    """
    groups: dict[str, list[BamRecord]] = {}
    for rec in records:
        if not rec.has_tag("MI"):
            raise ValueError(f"{rec.qname} does not have MI tag.")
        mi = str(rec.get_tag("MI"))
        if strip_suffix:
            mi = mi.split("/")[0]
        groups.setdefault(mi, []).append(rec)
    return list(groups.items())
