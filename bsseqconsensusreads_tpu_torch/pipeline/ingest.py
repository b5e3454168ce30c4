"""Columnar ingest: feed the encoders from the native C++ decoder.

The port's copy of the JAX package's pipeline/ingest.py. The per-record
Python path (io.bam.decode_record) builds a full BamRecord — qname, cigar
and tag dicts — for every read. The native parser (csrc/host/bamio.cpp,
io.native) decodes the stream into flat numpy arrays in C instead; this
module exposes those rows as ColumnarRecordView, a lazy facade with the
attribute surface the group streamer, the encoders and the duplex
sidecar touch, and the C grouper's contiguous family runs as FamilyRun,
whose C encode digest lets ops.encode fill the tensors without any
per-record Python.

A columnar view carries only what the C parser extracts: the fixed
fields, MI and RX, and the cd/ce (+ cB) aux planes. Code that reads any
other tag off a record must run on the Python engine.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from bsseqconsensusreads_tpu_torch.io import native
from bsseqconsensusreads_tpu_torch.ops.encode import (
    INDEL_BAND,
    _decode_fixed,
    codes_to_seq,
)


class ColumnarRecordView:
    """One record of a ColumnarBatch with BamRecord's read-side surface.
    Lazy: nothing is decoded until touched."""

    __slots__ = ("_b", "_i", "_cigar")

    #: aux_len flag bit: the aux span carries the 4n cB histogram after
    #: cd/ce (csrc/host/bamio.cpp kAuxHasCb)
    _AUX_HAS_CB = 1 << 30

    def __init__(self, batch, i: int):
        self._b = batch
        self._i = i
        self._cigar = None

    @property
    def flag(self) -> int:
        return int(self._b.flag[self._i])

    @property
    def ref_id(self) -> int:
        return int(self._b.ref_id[self._i])

    @property
    def pos(self) -> int:
        return int(self._b.pos[self._i])

    @property
    def mapq(self) -> int:
        return int(self._b.mapq[self._i])

    @property
    def next_ref_id(self) -> int:
        return int(self._b.next_ref[self._i])

    @property
    def next_pos(self) -> int:
        return int(self._b.next_pos[self._i])

    @property
    def tlen(self) -> int:
        return int(self._b.tlen[self._i])

    @property
    def qname(self) -> str:
        return _decode_fixed(self._b.qname[self._i])

    @property
    def qname_key(self):
        """Raw fixed-width qname bytes: a hashable template key without
        the decode (only uniqueness matters where encode pairs R1/R2)."""
        return self._b.qname[self._i]

    @property
    def cigar(self) -> list[tuple[int, int]]:
        if self._cigar is None:
            off = int(self._b.cigar_off[self._i])
            ops = self._b.cigar[off : off + int(self._b.n_cigar[self._i])]
            self._cigar = [(int(v & 0xF), int(v >> 4)) for v in ops]
        return self._cigar

    @property
    def reference_end(self) -> int:
        # the reference span comes precomputed from the C parser
        return self.pos + int(self._b.ref_span[self._i])

    @property
    def clip_info(self) -> tuple[int, int, bool, bool]:
        """(left_softclip, right_softclip, has_indel, has_hardclip) from the
        C parser's CIGAR digest."""
        i = self._i
        cf = int(self._b.cigar_flags[i])
        return (int(self._b.left_clip[i]), int(self._b.right_clip[i]),
                bool(cf & 1), bool(cf & 2))

    @property
    def codes_quals(self):
        """(codes int8[L], quals uint8[L]) views into the parser buffers.
        Missing qualities (BAM 0xFF fill) become zeros, as BamRecord's
        qual=None does in the Python encode."""
        off = int(self._b.var_off[self._i])
        l_seq = int(self._b.l_seq[self._i])
        quals = self._b.qual[off : off + l_seq]
        if l_seq and quals[0] == 0xFF:
            quals = np.zeros(l_seq, dtype=np.uint8)
        return self._b.seq[off : off + l_seq].view("int8"), quals

    @property
    def seq(self) -> str:
        return codes_to_seq(self.codes_quals[0])

    @property
    def qual(self) -> bytes | None:
        """Raw Phred bytes, or None when the record has no qualities."""
        off = int(self._b.var_off[self._i])
        l_seq = int(self._b.l_seq[self._i])
        raw = self._b.qual[off : off + l_seq]
        if l_seq == 0 or raw[0] == 0xFF:
            return None
        return bytes(raw)

    def _tag(self, name: str) -> str | None:
        if name == "MI":
            raw = self._b.mi[self._i]
        elif name == "RX":
            raw = self._b.rx[self._i]
        else:
            return None
        s = _decode_fixed(raw)
        return s if s else None

    def consensus_aux(self):
        """(cd, ce, cB | None) u16 views from the C parser's aux planes, or
        None when the record carried no usable cd/ce tags — the duplex
        sidecar's one-decode path."""
        b = self._b
        raw_len = int(b.aux_len[self._i])
        n = raw_len & ~self._AUX_HAS_CB
        if n == 0:
            return None
        off = int(b.aux_off[self._i])
        cb = b.aux[off + 2 * n : off + 6 * n] if raw_len & self._AUX_HAS_CB else None
        return b.aux[off : off + n], b.aux[off + n : off + 2 * n], cb

    def has_tag(self, name: str) -> bool:
        if name in ("cd", "ce", "cB"):
            trip = self.consensus_aux()
            return trip is not None and (name != "cB" or trip[2] is not None)
        return self._tag(name) is not None

    def get_tag(self, name: str):
        if name in ("cd", "ce", "cB"):
            trip = self.consensus_aux()
            idx = ("cd", "ce", "cB").index(name)
            if trip is None or trip[idx] is None:
                raise KeyError(name)
            return ("S", trip[idx])  # BamRecord's 'B' tag surface
        v = self._tag(name)
        if v is None:
            raise KeyError(name)
        return v


def columnar_records(path: str, batch_records: int = 1 << 16,
                     threads: int | None = None) -> Iterator[ColumnarRecordView]:
    """Stream a BAM file as ColumnarRecordViews through the native decoder.
    Views of one batch stay valid while any of them is referenced."""
    for batch in native.read_columnar(path, batch_records=batch_records, threads=threads):
        for i in range(batch.n):
            yield ColumnarRecordView(batch, i)


class FamilyRun:
    """One MI family as a contiguous run of a ColumnarBatch, with the C
    encode-scan digest (io.native.encode_scan / duplex_scan). Unpacks
    like the (mi, records) pairs the group streamers yield; consumers
    that understand the digest (the bucketed batcher, the deep-family
    splitter, ops.encode's native fill) read the per-family arrays
    instead of materializing per-record views."""

    __slots__ = ("batch", "scan", "scan_policy", "fidx", "start", "n", "mi", "_records")

    def __init__(self, batch, scan, scan_policy, fidx, start, n, mi):
        self.batch = batch
        self.scan = scan
        self.scan_policy = scan_policy
        self.fidx = fidx
        self.start = start
        self.n = n
        self.mi = mi
        self._records = None

    @property
    def records(self) -> list[ColumnarRecordView]:
        if self._records is None:
            self._records = [ColumnarRecordView(self.batch, i)
                             for i in range(self.start, self.start + self.n)]
        return self._records

    def __iter__(self):
        yield self.mi
        yield self.records

    @property
    def ntpl_est(self) -> int:
        """Distinct kept qnames — pipeline.calling._kept_template_count."""
        return int(self.scan["ntpl_est"][self.fidx])


class GroupedColumnarStream:
    """Pre-grouped record stream: the C MI grouper
    (io.native.read_grouped_columnar) hands whole families back as
    contiguous columnar runs, so the Python layer does no per-record
    grouping work. pipeline.calling.stream_mi_groups delegates to
    iter_groups() when handed one of these (the configuration echo lets
    it check the stream was built with the semantics the caller wants).

    scan_policy 'drop' runs the C molecular-encode scan once per batch and
    yields FamilyRuns; 'duplex' runs the duplex-shaped scan; None yields
    (mi, [ColumnarRecordView]) pairs."""

    def __init__(self, path: str, flush_margin: int = 10_000,
                 strip_suffix: bool = False,
                 scan_policy: str | None = None,
                 grouping: str = "coordinate",
                 threads: int | None = None):
        if scan_policy not in (None, "drop", "duplex"):
            raise ValueError(f"unknown scan_policy {scan_policy!r}")
        if grouping not in ("coordinate", "adjacent"):
            raise ValueError(f"native grouping supports coordinate|adjacent, got {grouping!r}")
        self.path = path
        self.flush_margin = flush_margin
        self.strip_suffix = strip_suffix
        self.scan_policy = scan_policy
        self.grouping = grouping
        self.threads = threads

    def iter_groups(self, stats=None):
        # a margin < 0 selects the C grouper's adjacent (MI-change) mode
        margin = -1 if self.grouping == "adjacent" else self.flush_margin
        for batch, fam_mi, fam_nrec, refrag in native.read_grouped_columnar(
            self.path, margin, self.strip_suffix, threads=self.threads
        ):
            if stats is not None:
                stats.records_in += batch.n
                stats.refragmented_families += refrag
            fam_start = np.zeros(len(fam_nrec), np.int64)
            fam_start[1:] = np.cumsum(fam_nrec[:-1], dtype=np.int64)
            if self.scan_policy is None:
                for k in range(len(fam_mi)):
                    s, n = int(fam_start[k]), int(fam_nrec[k])
                    yield (_decode_fixed(fam_mi[k]),
                           [ColumnarRecordView(batch, i) for i in range(s, s + n)])
                continue
            nrec = np.ascontiguousarray(fam_nrec)
            if self.scan_policy == "duplex":
                scan = native.duplex_scan(batch, fam_start, nrec)
            else:
                scan = native.encode_scan(batch, fam_start, nrec, self.scan_policy, INDEL_BAND)
            for k in range(len(fam_mi)):
                yield FamilyRun(batch, scan, self.scan_policy, k,
                                int(fam_start[k]), int(fam_nrec[k]),
                                _decode_fixed(fam_mi[k]))
