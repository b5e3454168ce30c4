"""BAM record model and codec.

The port's own copy of the JAX package's io/bam.py: streaming reader,
writer, record field/tag access and mutation. The BGZF container under a
reader or writer is the native C++ codec (io.native) or the pure-Python
one (io.bgzf), chosen by `engine`; the Python codec writes through
io.pbgzf's parallel deflate when host workers are available (the same
bytes). GuardedBamReader is the input guard's reader (faults.guard): BGZF
resync, record framing re-found after a gap, records quarantined or
repaired by the policy.

BAM layout (SAM spec §4): BGZF-compressed stream of
  magic "BAM\\1" | l_text | text | n_ref | (l_name name l_ref)*
then per alignment:
  block_size refID pos l_read_name mapq bin n_cigar_op flag l_seq
  next_refID next_pos tlen read_name\\0 cigar[u32*] seq[nibbles] qual[u8*] tags
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

import numpy as np

from bsseqconsensusreads_tpu_torch.faults.guard import (
    StreamGuardError,
    check_record_body,
)
from bsseqconsensusreads_tpu_torch.io.bgzf import BgzfReader, BgzfWriter

BAM_MAGIC = b"BAM\x01"

#: block_size sanity bounds — an untrusted 32-bit field must never size
#: a read.
MIN_RECORD_SIZE = 32
MAX_RECORD_SIZE = 1 << 28

# CIGAR op codes and letters (SAM spec order).
CIGAR_OPS = "MIDNSHP=X"
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
_CONSUMES_REF = (True, False, True, True, False, False, False, True, True)
_CONSUMES_QUERY = (True, True, False, False, True, False, False, True, True)

# 4-bit base codes.
SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_OF = {c: i for i, c in enumerate(SEQ_NT16)}
for _c in "acmgrsvtwyhkdbn":
    _NT16_OF[_c] = _NT16_OF[_c.upper()]
# Byte -> two-base string table so seq decode is one dict-free pass per byte.
_NT16_PAIRS = [SEQ_NT16[b >> 4] + SEQ_NT16[b & 0xF] for b in range(256)]
# char byte -> 4-bit code table for the encode path (unknown chars -> N=15).
_NT16_CODE = np.full(256, 15, dtype=np.uint8)
for _ch, _code in _NT16_OF.items():
    _NT16_CODE[ord(_ch)] = _code

# SAM flag bits.
FPAIRED, FPROPER_PAIR, FUNMAP, FMUNMAP = 0x1, 0x2, 0x4, 0x8
FREVERSE, FMREVERSE, FREAD1, FREAD2 = 0x10, 0x20, 0x40, 0x80
FSECONDARY, FQCFAIL, FDUP, FSUPPLEMENTARY = 0x100, 0x200, 0x400, 0x800


class BamError(StreamGuardError):
    """BAM framing/format error (a typed stream error, itself an
    IOError)."""


@dataclass
class BamHeader:
    """SAM header text plus the binary reference dictionary."""

    text: str = ""
    references: list[tuple[str, int]] = field(default_factory=list)

    def ref_id(self, name: str) -> int:
        for i, (n, _) in enumerate(self.references):
            if n == name:
                return i
        return -1

    def ref_name(self, rid: int) -> str:
        if 0 <= rid < len(self.references):
            return self.references[rid][0]
        return "*"

    def copy(self) -> "BamHeader":
        return BamHeader(self.text, list(self.references))

    def with_sort_order(self, so: str, ss: str | None = None) -> "BamHeader":
        """A copy whose @HD line declares SO:`so` (and optionally a
        SS:`ss` sub-sort). Other @HD fields survive; a stale SS from a
        previous sort is dropped unless replaced."""
        lines = self.text.splitlines()
        out = []
        replaced = False
        for line in lines:
            if line.startswith("@HD"):
                fields = [
                    f for f in line.split("\t")[1:]
                    if not f.startswith(("SO:", "SS:"))
                ]
                hd = "\t".join(["@HD", *fields, f"SO:{so}"])
                if ss:
                    hd += f"\tSS:{ss}"
                out.append(hd)
                replaced = True
            else:
                out.append(line)
        if not replaced:
            hd = f"@HD\tVN:1.6\tSO:{so}"
            if ss:
                hd += f"\tSS:{ss}"
            out.insert(0, hd)
        return BamHeader(
            "\n".join(out) + ("\n" if out else ""), list(self.references)
        )

    def with_pg(
        self,
        program: str,
        version: str = "",
        command_line: str = "",
    ) -> "BamHeader":
        """A copy with an @PG provenance line appended, chained to the
        previous program via PP (what samtools/fgbio do on every step);
        a repeated program gets the ID suffix .1, .2, …"""
        ids = []
        for line in self.text.splitlines():
            if line.startswith("@PG"):
                for part in line.split("\t")[1:]:
                    if part.startswith("ID:"):
                        ids.append(part[3:])
        pg_id = program
        n = 1
        while pg_id in ids:
            pg_id = f"{program}.{n}"
            n += 1
        fields = [f"@PG\tID:{pg_id}", f"PN:{program}"]
        if ids:
            fields.append(f"PP:{ids[-1]}")
        if version:
            fields.append(f"VN:{version}")
        if command_line:
            fields.append(f"CL:{command_line}")
        text = self.text
        if text and not text.endswith("\n"):
            text += "\n"
        return BamHeader(text + "\t".join(fields) + "\n", list(self.references))


@dataclass
class BamRecord:
    """One alignment record. pos is 0-based; qual holds raw Phred ints.

    tags maps 2-char keys to (type_char, value); type chars follow the SAM tag
    grammar (A c C s S i I f Z H B). For 'B', value is (subtype_char, list).
    """

    qname: str = "*"
    flag: int = 0
    ref_id: int = -1
    pos: int = -1
    mapq: int = 0
    cigar: list[tuple[int, int]] = field(default_factory=list)
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0
    seq: str = ""
    qual: bytes | None = None
    tags: dict[str, tuple[str, Any]] = field(default_factory=dict)

    # -- flag predicates -------------------------------------------------
    @property
    def is_paired(self) -> bool:
        return bool(self.flag & FPAIRED)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & FREAD1)

    @property
    def is_read2(self) -> bool:
        return bool(self.flag & FREAD2)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    # -- geometry --------------------------------------------------------
    @property
    def reference_length(self) -> int:
        return sum(ln for op, ln in self.cigar if _CONSUMES_REF[op])

    @property
    def reference_end(self) -> int:
        """0-based exclusive end (pos + ref-consumed length)."""
        return self.pos + self.reference_length

    @property
    def query_length(self) -> int:
        return sum(ln for op, ln in self.cigar if _CONSUMES_QUERY[op])

    # -- tags ------------------------------------------------------------
    def get_tag(self, key: str) -> Any:
        return self.tags[key][1]

    def has_tag(self, key: str) -> bool:
        return key in self.tags

    def set_tag(self, key: str, value: Any, type_char: str | None = None) -> None:
        if type_char is None:
            if isinstance(value, int):
                type_char = "i"
            elif isinstance(value, float):
                type_char = "f"
            elif isinstance(value, str):
                type_char = "Z"
            else:
                raise TypeError(f"cannot infer tag type for {value!r}")
        self.tags[key] = (type_char, value)

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{ln}{CIGAR_OPS[op]}" for op, ln in self.cigar)

    def copy(self) -> "BamRecord":
        return BamRecord(
            self.qname, self.flag, self.ref_id, self.pos, self.mapq,
            list(self.cigar), self.next_ref_id, self.next_pos, self.tlen,
            self.seq, self.qual, dict(self.tags),
        )


def reg2bin(beg: int, end: int) -> int:
    """BAI binning (SAM spec §5.3)."""
    end -= 1
    if end < 0:
        end = 0
    if beg < 0:
        beg = 0
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}
#: B-subtype -> little-endian numpy dtype for the vectorized array-tag
#: encode (byte-identical to the struct.pack path for in-range values).
_TAG_NP_DTYPE = {
    "c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
    "i": "<i4", "I": "<u4", "f": "<f4",
}


def skip_tag(data: bytes, off: int) -> int:
    """Offset just past the tag starting at data[off] (key + type char +
    value) — the tag byte widths for raw no-decode walkers (the MI splice
    of pipeline.group_umi); _decode_tags consumes the same layout."""
    tc = chr(data[off + 2])
    off += 3
    if tc == "A":
        return off + 1
    if tc in _TAG_FMT:
        return off + struct.calcsize(_TAG_FMT[tc])
    if tc in ("Z", "H"):
        return data.index(0, off) + 1
    if tc == "B":
        sub = chr(data[off])
        count = struct.unpack_from("<I", data, off + 1)[0]
        return off + 5 + count * struct.calcsize(_TAG_FMT[sub])
    raise BamError(f"unknown tag type {tc!r}")


def tag_region_offset(blob: bytes) -> int:
    """Byte offset of the tag region inside an encoded record blob
    (including its leading block_size prefix): fixed fields + qname +
    cigar + 4-bit seq + qual."""
    l_qname = blob[12]
    (n_cigar,) = struct.unpack_from("<H", blob, 16)
    (l_seq,) = struct.unpack_from("<i", blob, 20)
    return 36 + l_qname + 4 * n_cigar + (l_seq + 1) // 2 + l_seq


def _decode_tags(data: bytes, off: int) -> dict[str, tuple[str, Any]]:
    try:
        return _decode_tags_inner(data, off)
    except (ValueError, struct.error, IndexError, UnicodeDecodeError) as exc:
        # untrusted tag bytes: a lying count/unterminated Z string must
        # surface as the typed stream error, not a bare struct.error
        if isinstance(exc, BamError):
            raise
        raise BamError(f"corrupt record tags: {exc}") from None


def _decode_tags_inner(data: bytes, off: int) -> dict[str, tuple[str, Any]]:
    tags: dict[str, tuple[str, Any]] = {}
    n = len(data)
    while off < n:
        if off + 3 > n:
            raise BamError("corrupt record tags: truncated tag header")
        key = data[off : off + 2].decode("ascii")
        tc = chr(data[off + 2])
        off += 3
        if tc == "A":
            tags[key] = ("A", chr(data[off]))
            off += 1
        elif tc in _TAG_FMT:
            fmt = _TAG_FMT[tc]
            tags[key] = (tc, struct.unpack_from(fmt, data, off)[0])
            off += struct.calcsize(fmt)
        elif tc in ("Z", "H"):
            end = data.index(0, off)
            tags[key] = (tc, data[off:end].decode("ascii"))
            off = end + 1
        elif tc == "B":
            sub = chr(data[off])
            count = struct.unpack_from("<I", data, off + 1)[0]
            off += 5
            fmt = _TAG_FMT[sub]
            size = struct.calcsize(fmt)
            vals = list(struct.unpack_from(f"<{count}{fmt[1]}", data, off))
            tags[key] = ("B", (sub, vals))
            off += count * size
        else:
            raise BamError(f"unknown tag type {tc!r} for {key}")
    return tags


def _encode_tags(tags: dict[str, tuple[str, Any]]) -> bytes:
    out = bytearray()
    for key, (tc, val) in tags.items():
        out += key.encode("ascii")
        if tc == "A":
            out += b"A" + ord(val).to_bytes(1, "little")
        elif tc in _TAG_FMT:
            out += tc.encode("ascii") + struct.pack(_TAG_FMT[tc], val)
        elif tc in ("Z", "H"):
            out += tc.encode("ascii") + val.encode("ascii") + b"\x00"
        elif tc == "B":
            sub, vals = val
            if isinstance(vals, np.ndarray):
                # vectorized: one astype+tobytes instead of a per-element
                # struct.pack (the emitters pass per-base arrays as-is)
                out += b"B" + sub.encode("ascii")
                out += struct.pack("<I", vals.size)
                out += vals.astype(_TAG_NP_DTYPE[sub], copy=False).tobytes()
            else:
                out += b"B" + sub.encode("ascii")
                out += struct.pack("<I", len(vals))
                out += struct.pack(f"<{len(vals)}{_TAG_FMT[sub][1]}", *vals)
        else:
            raise BamError(f"unknown tag type {tc!r} for {key}")
    return bytes(out)


def _select_bgzf(engine: str, native_factory, python_factory):
    """The codec for one reader or writer: 'auto' and 'native' take the
    native C++ codec (a failed build raises; there is no fallback),
    'python' the pure codec. Both write the same bytes."""
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}; use auto|native|python")
    return python_factory() if engine == "python" else native_factory()


def _open_bgzf(path: str, engine: str, threads: int | None = None):
    def native_factory():
        from bsseqconsensusreads_tpu_torch.io.native import NativeBgzfReader

        return NativeBgzfReader(path, threads=threads)

    return _select_bgzf(engine, native_factory, lambda: BgzfReader.open(path))


def _create_bgzf(path: str, engine: str, level: int, threads: int | None = None):
    def native_factory():
        from bsseqconsensusreads_tpu_torch.io.native import NativeBgzfWriter

        return NativeBgzfWriter(path, level, threads=threads)

    def python_factory():
        # the Python codec tier shards deflate across threads when
        # workers are available (io.pbgzf; BSSEQ_TPU_PBGZF overrides) —
        # the serial BgzfWriter's bytes for any worker count
        from bsseqconsensusreads_tpu_torch.io import pbgzf

        workers = pbgzf.default_workers()
        if workers >= 2:
            return pbgzf.PBgzfWriter.open(path, level=level, workers=workers)
        return BgzfWriter.open(path, level=level)

    return _select_bgzf(engine, native_factory, python_factory)


def attach_codec_metrics(writer: "BamWriter", metrics) -> None:
    """Point a writer's parallel-deflate codec (io.pbgzf) at a stage's
    metrics so its worker-busy seconds and block counts are booked
    ('sort_write.deflate' and 'sort_write.deflate_span', pbgzf_*
    counters). No-op for the serial Python codec and the native codec
    (its threads account for themselves C-side)."""
    codec = getattr(writer, "_bgzf", None)
    if codec is not None and hasattr(codec, "workers") and hasattr(codec, "metrics"):
        codec.metrics = metrics


_REC_FIXED = struct.Struct("<iiBBHHHIiii")  # refID..tlen after block_size (32 bytes)


def read_bam_header(bgzf, path: str) -> BamHeader:
    """Parse the BAM header from an open BGZF reader with every
    untrusted length field bounds-checked — a lying l_text/n_ref must
    raise a typed BamError, not size a giant read or escape as a bare
    struct.error."""

    def _u32(what: str) -> int:
        raw = bgzf.read(4)
        if len(raw) < 4:
            raise BamError(f"corrupt BAM header (truncated {what})")
        return struct.unpack("<i", raw)[0]

    magic = bgzf.read(4)
    if magic != BAM_MAGIC:
        raise BamError(f"{path}: not a BAM file")
    l_text = _u32("l_text")
    if l_text < 0 or l_text > MAX_RECORD_SIZE:
        raise BamError("corrupt BAM header (bad l_text)")
    text_raw = bgzf.read(l_text)
    if len(text_raw) < l_text:
        raise BamError("corrupt BAM header (truncated text)")
    text = text_raw.decode("utf-8", "replace").rstrip("\x00")
    n_ref = _u32("n_ref")
    if n_ref < 0 or n_ref > (1 << 24):
        raise BamError("corrupt BAM header (bad n_ref)")
    refs = []
    for _ in range(n_ref):
        l_name = _u32("l_name")
        if l_name < 1 or l_name > (1 << 16):
            raise BamError("corrupt BAM header (bad l_name)")
        name_raw = bgzf.read(l_name)
        if len(name_raw) < l_name:
            raise BamError("corrupt BAM header (truncated name)")
        try:
            name = name_raw[:-1].decode("ascii")
        except UnicodeDecodeError:
            raise BamError("corrupt BAM header (non-ASCII name)") from None
        l_ref = _u32("l_ref")
        if l_ref < 0:
            raise BamError("corrupt BAM header (bad l_ref)")
        refs.append((name, l_ref))
    return BamHeader(text, refs)


def decode_record(data: bytes) -> BamRecord:
    """Decode one alignment from its variable-size data (sans block_size)."""
    (ref_id, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq, next_ref, next_pos, tlen) = _REC_FIXED.unpack_from(data, 0)
    off = 32
    try:
        qname = data[off : off + l_qname - 1].decode("ascii")
    except UnicodeDecodeError:
        raise BamError("corrupt record qname (non-ASCII bytes)") from None
    off += l_qname
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, off)[0]
        cigar.append((v & 0xF, v >> 4))
        off += 4
    nbytes = (l_seq + 1) // 2
    pairs = _NT16_PAIRS
    seq = "".join([pairs[b] for b in data[off : off + nbytes]])[:l_seq]
    off += nbytes
    qual_raw = data[off : off + l_seq]
    qual = None if (l_seq == 0 or (qual_raw and qual_raw[0] == 0xFF)) else qual_raw
    off += l_seq
    tags = _decode_tags(data, off)
    return BamRecord(qname, flag, ref_id, pos, mapq, cigar, next_ref, next_pos, tlen, seq, qual, tags)


def encode_record(rec: BamRecord) -> bytes:
    """Encode one alignment including its leading block_size field."""
    qname_b = rec.qname.encode("ascii") + b"\x00"
    l_seq = len(rec.seq)
    body = bytearray()
    body += _REC_FIXED.pack(
        rec.ref_id,
        rec.pos,
        len(qname_b),
        rec.mapq,
        reg2bin(rec.pos if rec.pos >= 0 else 0, rec.reference_end if rec.cigar else (rec.pos + 1 if rec.pos >= 0 else 1)),
        len(rec.cigar),
        rec.flag,
        l_seq,
        rec.next_ref_id,
        rec.next_pos,
        rec.tlen,
    )
    body += qname_b
    if rec.cigar:
        body += struct.pack(
            f"<{len(rec.cigar)}I", *((ln << 4) | op for op, ln in rec.cigar)
        )
    codes = _NT16_CODE[np.frombuffer(rec.seq.encode("ascii"), dtype=np.uint8)]
    if l_seq % 2:
        codes = np.append(codes, 0)
    body += ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
    if rec.qual is None:
        body += b"\xff" * l_seq
    else:
        if len(rec.qual) != l_seq:
            raise BamError(
                f"qual length {len(rec.qual)} != seq length {l_seq} for {rec.qname}"
            )
        body += rec.qual
    body += _encode_tags(rec.tags)
    return struct.pack("<i", len(body)) + bytes(body)


class BamReader:
    """Streaming BAM reader (iterate to get BamRecords).

    engine: 'auto' or 'native' read through the native C++ codec,
    'python' through the pure one. threads: the native codec's inflate
    workers (None = io.native.default_threads()); pass 1 for readers
    opened in bulk, such as a merge's fan-in."""

    def __init__(self, path: str, engine: str = "auto", threads: int | None = None):
        self._bgzf = _open_bgzf(path, engine, threads=threads)
        #: records handed out so far — the `record #N` of every typed
        #: stream error (0-based index of the record that failed)
        self.records_read = 0
        try:
            self.header = read_bam_header(self._bgzf, path)
        except BaseException:
            self._bgzf.close()
            raise

    def _voffset(self) -> int | None:
        return None

    def _next_blob(self, validate: bool = True) -> bytes | None:
        """Read one record body (sans prefix); None at clean EOF. Every
        refusal is a typed BamError carrying the record index (and
        block offset when the engine tracks one) — same rules, same
        record index as the JAX package's engines.

        validate=False skips the structural body check (framing and
        bounds stay): raw_records() replays the external sort's own spill
        runs."""
        raw = self._bgzf.read(4)
        if not raw:
            return None
        if len(raw) < 4:
            raise BamError(
                "truncated record size", record_index=self.records_read,
                voffset=self._voffset(),
            )
        (block_size,) = struct.unpack("<i", raw)
        if block_size < MIN_RECORD_SIZE or block_size > MAX_RECORD_SIZE:
            raise BamError(
                "corrupt record size", record_index=self.records_read,
                voffset=self._voffset(),
            )
        data = self._bgzf.read(block_size)
        if len(data) < block_size:
            raise BamError(
                "truncated record body", record_index=self.records_read,
                voffset=self._voffset(),
            )
        if validate:
            reason = check_record_body(data)
            if reason is not None:
                raise BamError(
                    reason, record_index=self.records_read,
                    voffset=self._voffset(),
                )
        # graftlint: disable=thread-unsafe-mutation -- a reader is confined to the one
        # ingest thread that iterates it
        self.records_read += 1
        return data

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            data = self._next_blob()
            if data is None:
                return
            yield decode_record(data)

    def raw_records(self, validate: bool = False) -> Iterator[bytes]:
        """Stream encoded record blocks (incl. their block_size prefix)
        WITHOUT decoding — the external sort's merge replays its spill
        runs this way. Pass validate=True when replaying record bytes
        from an untrusted source."""
        while True:
            data = self._next_blob(validate=validate)
            if data is None:
                return
            yield struct.pack("<i", len(data)) + data

    def get_reference_name(self, rid: int) -> str:
        return self.header.ref_name(rid)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self) -> "BamReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _FramingGap(Exception):
    """Internal: the BGZF layer resynced past corrupt blocks; record
    framing must be re-found before reading on."""


class GuardedBamReader:
    """The input guard's record reader: BamReader's surface (header + record
    iteration) with the guard's policy applied per record.

    * strict — every structural refusal is a typed BamError and every
      semantic violation a RecordGuardError, both carrying `record #N`
      (and the BGZF block offset on the python engine).
    * quarantine/lenient — runs on the pure-python BGZF engine with
      block resync armed: corrupt blocks are skipped (ledgered
      `stream_gap`), record framing is re-found by scanning for the
      next structurally-plausible record boundary, corrupt records go
      to the sidecar, truncated tails end the stream cleanly
      (`stream_truncated`). The iterator itself never raises for
      anything past the header.

    Records yielded are fully validated — the guard's
    `records_prevalidated` flag tells the family-level pass
    (faults.guard.guard_groups) not to re-check them.
    """

    #: decompressed bytes scanned for a plausible record boundary after
    #: a framing gap before declaring the tail lost
    FRAME_SCAN_LIMIT = 1 << 20

    def __init__(self, path: str, guard, engine: str = "auto"):
        self.guard = guard
        if guard.resilient:
            # resync needs the python block codec (seek + re-inflate)
            self._bgzf = BgzfReader.open(
                path, resync=True, on_event=self._stream_event
            )
        else:
            self._bgzf = _open_bgzf(path, engine)
        self.records_read = 0
        self._pending = b""  # decompressed pushback from frame scans
        try:
            self.header = read_bam_header(self._bgzf, path)
        except BaseException:
            self._bgzf.close()
            raise
        guard.bind(path, self.header)
        guard.records_prevalidated = True

    # -- plumbing ---------------------------------------------------------

    def _stream_event(self, kind: str, payload: dict) -> None:
        self.guard.stream_event(kind, payload)

    def _voffset(self) -> int | None:
        return getattr(self._bgzf, "last_block_offset", None)

    def _read(self, n: int) -> bytes:
        if self._pending:
            take, self._pending = self._pending[:n], self._pending[n:]
            if len(take) == n:
                return take
            return take + self._bgzf.read(n - len(take))
        return self._bgzf.read(n)

    def _gap_pending(self) -> bool:
        return bool(getattr(self._bgzf, "gap_pending", False))

    def _next_blob(self) -> bytes | None:
        """One structurally-valid record body, or None at clean EOF.
        Raises BamError (typed) on refusal and _FramingGap when the
        BGZF layer resynced mid-record."""
        raw = self._read(4)
        if not raw:
            if self._gap_pending():
                raise _FramingGap()
            return None
        if len(raw) < 4:
            if self._gap_pending():
                raise _FramingGap()
            raise BamError(
                "truncated record size", record_index=self.records_read,
                voffset=self._voffset(),
            )
        (block_size,) = struct.unpack("<i", raw)
        if block_size < MIN_RECORD_SIZE or block_size > MAX_RECORD_SIZE:
            raise BamError(
                "corrupt record size", record_index=self.records_read,
                voffset=self._voffset(),
            )
        data = self._read(block_size)
        if len(data) < block_size:
            if self._gap_pending():
                raise _FramingGap()
            raise BamError(
                "truncated record body", record_index=self.records_read,
                voffset=self._voffset(),
            )
        reason = check_record_body(data)
        if reason is not None:
            exc = BamError(
                reason, record_index=self.records_read,
                voffset=self._voffset(),
            )
            exc.blob = data  # framing survives: the blob is quarantinable
            raise exc
        return data

    def _find_frame(self) -> bool:
        """Scan the post-gap decompressed stream for the next offset
        where a structurally-valid record starts (its declared size
        fits, its body checks out, and — when enough bytes are buffered
        — the following record's size field is plausible too). Locks
        the stream there; False when no boundary exists in
        FRAME_SCAN_LIMIT bytes (tail lost)."""
        if hasattr(self._bgzf, "ack_gap"):
            self._bgzf.ack_gap()
        buf = self._pending + self._bgzf.read(self.FRAME_SCAN_LIMIT)
        self._pending = b""
        for off in range(0, max(len(buf) - MIN_RECORD_SIZE - 4, 0)):
            (bs,) = struct.unpack_from("<i", buf, off)
            if bs < MIN_RECORD_SIZE or bs > MAX_RECORD_SIZE:
                continue
            end = off + 4 + bs
            if end > len(buf):
                continue
            if check_record_body(buf[off + 4 : end]) is not None:
                continue
            if end + 4 <= len(buf):  # corroborate with the next size
                (bs2,) = struct.unpack_from("<i", buf, end)
                if bs2 != 0 and (
                    bs2 < MIN_RECORD_SIZE or bs2 > MAX_RECORD_SIZE
                ):
                    continue
            self.guard.stream_event("frame_resync", {
                "discarded_bytes": off, "voffset": self._voffset(),
            })
            self._pending = buf[off:]
            return True
        self.guard.stream_event("stream_truncated", {
            "error": "no record boundary after stream gap",
            "scanned": len(buf),
        })
        return False

    # -- iteration --------------------------------------------------------

    def __iter__(self) -> Iterator[BamRecord]:
        g = self.guard
        while True:
            try:
                data = self._next_blob()
            except _FramingGap:
                if not self._find_frame():
                    return
                continue
            except BamError as exc:
                if not g.resilient:
                    raise
                blob = getattr(exc, "blob", None)
                if blob is not None:
                    # framing intact: quarantine this record, read on
                    g.quarantine_blob(
                        blob, self.records_read, exc.reason,
                        voffset=self._voffset(),
                    )
                    self.records_read += 1
                    g.count("records_seen")
                    continue
                if exc.reason == "record-truncated":
                    g.stream_event(
                        "stream_truncated", {"error": str(exc)}
                    )
                    return
                # corrupt size field: framing lost, re-find a boundary
                g.stream_event("frame_lost", {"error": str(exc)})
                if not self._find_frame():
                    return
                continue
            if data is None:
                return
            index = self.records_read
            self.records_read += 1
            g.count("records_seen")
            try:
                rec = decode_record(data)
            except BamError as exc:
                if not g.resilient:
                    exc.record_index = index
                    raise
                g.quarantine_blob(
                    data, index, exc.reason, voffset=self._voffset()
                )
                continue
            rec = self._validate(rec, index)
            if rec is not None:
                yield rec

    def _validate(self, rec: BamRecord, index: int) -> BamRecord | None:
        from bsseqconsensusreads_tpu_torch.faults import guard as _guard

        g = self.guard
        if g.resilient and not rec.has_tag("MI"):
            g.quarantine_record(rec, index, "missing-mi")
            return None
        v = _guard.record_violation(
            rec, n_ref=g.n_ref, ref_lens=g.ref_lens,
            max_read_len=g.max_read_len,
        )
        if v is None:
            return rec
        reason, repairable = v
        if g.strict:
            raise _guard.RecordGuardError(
                f"record failed input validation: {reason}",
                reason=reason, record_index=index, qname=rec.qname,
            )
        if g.lenient and repairable:
            fixed = _guard.repair_record(rec)
            if fixed:
                g.repaired(rec, index, fixed)
                return rec
        g.quarantine_record(rec, index, reason)
        return None

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self) -> "GuardedBamReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RawRecords:
    """A block of pre-encoded BAM records.

    Batch streams may carry these alongside BamRecord objects; writers
    append the blob verbatim (write_items). count keeps record accounting
    without decoding."""

    __slots__ = ("blob", "count", "__weakref__")  # weakref: the host memory account

    def __init__(self, blob: bytes, count: int):
        self.blob = blob
        self.count = count


def write_items(writer: "BamWriter", items) -> int:
    """Write a mixed sequence of BamRecord / RawRecords; returns the record
    count written."""
    n = 0
    for item in items:
        if isinstance(item, RawRecords):
            writer.write_raw(item.blob)
            n += item.count
        else:
            writer.write(item)
            n += 1
    return n


class BamWriter:
    """Streaming BAM writer; pass the header (e.g. reader.header) up front.

    engine as in BamReader; threads: the native codec's deflate workers
    (None = io.native.default_threads())."""

    def __init__(self, path: str, header: BamHeader, level: int = 6,
                 engine: str = "auto", threads: int | None = None):
        self.header = header
        self._bgzf = _create_bgzf(path, engine, level, threads=threads)
        try:
            text = header.text.encode("utf-8")
            out = bytearray(BAM_MAGIC)
            out += struct.pack("<i", len(text))
            out += text
            out += struct.pack("<i", len(header.references))
            for name, length in header.references:
                nb = name.encode("ascii") + b"\x00"
                out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
            self._bgzf.write(bytes(out))
        except BaseException:
            self._bgzf.close()
            raise

    def write(self, rec: BamRecord) -> None:
        self._bgzf.write(encode_record(rec))

    def write_raw(self, blob: bytes) -> None:
        """Append pre-encoded record bytes (one or more complete records,
        each with its block_size prefix), as raw_records() produces."""
        self._bgzf.write(blob)

    def write_raw_many(self, blobs: Iterable[bytes], chunk: int = 1 << 20) -> int:
        """Append a stream of pre-encoded record blobs, coalesced into
        ~`chunk`-byte writes (the external sort moves millions of small
        blobs). Returns the number of blobs written."""
        buf = bytearray()
        n = 0
        for blob in blobs:
            buf += blob
            n += 1
            if len(buf) >= chunk:
                self._bgzf.write(bytes(buf))
                buf.clear()
        if buf:
            self._bgzf.write(bytes(buf))
        return n

    def write_all(self, recs: Iterable[BamRecord]) -> None:
        for rec in recs:
            self.write(rec)

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self) -> "BamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
