"""BGZF (blocked gzip) codec — the container format of BAM.

Pure-Python implementation over zlib: the port's own copy of the JAX
package's python engine (io/bgzf.py there), with the stream-resync mode
of the input guard (faults.guard) and the `bgzf_inflate` / `bgzf_write`
failpoints. The native codec is io.native; io.pbgzf shards this
module's block deflate across threads.

Format: a BGZF file is a sequence of gzip members, each with an FEXTRA "BC"
subfield carrying BSIZE (total member size - 1), uncompressed payload at most
65280 bytes, terminated by a fixed 28-byte empty block (EOF marker).
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults.guard import StreamGuardError

# Largest uncompressed payload per block (htslib convention: 64KiB minus slop).
MAX_BLOCK_SIZE = 65280

# The canonical 28-byte BGZF EOF marker (an empty block).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH")  # magic(2) CM FLG MTIME XFL OS XLEN — 12 bytes


class BgzfError(StreamGuardError):
    """BGZF framing/integrity error. Subclasses the graftguard typed
    stream error (which is an IOError, preserving the historical
    ancestry) so every corruption an input stream can cause is a
    faults.guard.GuardError — the fuzz contract's 'clean typed error'."""


def _parse_block_size(extra: bytes) -> int:
    """Scan FEXTRA subfields for the BC subfield and return BSIZE+1."""
    off = 0
    while off + 4 <= len(extra):
        si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:  # 'B','C'
            if off + 6 > len(extra):  # BSIZE itself truncated away
                break
            return struct.unpack_from("<H", extra, off + 4)[0] + 1
        off += 4 + slen
    raise BgzfError("BGZF block missing BC extra subfield")


class BgzfReader:
    """Streaming BGZF decompressor with a file-like read() interface.

    resync=True arms the graftguard stream-resilience mode: a corrupt
    or truncated block raises nothing — the reader scans forward for
    the next block that parses AND inflates cleanly (CRC-checked),
    resumes there, and flags the discontinuity via `gap_pending` (the
    record layer must re-find a record boundary; io.bam's guarded
    iterator does). A truncated tail (missing EOF marker / partial
    final block with no later block) becomes a clean end-of-stream,
    also flagged. `on_event(kind, payload)` receives one callback per
    resync/truncation so the guard can ledger and count it.
    """

    #: bytes scanned forward for the next valid block before giving up
    RESYNC_SCAN_LIMIT = 1 << 22

    def __init__(self, fileobj: BinaryIO, resync: bool = False,
                 on_event=None):
        self._fh = fileobj
        self._buf = b""
        self._buf_off = 0
        self._eof = False
        self._last_block_empty = False
        self._resync = resync
        self._on_event = on_event
        #: file offset of the most recent block's first byte (None when
        #: the underlying file object is not seekable)
        self.last_block_offset: int | None = 0
        #: a resync skipped bytes and record framing is lost; cleared
        #: by the consumer via ack_gap()
        self.gap_pending = False
        self._gap_just = False

    @classmethod
    def open(cls, path: str, resync: bool = False,
             on_event=None) -> "BgzfReader":
        return cls(open(path, "rb"), resync=resync, on_event=on_event)

    def _event(self, kind: str, payload: dict) -> None:
        if self._on_event is not None:
            self._on_event(kind, payload)

    def _tell(self) -> int | None:
        try:
            return self._fh.tell()
        except (OSError, AttributeError):
            return None

    def _read_block(self) -> bytes | None:
        if not self._resync:
            return self._read_block_raw()
        try:
            return self._read_block_raw()
        except BgzfError as exc:
            return self._resync_block(exc)

    def _resync_block(self, exc: BgzfError) -> bytes | None:
        """Skip-to-next-block recovery: scan forward from just past the
        corrupt block's start for the next gzip member that parses as
        BGZF and inflates with a matching CRC. No candidate within
        RESYNC_SCAN_LIMIT (or an unseekable stream) ends the stream as
        a truncated tail instead."""
        start = self.last_block_offset
        if start is None or not self._fh.seekable():
            self._event("stream_truncated", {"error": str(exc)})
            # suppress the EOF-marker raise; reader state is confined to
            # the one ingest thread that owns this reader
            # graftlint: disable=thread-unsafe-mutation -- confined to the one ingest
            # thread that owns this reader
            self._last_block_empty = True
            return None
        scan_from = start + 1
        self._fh.seek(scan_from)
        window = self._fh.read(self.RESYNC_SCAN_LIMIT)
        off = 0
        while True:
            hit = window.find(b"\x1f\x8b\x08\x04", off)
            if hit < 0:
                self._event("stream_truncated", {
                    "error": str(exc), "scanned": len(window),
                })
                self._fh.seek(0, 2)  # consume: later reads see EOF
                # graftlint: disable=thread-unsafe-mutation -- confined to the reader's
                # ingest thread
                self._last_block_empty = True
                return None
            self._fh.seek(scan_from + hit)
            try:
                data = self._read_block_raw()
            except BgzfError:
                off = hit + 1
                continue
            self._event("stream_gap", {
                "error": str(exc),
                "gap_start": start,
                "resumed_at": scan_from + hit,
                "skipped_bytes": scan_from + hit - start,
            })
            # graftlint: disable=thread-unsafe-mutation -- confined to the reader's
            # ingest thread
            self._gap_just = True
            # graftlint: disable=thread-unsafe-mutation -- confined to the reader's
            # ingest thread
            self.gap_pending = True
            return data

    def ack_gap(self) -> None:
        """Consumer acknowledges a framing gap (after re-finding a
        record boundary in the post-gap bytes)."""
        self.gap_pending = False

    def _read_block_raw(self) -> bytes | None:
        # graftlint: disable=thread-unsafe-mutation -- confined to the reader's ingest
        # thread
        self.last_block_offset = self._tell()
        head = self._fh.read(12)
        if not head:
            # A well-formed BGZF stream ends with an empty block (the 28-byte
            # EOF marker). Reaching physical EOF without one means the writer
            # was killed between flush and close — data may be missing.
            if not self._last_block_empty:
                raise BgzfError("BGZF EOF marker missing (file truncated?)")
            return None
        if len(head) < 12:
            raise BgzfError("truncated BGZF block header")
        magic1, magic2, cm, flg, _mtime, _xfl, _os, xlen = _HEADER.unpack(head)
        if magic1 != 0x1F or magic2 != 0x8B or cm != 8 or not (flg & 4):
            raise BgzfError("not a BGZF stream (bad gzip/FEXTRA header)")
        extra = self._fh.read(xlen)
        bsize = _parse_block_size(extra)
        cdata_len = bsize - 12 - xlen - 8
        if cdata_len < 0:  # untrusted 16-bit field vs declared XLEN
            raise BgzfError("corrupt BGZF BSIZE")
        cdata = self._fh.read(cdata_len)
        tail = self._fh.read(8)
        if len(cdata) < cdata_len or len(tail) < 8:
            raise BgzfError("truncated BGZF block")
        crc, isize = struct.unpack("<II", tail)
        if _failpoints.ARMED:  # guarded: this runs once per 64K block
            _failpoints.fire("bgzf_inflate")
        try:
            data = zlib.decompress(cdata, wbits=-15)
        except zlib.error as exc:  # corrupt deflate stream, typed
            raise BgzfError(f"BGZF inflate failed: {exc}") from None
        if len(data) != isize:
            raise BgzfError("BGZF ISIZE mismatch")
        if zlib.crc32(data) != crc:
            raise BgzfError("BGZF CRC mismatch")
        # graftlint: disable=thread-unsafe-mutation -- reader state is confined to the
        # reader's ingest thread
        self._last_block_empty = len(data) == 0
        return data

    def read(self, n: int) -> bytes:
        """Read exactly n bytes unless EOF intervenes (then fewer)."""
        parts = []
        need = n
        while need > 0:
            avail = len(self._buf) - self._buf_off
            if avail == 0:
                if self._eof:
                    break
                block = self._read_block()
                if block is None:
                    # graftlint: disable=thread-unsafe-mutation -- confined to the
                    # reader's ingest thread
                    self._eof = True
                    break
                # graftlint: disable=thread-unsafe-mutation -- confined to the reader's
                # ingest thread
                self._buf = block
                # graftlint: disable=thread-unsafe-mutation -- confined to the reader's
                # ingest thread
                self._buf_off = 0
                if self._gap_just:
                    # a resync happened: never splice pre- and post-gap
                    # bytes into one logical read — return short and
                    # leave the post-gap block buffered for the record
                    # layer's re-framing pass
                    # graftlint: disable=thread-unsafe-mutation -- confined to the
                    # reader's ingest thread
                    self._gap_just = False
                    break
                continue
            take = min(avail, need)
            parts.append(self._buf[self._buf_off : self._buf_off + take])
            # graftlint: disable=thread-unsafe-mutation -- confined to the reader's
            # ingest thread
            self._buf_off += take
            need -= take
        return b"".join(parts)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "BgzfReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def deflate_block(data: bytes, level: int = 6) -> bytes:
    """Compress one <=MAX_BLOCK_SIZE payload into a complete framed BGZF
    block (gzip member with the BC/BSIZE FEXTRA subfield + CRC32/ISIZE
    footer). THE one block encoder — BgzfWriter and the parallel codec
    (io.pbgzf) both call it, so the incompressible-payload retry and the
    frame bytes cannot drift between the serial and sharded paths: the
    same payload sequence always produces the same file bytes, whatever
    codec or worker count wrote it. Each block is an independent deflate
    stream, which is exactly what makes sharding deflate across threads
    byte-identical to the serial writer."""
    if _failpoints.ARMED:  # guarded: this runs once per 64K block
        _failpoints.fire("bgzf_write")
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 12 + 6 + 8  # header + xtra + footer
    if bsize > 65536:
        # Incompressible payload: store with minimal compression instead.
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        bsize = len(cdata) + 12 + 6 + 8
    return (
        _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        + struct.pack("<2BHH", 0x42, 0x43, 2, bsize - 1)
        + cdata
        + struct.pack("<II", zlib.crc32(data), len(data))
    )


class BgzfWriter:
    """Streaming BGZF compressor; writes the EOF marker on close."""

    def __init__(self, fileobj: BinaryIO, level: int = 6):
        self._fh = fileobj
        self._level = level
        self._buf = bytearray()
        self._closed = False

    @classmethod
    def open(cls, path: str, level: int = 6) -> "BgzfWriter":
        return cls(open(path, "wb"), level=level)

    def write(self, data: bytes) -> None:
        # graftlint: disable=thread-unsafe-mutation -- writer objects are confined to
        # the thread that writes the output (the pool only deflates detached payloads)
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_SIZE:
            self._flush_block(bytes(self._buf[:MAX_BLOCK_SIZE]))
            del self._buf[:MAX_BLOCK_SIZE]

    def _flush_block(self, data: bytes) -> None:
        self._fh.write(deflate_block(data, self._level))

    def flush(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        # graftlint: disable=thread-unsafe-mutation -- writer objects are confined to
        # their writing thread
        self._closed = True

    def __enter__(self) -> "BgzfWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

