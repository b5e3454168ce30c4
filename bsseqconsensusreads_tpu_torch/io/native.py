"""ctypes bindings for the port's native BGZF/BAM codec (csrc/host/bamio.cpp).

The port's copy of the JAX package's io/native.py. The library builds at
first use (io._nativelib) and a failed build or load raises
io._nativelib.NativeLibraryError: no entry point here degrades to the
Python codec. Callers that want the Python engines name them
(io.bam engine='python', stages ingest='python').

* NativeBgzfReader / NativeBgzfWriter — the BGZF codec, inflate and
  deflate on a worker pool (in-order, byte-identical to one thread).
* read_columnar / read_grouped_columnar — records decoded in C into
  ColumnarBatch arrays; the grouped form reorders them into contiguous
  whole-MI-family runs (the C twin of calling.stream_mi_groups).
* encode_scan / encode_fill / duplex_scan / duplex_fill — the encoders'
  per-record pass and tensor fill (ops.encode's native paths).
* merge_runs — the k-way merge of sorted spill runs into a writer.
"""

from __future__ import annotations

import ctypes as C
import os
import struct

import numpy as np

from bsseqconsensusreads_tpu_torch.faults.guard import (
    GuardError,
    MissingTagError,
    classify_stream_error,
)
from bsseqconsensusreads_tpu_torch.io import _nativelib

REQUIRED_SYMBOLS = (
    "bamio_open", "bamio_read", "bamio_error", "bamio_close",
    "bamio_create", "bamio_write", "bamio_writer_error",
    "bamio_finish", "bamio_create_mt", "bamio_write_mt",
    "bamio_writer_error_mt", "bamio_finish_mt",
    "bamio_parse_records4", "bamio_parse_grouped3",
    "bamio_group_start", "bamio_group_error",
    "bamio_group_refragmented", "bamio_group_free",
    "bamio_encode_scan", "bamio_encode_fill",
    "bamio_duplex_scan", "bamio_duplex_fill",
    "bamio_open_mt", "bamio_merge_runs",
)

_LIB = None


def lib() -> C.CDLL:
    """The codec library with its C signatures declared; builds it at
    first use and raises NativeLibraryError when it cannot."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _nativelib.load("bamio", REQUIRED_SYMBOLS)
    vp = C.c_void_p
    lib.bamio_open.restype = vp
    lib.bamio_open.argtypes = [C.c_char_p, C.c_char_p, C.c_int]
    lib.bamio_open_mt.restype = vp
    lib.bamio_open_mt.argtypes = [C.c_char_p, C.c_int, C.c_char_p, C.c_int]
    lib.bamio_read.restype = C.c_int64
    lib.bamio_read.argtypes = [vp, vp, C.c_int64]
    lib.bamio_error.restype = C.c_char_p
    lib.bamio_error.argtypes = [vp]
    lib.bamio_close.argtypes = [vp]
    lib.bamio_create.restype = vp
    lib.bamio_create.argtypes = [C.c_char_p, C.c_int, C.c_char_p, C.c_int]
    lib.bamio_write.restype = C.c_int
    lib.bamio_write.argtypes = [vp, vp, C.c_int64]
    lib.bamio_writer_error.restype = C.c_char_p
    lib.bamio_writer_error.argtypes = [vp]
    lib.bamio_finish.restype = C.c_int
    lib.bamio_finish.argtypes = [vp]
    lib.bamio_create_mt.restype = vp
    lib.bamio_create_mt.argtypes = [C.c_char_p, C.c_int, C.c_int, C.c_char_p, C.c_int]
    lib.bamio_write_mt.restype = C.c_int
    lib.bamio_write_mt.argtypes = [vp, vp, C.c_int64]
    lib.bamio_writer_error_mt.restype = C.c_char_p
    lib.bamio_writer_error_mt.argtypes = [vp]
    lib.bamio_finish_mt.restype = C.c_int
    lib.bamio_finish_mt.argtypes = [vp]
    lib.bamio_parse_records4.restype = C.c_int64
    lib.bamio_parse_records4.argtypes = [
        vp, C.c_int64,
        vp, vp, vp, vp,
        vp, vp, vp, vp,
        vp,
        vp, vp, C.c_int64, vp,
        vp, C.c_int64, vp,
        C.c_char_p, C.c_int, C.c_char_p, C.c_int, C.c_char_p, C.c_int,
        vp, vp, vp, vp,
        vp, C.c_int64, vp, vp,
    ]
    lib.bamio_group_start.restype = vp
    lib.bamio_group_start.argtypes = [C.c_int64, C.c_int]
    lib.bamio_group_error.restype = C.c_char_p
    lib.bamio_group_error.argtypes = [vp]
    lib.bamio_group_refragmented.restype = C.c_int64
    lib.bamio_group_refragmented.argtypes = [vp]
    lib.bamio_group_free.argtypes = [vp]
    lib.bamio_parse_grouped3.restype = C.c_int64
    lib.bamio_parse_grouped3.argtypes = (
        [vp, vp, C.c_int64]  # Reader*, Grouper*, max_records
        + lib.bamio_parse_records4.argtypes[2:]
        + [C.c_char_p, C.c_int, vp, C.c_int64, vp]
    )
    lib.bamio_encode_scan.restype = C.c_int64
    lib.bamio_encode_scan.argtypes = (
        [C.c_int64, vp, vp]              # n_fam, fam_start, fam_nrec
        + [vp] * 8                        # flag..cigar_flags
        + [vp, C.c_int32, vp, C.c_int32]  # qname/w, rx/w
        + [C.c_int32, C.c_int64]          # indel_policy, band
        + [vp] * 10                       # outputs
    )
    lib.bamio_encode_fill.restype = C.c_int64
    lib.bamio_encode_fill.argtypes = (
        [C.c_int64] + [vp] * 14 + [C.c_int64, C.c_int64] + [vp, vp]
    )
    lib.bamio_duplex_scan.restype = C.c_int64
    lib.bamio_duplex_scan.argtypes = (
        [C.c_int64, vp, vp]  # n_fam, fam_start, fam_nrec
        + [vp] * 7            # flag..cigar_flags
        + [vp, C.c_int32]     # rx, rx_w
        + [vp] * 8            # outputs
    )
    lib.bamio_duplex_fill.restype = C.c_int64
    lib.bamio_duplex_fill.argtypes = [C.c_int64] + [vp] * 12 + [C.c_int64] + [vp] * 3
    lib.bamio_merge_runs.restype = C.c_int64
    lib.bamio_merge_runs.argtypes = [
        C.POINTER(vp), C.c_int32, vp, C.c_int32,
        C.c_char_p, C.c_int32, C.POINTER(C.c_double),
    ]
    _LIB = lib
    return lib


def default_threads() -> int:
    """BGZF worker threads when the caller names none: min(4, cpu count)."""
    return min(4, os.cpu_count() or 1)


class NativeBgzfReader:
    """io.bgzf.BgzfReader's surface on the C++ codec.

    Reads cross the ctypes boundary in 4 MiB chunks and are served from a
    Python-side buffer. threads > 1 inflates BGZF blocks on a worker pool
    with in-order delivery (identical byte stream)."""

    _CHUNK = 1 << 22

    def __init__(self, path: str, threads: int | None = None):
        self._lib = lib()
        err = C.create_string_buffer(256)
        n = default_threads() if threads is None else threads
        self._h = self._lib.bamio_open_mt(path.encode(), n, err, 256)
        if not self._h:
            raise IOError(err.value.decode())
        self._buf = b""
        self._off = 0

    def _fill(self) -> bool:
        buf = C.create_string_buffer(self._CHUNK)
        got = self._lib.bamio_read(self._h, buf, self._CHUNK)
        if got < 0:
            raise classify_stream_error(self._lib.bamio_error(self._h).decode())
        if got == 0:
            return False
        self._buf = buf.raw[:got]
        self._off = 0
        return True

    def read(self, n: int) -> bytes:
        avail = len(self._buf) - self._off
        if avail >= n:  # fast path: serve from the buffer
            out = self._buf[self._off : self._off + n]
            self._off += n
            return out
        parts = [self._buf[self._off :]]
        need = n - avail
        self._buf, self._off = b"", 0
        while need > 0:
            if not self._fill():
                break
            take = min(need, len(self._buf))
            parts.append(self._buf[:take])
            self._off = take
            need -= take
        return b"".join(parts)

    def read_unbuffered(self, n: int) -> bytes:
        """Exact read through ctypes with no Python-side buffering — the
        native parsers read from the C stream position and must not skip
        buffered bytes."""
        if self._off != len(self._buf):
            raise GuardError("unbuffered read after buffered read")
        buf = C.create_string_buffer(n)
        got = self._lib.bamio_read(self._h, buf, n)
        if got < 0:
            raise classify_stream_error(self._lib.bamio_error(self._h).decode())
        return buf.raw[:got]

    def close(self) -> None:
        if self._h:
            self._lib.bamio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeBgzfWriter:
    """io.bgzf.BgzfWriter's surface on the C++ codec. threads > 1
    compresses BGZF blocks on a worker pool with in-order writes —
    byte-identical to one thread (each block is an independent deflate
    stream)."""

    def __init__(self, path: str, level: int = 6, threads: int | None = None):
        self._lib = lib()
        threads = default_threads() if threads is None else threads
        self._mt = threads > 1
        err = C.create_string_buffer(256)
        if self._mt:
            self._h = self._lib.bamio_create_mt(path.encode(), level, threads, err, 256)
        else:
            self._h = self._lib.bamio_create(path.encode(), level, err, 256)
        if not self._h:
            raise IOError(err.value.decode())

    def write(self, data: bytes) -> None:
        fn = self._lib.bamio_write_mt if self._mt else self._lib.bamio_write
        if fn(self._h, data, len(data)) != 0:
            errfn = (self._lib.bamio_writer_error_mt if self._mt
                     else self._lib.bamio_writer_error)
            raise IOError(errfn(self._h).decode())

    def flush(self) -> None:
        pass  # blocks flush on close

    def close(self) -> None:
        if self._h:
            finish = self._lib.bamio_finish_mt if self._mt else self._lib.bamio_finish
            rc = finish(self._h)
            self._h = None
            if rc != 0:
                raise IOError("bamio_finish failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ColumnarBatch:
    """One parsed batch of records as flat numpy arrays.

    seq codes are already in the framework alphabet (A=0..T=3, N=4); per
    record i the bases/quals live at var_off[i] : var_off[i]+l_seq[i] and the
    cigar at cigar_off[i] : cigar_off[i]+n_cigar[i] (u32, len<<4|op). The
    aux planes hold each record's cd then ce values (u16) at aux_off[i],
    plus the 4n cB histogram when aux_len[i] carries the 1<<30 bit.
    """

    __slots__ = (
        "n", "ref_id", "pos", "flag", "mapq", "l_seq", "next_ref",
        "next_pos", "tlen", "n_cigar", "seq", "qual", "var_off",
        "cigar", "cigar_off", "qname", "mi", "rx",
        "ref_span", "left_clip", "right_clip", "cigar_flags",
        "aux", "aux_off", "aux_len",
    )

    def __init__(self, n, **arrays):
        self.n = n
        for k, v in arrays.items():
            setattr(self, k, v)


def _skip_header(r: NativeBgzfReader, path: str) -> None:
    """Skip the BAM header on a fresh native stream, with the same
    untrusted-length bounds as io.bam.read_bam_header (a lying l_text
    must raise typed, not size a giant read)."""
    from bsseqconsensusreads_tpu_torch.io.bam import MAX_RECORD_SIZE, BamError

    def _i32(what: str) -> int:
        raw = r.read_unbuffered(4)
        if len(raw) < 4:
            raise BamError(f"corrupt BAM header (truncated {what})")
        return struct.unpack("<i", raw)[0]

    if r.read_unbuffered(4) != b"BAM\x01":
        raise BamError(f"{path}: not a BAM file")
    l_text = _i32("l_text")
    if l_text < 0 or l_text > MAX_RECORD_SIZE:
        raise BamError("corrupt BAM header (bad l_text)")
    if len(r.read_unbuffered(l_text)) < l_text:
        raise BamError("corrupt BAM header (truncated text)")
    n_ref = _i32("n_ref")
    if n_ref < 0 or n_ref > (1 << 24):
        raise BamError("corrupt BAM header (bad n_ref)")
    for _ in range(n_ref):
        l_name = _i32("l_name")
        if l_name < 1 or l_name > (1 << 16):
            raise BamError("corrupt BAM header (bad l_name)")
        if len(r.read_unbuffered(l_name + 4)) < l_name + 4:
            raise BamError("corrupt BAM header (truncated name)")


def _alloc_batch(n: int, var_bytes: int, qname_width: int, tag_width: int):
    """Batch buffers + the ctypes argument list bamio_parse_records4 and
    bamio_parse_grouped3 share (from max_records onward)."""
    bufs = {
        "ref_id": np.empty(n, np.int32),
        "pos": np.empty(n, np.int32),
        "flag": np.empty(n, np.uint16),
        "mapq": np.empty(n, np.uint8),
        "l_seq": np.empty(n, np.int32),
        "next_ref": np.empty(n, np.int32),
        "next_pos": np.empty(n, np.int32),
        "tlen": np.empty(n, np.int32),
        "n_cigar": np.empty(n, np.uint16),
        "seq": np.empty(var_bytes, np.uint8),
        "qual": np.empty(var_bytes, np.uint8),
        "var_off": np.empty(n, np.int64),
        "cigar": np.empty(var_bytes // 16, np.uint32),
        "cigar_off": np.empty(n, np.int64),
        # calloc-backed: the fixed-width name/tag planes are NUL-padded
        "qname": np.zeros(n * qname_width, np.uint8),
        "mi": np.zeros(n * tag_width, np.uint8),
        "rx": np.zeros(n * tag_width, np.uint8),
        "ref_span": np.empty(n, np.int32),
        "left_clip": np.empty(n, np.int32),
        "right_clip": np.empty(n, np.int32),
        "cigar_flags": np.empty(n, np.uint8),
        # cd/ce(/cB) aux planes, sized 6 * var_bytes elements so a var fit
        # implies an aux fit even with every record carrying cB; np.empty
        # commits no pages for inputs without the tags
        "aux": np.empty(6 * var_bytes, np.uint16),
        "aux_off": np.empty(n, np.int64),
        "aux_len": np.empty(n, np.int32),
    }

    def p(k):
        return bufs[k].ctypes.data_as(C.c_void_p)

    args = [
        p("ref_id"), p("pos"), p("flag"), p("mapq"), p("l_seq"),
        p("next_ref"), p("next_pos"), p("tlen"), p("n_cigar"),
        p("seq"), p("qual"), var_bytes, p("var_off"),
        p("cigar"), var_bytes // 16, p("cigar_off"),
        bufs["qname"].ctypes.data_as(C.c_char_p), qname_width,
        bufs["mi"].ctypes.data_as(C.c_char_p), tag_width,
        bufs["rx"].ctypes.data_as(C.c_char_p), tag_width,
        p("ref_span"), p("left_clip"), p("right_clip"), p("cigar_flags"),
        p("aux"), 6 * var_bytes, p("aux_off"), p("aux_len"),
    ]
    return bufs, args


def _batch_from(bufs, got: int, qname_width: int, tag_width: int) -> ColumnarBatch:
    fixed = ("ref_id", "pos", "flag", "mapq", "l_seq", "next_ref",
             "next_pos", "tlen", "n_cigar", "var_off", "cigar_off",
             "ref_span", "left_clip", "right_clip", "cigar_flags",
             "aux_off", "aux_len")
    return ColumnarBatch(
        int(got),
        **{k: bufs[k][:got] for k in fixed},
        seq=bufs["seq"],
        qual=bufs["qual"],
        cigar=bufs["cigar"],
        aux=bufs["aux"],
        qname=bufs["qname"].view(f"S{qname_width}")[:got],
        mi=bufs["mi"].view(f"S{tag_width}")[:got],
        rx=bufs["rx"].view(f"S{tag_width}")[:got],
    )


# qname_width 256 covers BAM's hard limit (l_read_name is a uint8: <= 254
# chars + NUL), so the parser's clamp never truncates a legal qname —
# truncation would merge distinct templates (encode pairs R1/R2 by qname)


def read_columnar(
    path: str,
    batch_records: int = 1 << 16,
    var_bytes: int = 1 << 25,
    qname_width: int = 256,
    tag_width: int = 48,
    threads: int | None = None,
):
    """Stream a BAM file as ColumnarBatches (the header is parsed apart by
    BamReader; this opens a fresh native stream and skips it). A mid-batch
    corruption yields the parsed prefix, then raises the typed stream
    error with the failing record's index — the index the Python engine
    reports."""
    L = lib()
    r = NativeBgzfReader(path, threads=threads)
    total = 0
    try:
        _skip_header(r, path)
        while True:
            bufs, args = _alloc_batch(batch_records, var_bytes, qname_width, tag_width)
            got = L.bamio_parse_records4(r._h, batch_records, *args)
            msg = L.bamio_error(r._h).decode()
            if got > 0:
                total += got
                yield _batch_from(bufs, got, qname_width, tag_width)
            if msg:
                raise classify_stream_error(msg, record_index=total)
            if got <= 0:
                return
    finally:
        r.close()


def read_grouped_columnar(
    path: str,
    flush_margin: int = 10_000,
    strip_suffix: bool = False,
    batch_records: int = 1 << 16,
    var_bytes: int = 1 << 25,
    qname_width: int = 256,
    tag_width: int = 48,
    threads: int | None = None,
):
    """Stream ColumnarBatches whose records are reordered into contiguous
    whole-MI-family runs by the C coordinate grouper (bamio_parse_grouped3
    — the C twin of pipeline.calling.stream_mi_groups; flush_margin < 0
    selects its adjacent mode).

    Yields (batch, fam_mi bytes array [nf], fam_nrec int32 [nf],
    refragmented_delta). A record without an MI tag raises
    MissingTagError (reference parity: tools/2.extend_gap.py:180). A
    single family larger than the buffers grows them and retries."""
    L = lib()
    r = NativeBgzfReader(path, threads=threads)
    g = L.bamio_group_start(flush_margin, int(strip_suffix))
    refrag_prev = 0
    records_seen = 0
    try:
        _skip_header(r, path)
        while True:
            bufs, args = _alloc_batch(batch_records, var_bytes, qname_width, tag_width)
            fam_cap = batch_records
            fam_mi = np.zeros(fam_cap * tag_width, np.uint8)
            fam_nrec = np.empty(fam_cap, np.int32)
            n_fams = C.c_int64(0)
            got = L.bamio_parse_grouped3(
                r._h, g, batch_records, *args,
                fam_mi.ctypes.data_as(C.c_char_p), tag_width,
                fam_nrec.ctypes.data_as(C.c_void_p), fam_cap,
                C.byref(n_fams),
            )
            if got == -1:
                raise classify_stream_error(
                    L.bamio_error(r._h).decode(), record_index=records_seen)
            if got == -2:
                raise MissingTagError(L.bamio_group_error(g).decode())
            if got == -3:  # one family exceeds the buffers: grow and retry
                batch_records *= 2
                var_bytes *= 2
                continue
            if got == 0:
                return
            nf = n_fams.value
            records_seen += int(got)
            refrag = int(L.bamio_group_refragmented(g))
            delta, refrag_prev = refrag - refrag_prev, refrag
            yield (
                _batch_from(bufs, got, qname_width, tag_width),
                fam_mi.view(f"S{tag_width}")[:nf],
                fam_nrec[:nf],
                delta,
            )
    finally:
        L.bamio_group_free(g)
        r.close()


def _vp(a: np.ndarray) -> C.c_void_p:
    return a.ctypes.data_as(C.c_void_p)


def encode_scan(batch, fam_start: np.ndarray, fam_nrec: np.ndarray,
                indel_policy: str, indel_band: int) -> dict[str, np.ndarray]:
    """The C molecular-encode scan (bamio_encode_scan) over contiguous
    family runs of one ColumnarBatch: per-family digest and per-record
    placement arrays, semantics of encode_molecular_families' first pass
    (see csrc/host/bamio.cpp)."""
    nf = len(fam_start)
    n = batch.n
    out = {
        "lo": np.empty(nf, np.int64),
        "window": np.empty(nf, np.int64),
        "ntpl": np.empty(nf, np.int32),
        "ntpl_est": np.empty(nf, np.int32),
        "rolerev": np.empty(nf, np.uint8),
        "refid": np.empty(nf, np.int32),
        "rx_rec": np.empty(nf, np.int64),
        "ti": np.empty(n, np.int32),
        "role": np.empty(n, np.uint8),
        "keep": np.empty(n, np.uint8),
    }
    rc = lib().bamio_encode_scan(
        nf, _vp(fam_start), _vp(fam_nrec),
        _vp(batch.flag), _vp(batch.pos), _vp(batch.ref_id),
        _vp(batch.l_seq), _vp(batch.var_off),
        _vp(batch.left_clip), _vp(batch.right_clip), _vp(batch.cigar_flags),
        _vp(batch.qname.view(np.uint8)), batch.qname.dtype.itemsize,
        _vp(batch.rx.view(np.uint8)), batch.rx.dtype.itemsize,
        0 if indel_policy == "drop" else 1, indel_band,
        _vp(out["lo"]), _vp(out["window"]),
        _vp(out["ntpl"]), _vp(out["ntpl_est"]),
        _vp(out["rolerev"]), _vp(out["refid"]), _vp(out["rx_rec"]),
        _vp(out["ti"]), _vp(out["role"]), _vp(out["keep"]),
    )
    if rc != 0:
        raise RuntimeError(f"bamio_encode_scan failed: rc={rc}")
    return out


def encode_fill(batch, scan: dict[str, np.ndarray],
                fam_start: np.ndarray, fam_nrec: np.ndarray,
                rows: np.ndarray, lo: np.ndarray,
                bases: np.ndarray, quals: np.ndarray) -> int:
    """Write one segment's placed reads into the [*, T, 2, W] batch
    tensors (bamio_encode_fill). Returns records written."""
    t_pad, _, w_pad = bases.shape[1:]
    got = lib().bamio_encode_fill(
        len(fam_start), _vp(fam_start), _vp(fam_nrec),
        _vp(rows), _vp(lo),
        _vp(batch.pos), _vp(batch.l_seq), _vp(batch.var_off),
        _vp(batch.left_clip), _vp(batch.right_clip),
        _vp(batch.seq), _vp(batch.qual),
        _vp(scan["ti"]), _vp(scan["role"]), _vp(scan["keep"]),
        t_pad, w_pad, _vp(bases), _vp(quals),
    )
    if got < 0:
        raise RuntimeError("bamio_encode_fill: read outside its family window "
                           "(scan/fill mismatch)")
    return int(got)


def duplex_scan(batch, fam_start: np.ndarray, fam_nrec: np.ndarray) -> dict[str, np.ndarray]:
    """The C duplex-encode scan (bamio_duplex_scan) over contiguous family
    runs of one ColumnarBatch; encode_duplex_families' first pass."""
    nf = len(fam_start)
    out = {
        "start": np.empty(nf, np.int64),
        "window": np.empty(nf, np.int64),
        "rowmask": np.empty(nf, np.uint8),
        "gsize": np.empty(nf, np.int32),
        "refid": np.empty(nf, np.int32),
        "rx_rec": np.empty(nf, np.int64),
        "nleft": np.empty(nf, np.int32),
        "row": np.empty(batch.n, np.int8),
    }
    rc = lib().bamio_duplex_scan(
        nf, _vp(fam_start), _vp(fam_nrec),
        _vp(batch.flag), _vp(batch.pos), _vp(batch.ref_id),
        _vp(batch.l_seq), _vp(batch.left_clip), _vp(batch.right_clip),
        _vp(batch.cigar_flags),
        _vp(batch.rx.view(np.uint8)), batch.rx.dtype.itemsize,
        _vp(out["start"]), _vp(out["window"]), _vp(out["rowmask"]),
        _vp(out["gsize"]), _vp(out["refid"]), _vp(out["rx_rec"]),
        _vp(out["nleft"]), _vp(out["row"]),
    )
    if rc != 0:
        raise RuntimeError(f"bamio_duplex_scan failed: rc={rc}")
    return out


def duplex_fill(batch, scan: dict[str, np.ndarray],
                fam_start: np.ndarray, fam_nrec: np.ndarray,
                rows: np.ndarray, starts: np.ndarray,
                bases: np.ndarray, quals: np.ndarray, cover: np.ndarray) -> int:
    """Write one segment's placed duplex reads into the [*, 4, W] batch
    tensors (bamio_duplex_fill). Returns records written."""
    got = lib().bamio_duplex_fill(
        len(fam_start), _vp(fam_start), _vp(fam_nrec),
        _vp(rows), _vp(starts),
        _vp(batch.pos), _vp(batch.l_seq), _vp(batch.var_off),
        _vp(batch.left_clip), _vp(batch.right_clip),
        _vp(batch.seq), _vp(batch.qual),
        _vp(scan["row"]), bases.shape[-1],
        _vp(bases), _vp(quals), _vp(cover),
    )
    if got < 0:
        raise RuntimeError("bamio_duplex_fill: read outside its family window "
                           "(scan/fill mismatch)")
    return int(got)


def merge_runs(readers: list[NativeBgzfReader], writer: NativeBgzfWriter) -> tuple[int, float]:
    """k-way merge of sorted spill runs (bamio_merge_runs) into an open
    writer whose header is already written. The readers stand just past
    their headers (_skip_header, unbuffered). Returns (records merged,
    seconds inside the writer's deflate/write calls). Order and ties:
    the raw coordinate key, then the run index — heapq.merge's order over
    the Python engine's runs."""
    L = lib()
    for i, r in enumerate(readers):
        if r._off != len(r._buf):
            raise GuardError(f"merge run {i}: reader holds Python-buffered bytes; "
                             "open it fresh and skip the header unbuffered")
    handles = (C.c_void_p * len(readers))(*[C.c_void_p(r._h) for r in readers])
    err = C.create_string_buffer(256)
    write_s = C.c_double(0.0)
    n = L.bamio_merge_runs(handles, len(readers), writer._h, int(writer._mt),
                           err, 256, C.byref(write_s))
    if n < 0:
        raise IOError(f"native merge failed: {err.value.decode()}")
    return int(n), write_s.value
