"""ctypes bindings for the port's native host sweeps (csrc/host/wirepack.cpp).

The port of the JAX package's io/wirepack.py: the batch record emit, the
in-RAM raw-record sort of one spill run, the molecular cB histogram, the
duplex rawize and strand-call sweeps, the wire transport's duplex
and packed-rows input packs, and the methylation tally merge. Each is
byte-identical to the numpy twin that stays beside it (pipeline.calling,
ops.hosttwin, models.molecular, ops.wire, methyl.tally). The library
builds at first use (io._nativelib); a failed build or load raises
NativeLibraryError.

The b0 output unpack, the one-pass duplex retire and the bucket split of
the same source are not bound: the port's wire returns the full output
planes, and the bucket engine comes with a later slice.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from bsseqconsensusreads_tpu_torch.io import _nativelib

REQUIRED_SYMBOLS = (
    "wirepack_duplex_rawize",
    "wirepack_emit_consensus_records_v4",
    "wirepack_sort_raw_records",
    "wirepack_strand_calls",
    "wirepack_bcount_sparse",
    "wirepack_pack_duplex",
    "wirepack_pack_rows",
    "wirepack_methyl_tally_merge",
)

# Error codes from csrc/host/wirepack.cpp.
_ERR_TOO_MANY_LEVELS = -2
_ERR_QUAL_TOO_HIGH = -3
_ERR_QNAME_TOO_LONG = -5

_LIB = None


def lib() -> C.CDLL:
    """The record-path library with its C signatures declared; builds it
    at first use and raises NativeLibraryError when it cannot."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = _nativelib.load("wirepack", REQUIRED_SYMBOLS)
    vp = C.c_void_p
    lib.wirepack_duplex_rawize.restype = None
    lib.wirepack_duplex_rawize.argtypes = [C.c_int64, C.c_int64] + [vp] * 16
    lib.wirepack_emit_consensus_records_v4.restype = C.c_int
    lib.wirepack_emit_consensus_records_v4.argtypes = (
        # planes: base..b_depth, a/b_ss_err, ss_valid, bcount, a/b_call
        [vp] * 12
        + [C.c_int64, C.c_int64]
        + [vp] * 10
        + [C.c_int, C.c_int, vp, C.c_int64]
        + [vp] * 3
    )
    lib.wirepack_sort_raw_records.restype = C.c_int64
    lib.wirepack_sort_raw_records.argtypes = [
        vp, C.c_int64, vp, C.POINTER(C.c_double), C.POINTER(C.c_double),
    ]
    lib.wirepack_strand_calls.restype = None
    lib.wirepack_strand_calls.argtypes = [vp] * 5 + [C.c_int64, C.c_int64, vp]
    lib.wirepack_bcount_sparse.restype = None
    lib.wirepack_bcount_sparse.argtypes = [
        vp, vp, C.c_int64, C.c_int64, C.c_int64, vp, C.c_int, C.c_int, vp,
    ]
    lib.wirepack_pack_duplex.restype = C.c_int
    lib.wirepack_pack_duplex.argtypes = (
        [vp] * 5 + [C.c_int64, C.c_int64, C.c_int64, C.c_int] + [vp] * 5
    )
    lib.wirepack_pack_rows.restype = C.c_int
    lib.wirepack_pack_rows.argtypes = [vp, vp, C.c_int64, C.c_int64, C.c_int] + [vp] * 4
    lib.wirepack_methyl_tally_merge.restype = C.c_int64
    lib.wirepack_methyl_tally_merge.argtypes = [vp] * 4 + [C.c_int64] + [vp] * 4
    _LIB = lib
    return lib


def _p(a) -> C.c_void_p | None:
    return None if a is None else a.ctypes.data_as(C.c_void_p)


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def duplex_rawize(out: dict, row_pos, row_off, row_len, aux, window_start,
                  role_rows) -> dict:
    """Raw-unit conversion of duplex presence planes (the C twin of the
    numpy loop in pipeline.calling._duplex_rawize).

    out: the unpacked duplex output dict; row_* int64/int64/int32 [f*4];
    aux u16 flat cd/ce buffer; window_start int64 [f]; role_rows int32
    [4]. Returns a new dict with int16 raw planes."""
    L = lib()
    a_p = _c(out["a_depth"], np.int8)
    b_p = _c(out["b_depth"], np.int8)
    a_e = _c(out["a_err"], np.int8)
    b_e = _c(out["b_err"], np.int8)
    f, _, w = a_p.shape
    # pre-filled with presence units: the C pass overwrites sidecar rows
    ad, bd = a_p.astype(np.int16), b_p.astype(np.int16)
    ae, be = a_e.astype(np.int16), b_e.astype(np.int16)
    depth = np.empty((f, 2, w), np.int16)
    errors = np.empty((f, 2, w), np.int16)
    row_pos = _c(row_pos, np.int64)
    row_off = _c(row_off, np.int64)
    row_len = _c(row_len, np.int32)
    aux = _c(aux, np.uint16)
    window_start = _c(window_start, np.int64)
    role_rows = _c(role_rows, np.int32)
    L.wirepack_duplex_rawize(
        f, w, _p(a_p), _p(b_p), _p(a_e), _p(b_e),
        _p(row_pos), _p(row_off), _p(row_len), _p(aux), _p(window_start),
        _p(role_rows),
        _p(ad), _p(bd), _p(ae), _p(be), _p(depth), _p(errors),
    )
    new = dict(out)
    new["a_depth"], new["b_depth"] = ad, bd
    new["a_err"], new["b_err"] = ae, be
    new["depth"], new["errors"] = depth, errors
    return new


def _string_blob(strings: list[str]):
    """(blob u8, offsets i32, lengths i32) for a list of ascii strings."""
    lens = np.fromiter((len(s) for s in strings), dtype=np.int32, count=len(strings))
    offs = np.zeros(len(strings), dtype=np.int32)
    if len(strings) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    if strings:
        blob = np.frombuffer("".join(strings).encode("ascii"), dtype=np.uint8).copy()
    else:
        blob = np.zeros(0, np.uint8)
    return blob, offs, lens


def emit_consensus_records(
    out: dict,
    *,
    ref_id,
    window_start,
    n_reads,
    role_reverse,
    mi: list[str],
    rx: list[str],
    min_reads: int,
    mode_self: bool,
    duplex: bool,
    bcount=None,
    strand_calls=None,
    strand_err=None,
) -> tuple[bytes, int, int]:
    """Batch emit: output planes -> BAM record bytes, byte-identical to the
    Python emitters + io.bam.encode_record.

    out: dict of [f, 2, w] planes (base int8, qual uint8, depth/errors
    int16, plus a_depth/b_depth when duplex). rx entries may be "" (no RX
    tag). bcount (uint16 [f, 2, 4, w]) adds the molecular cB tag;
    strand_calls ((a_call, b_call) int8 [f, 2, w]) adds the duplex ac/bc
    tags; strand_err ((a_ss_err, b_ss_err int16 [f, 2, w], ss_valid bool
    [f, 2])) adds aE/bE and ae/be where ss_valid is set. Returns (record
    bytes, n_records, n_families_skipped)."""
    L = lib()
    base = _c(out["base"], np.int8)
    qual = _c(out["qual"], np.uint8)
    depth = _c(out["depth"], np.int16)
    errors = _c(out["errors"], np.int16)
    f, _, w = base.shape
    a_depth = _c(out["a_depth"], np.int16) if duplex else None
    b_depth = _c(out["b_depth"], np.int16) if duplex else None
    bcount = None if bcount is None else _c(bcount, np.uint16)
    a_call = b_call = a_se = b_se = ss_valid = None
    if strand_calls is not None:
        a_call, b_call = _c(strand_calls[0], np.int8), _c(strand_calls[1], np.int8)
    if strand_err is not None:
        a_se, b_se = _c(strand_err[0], np.int16), _c(strand_err[1], np.int16)
        ss_valid = _c(strand_err[2], np.uint8)
    ref_id = _c(ref_id, np.int32)
    window_start = _c(window_start, np.int64)
    n_reads = _c(n_reads, np.int32)
    role_reverse = _c(role_reverse, np.uint8)
    mi_blob, mi_off, mi_len = _string_blob(mi)
    rx_blob, rx_off, rx_len = _string_blob(rx)
    mi_max = int(mi_len.max()) if len(mi) else 0
    rx_max = int(rx_len.max()) if len(rx) else 0
    per_col = (
        10
        + 4 * duplex
        + (8 if bcount is not None else 0)
        + (2 if strand_calls is not None else 0)
        + (4 if strand_err is not None else 0)
    )
    cap = int(f) * 2 * (per_col * int(w) + 2 * mi_max + rx_max + 220)
    buf = np.empty(max(cap, 4096), dtype=np.uint8)
    out_len = C.c_int64(0)
    n_records = C.c_int64(0)
    n_skipped = C.c_int64(0)
    rc = L.wirepack_emit_consensus_records_v4(
        _p(base), _p(qual), _p(depth), _p(errors),
        _p(a_depth), _p(b_depth), _p(a_se), _p(b_se), _p(ss_valid),
        _p(bcount), _p(a_call), _p(b_call),
        f, w,
        _p(ref_id), _p(window_start), _p(n_reads), _p(role_reverse),
        _p(mi_blob), _p(mi_off), _p(mi_len),
        _p(rx_blob), _p(rx_off), _p(rx_len),
        int(min_reads), int(bool(mode_self)),
        _p(buf), buf.size,
        C.byref(out_len), C.byref(n_records), C.byref(n_skipped),
    )
    if rc == _ERR_QNAME_TOO_LONG:
        raise ValueError("an MI qname exceeds BAM's 254-char l_read_name limit")
    if rc != 0:
        raise ValueError(f"native record emit overflowed its {buf.size}-byte buffer")
    # tobytes() trims the used span out of the oversized scratch buffer
    return buf[: out_len.value].tobytes(), n_records.value, n_skipped.value


def sort_raw_records(blob) -> tuple[bytes, int, float, float]:
    """In-RAM sort of one spill run of encoded records (each with its
    4-byte block_size prefix). Returns (sorted bytes, n_records,
    key_extract_seconds, sort_gather_seconds). The order is
    pipeline.extsort.raw_coordinate_key under a stable sort — the Python
    engine's `buf.sort(key=raw_coordinate_key)`."""
    L = lib()
    src = np.frombuffer(blob, dtype=np.uint8)
    out = np.empty(src.size, dtype=np.uint8)
    key_s = C.c_double(0.0)
    sort_s = C.c_double(0.0)
    n = L.wirepack_sort_raw_records(_p(src), src.size, _p(out),
                                    C.byref(key_s), C.byref(sort_s))
    if n < 0:
        raise ValueError(f"native raw-record sort found a malformed record frame (rc={n})")
    return out.tobytes(), int(n), key_s.value, sort_s.value


def bcount_sparse(bases, quals, cons, params) -> np.ndarray:
    """One-pass sparse cB dissent histogram of one molecular batch: overlap
    co-call + observation filter + per-base tally + call-plane
    sparsification (the numpy chain models.molecular.molecular_base_counts
    -> sparsify_base_counts, integer-exact). bases int8 [f, t, 2, w],
    quals uint8, cons int8 [f, 2, w] -> uint16 [f, 2, 4, w]."""
    L = lib()
    bases = _c(bases, np.int8)
    quals = _c(quals, np.uint8)
    cons = _c(cons, np.int8)
    f, t, _, w = bases.shape
    out = np.empty((f, 2, 4, w), np.uint16)
    L.wirepack_bcount_sparse(
        _p(bases), _p(quals), f, t, w, _p(cons),
        int(params.min_input_base_quality),
        int(bool(params.consensus_call_overlapping_bases)),
        _p(out),
    )
    return out


def strand_calls(bases, cover, ref, convert_mask, eligible) -> np.ndarray:
    """The C twin of ops.hosttwin.strand_call_planes (calls plane only).

    bases int8 [f, 4, w], cover bool [f, 4, w], ref int8 [f, w+1],
    convert_mask bool [f, 4], eligible bool [f] -> int8 [f, 4, w]
    post-transform per-strand calls, NBASE where the transformed row has
    no coverage."""
    L = lib()
    bases = _c(bases, np.int8)
    cover = _c(cover, np.uint8)
    ref = _c(ref, np.int8)
    cmask = _c(convert_mask, np.uint8)
    elig = _c(eligible, np.uint8)
    f, r, w = bases.shape
    if r != 4 or ref.shape != (f, w + 1):
        raise ValueError(f"strand_calls wants [f, 4, w] bases and [f, w+1] ref; "
                         f"got {bases.shape} / {ref.shape}")
    out = np.empty((f, 4, w), np.int8)
    L.wirepack_strand_calls(_p(bases), _p(cover), _p(ref), _p(cmask), _p(elig), f, w, _p(out))
    return out


_MODE_BITS = {"q8": 8, "q4": 4, "q2": 2, "auto": 0}
_BITS_MODE = {8: "q8", 4: "q4", 2: "q2"}


def _pack_error(bits: int, nlevels: int, qual_mode: str) -> None:
    """The numpy packers' ValueErrors for the C pack's error codes."""
    if bits == _ERR_QUAL_TOO_HIGH:
        raise ValueError(
            "covered qual > 93 (BAM printable max) cannot ride a "
            f"{qual_mode} codebook; use qual_mode='q8' or 'auto'"
        )
    if bits == _ERR_TOO_MANY_LEVELS:
        raise ValueError(
            f"{nlevels} distinct covered quals exceed {qual_mode}'s "
            f"{1 << _MODE_BITS[qual_mode]}-entry codebook; use qual_mode='auto'"
        )
    if bits < 0:
        raise ValueError(f"native wirepack error {bits}")


def pack_duplex(bases, quals, cover, convert_mask, eligible, qual_mode):
    """C pack of a duplex batch -> (nib, qual, meta u32 arrays, resolved
    mode): the sections of ops.wire.pack_duplex_inputs, byte-identical,
    with its ValueErrors for codebook overflow and out-of-range quals."""
    L = lib()
    f, r, w = bases.shape
    cells = f * r * w
    if cells % 2:
        # the C nibble loop reads bases[i+1]: an odd count reads past the end
        raise ValueError(f"duplex wire pack needs an even f*r*w, got {cells}")
    bases = _c(bases, np.int8)
    quals = _c(quals, np.uint8)
    cover = _c(cover, np.uint8)
    cmask = _c(convert_mask, np.uint8)
    elig = _c(eligible, np.uint8)
    nib = np.empty((cells // 2 + 3) // 4 * 4, dtype=np.uint8)
    meta = np.empty((f + 3) // 4 * 4, dtype=np.uint8)
    qual = np.empty(cells + 24, dtype=np.uint8)
    qual_len = C.c_int64(0)
    nlevels = C.c_int(0)
    bits = L.wirepack_pack_duplex(
        _p(bases), _p(quals), _p(cover), _p(cmask), _p(elig), f, r, w,
        _MODE_BITS[qual_mode], _p(nib), _p(meta), _p(qual),
        C.byref(qual_len), C.byref(nlevels),
    )
    _pack_error(bits, nlevels.value, qual_mode)
    # zero the nib/meta word padding the C side never touches
    nib[cells // 2:] = 0
    meta[f:] = 0
    return (nib.view(np.uint32), qual[: qual_len.value].view(np.uint32).copy(),
            meta.view(np.uint32), _BITS_MODE[bits])


def pack_rows(bases, quals, qual_mode):
    """C pack of segment-packed rows -> (nib, qual u32 arrays, resolved
    mode): bases int8 [n, 2, w], quals uint8 [n, 2, w]; cover derives
    from the bases in the sweep — the packed wire v2 body, byte-identical
    to ops.wire's numpy pack of the same rows."""
    L = lib()
    n, _, w = bases.shape
    cells = n * 2 * w
    bases = _c(bases, np.int8)
    quals = _c(quals, np.uint8)
    nib = np.empty((cells // 2 + 3) // 4 * 4, dtype=np.uint8)
    qual = np.empty(cells + 24, dtype=np.uint8)
    qual_len = C.c_int64(0)
    nlevels = C.c_int(0)
    bits = L.wirepack_pack_rows(
        _p(bases), _p(quals), n, w, _MODE_BITS[qual_mode], _p(nib), _p(qual),
        C.byref(qual_len), C.byref(nlevels),
    )
    _pack_error(bits, nlevels.value, qual_mode)
    nib[cells // 2:] = 0
    return nib.view(np.uint32), qual[: qual_len.value].view(np.uint32).copy(), _BITS_MODE[bits]



def methyl_tally_merge(sites, ctx, meth, unmeth):
    """The C merge of methylation site tallies: sorted unique sites with
    summed counts (methyl.tally.merge_tallies holds the numpy twin)."""
    L = lib()
    sites = _c(sites, np.int64)
    ctx = _c(ctx, np.uint8)
    meth = _c(meth, np.uint32)
    unmeth = _c(unmeth, np.uint32)
    n = sites.size
    out = (np.empty(n, np.int64), np.empty(n, np.uint8),
           np.empty(n, np.uint32), np.empty(n, np.uint32))
    m = L.wirepack_methyl_tally_merge(
        _p(sites), _p(ctx), _p(meth), _p(unmeth), n, *(_p(a) for a in out)
    )
    return tuple(a[:m].copy() for a in out)
