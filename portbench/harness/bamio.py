"""The benchmark's own BAM/BGZF writer and reader (stdlib zlib + numpy).

The writer takes whole columns of equal-layout records (one fixed record
size per file) and builds every record at once in a [n, size] byte
matrix; the BGZF blocks deflate in a thread pool. The reader decodes the
records the comparison needs into plain dicts. Neither touches the
program under test.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: bases as BAM's 4-bit codes, indexed by the alphabet's codes A C G T N
NIBBLE_OF_CODE = np.array([1, 2, 4, 8, 15], np.uint8)
SEQ_CHARS = "=ACMGRSVTWYHKDBN"
CODE_CHARS = "ACGTN"

BGZF_BLOCK = 65280
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")

# flags
FPAIRED, FPROPER, FUNMAP, FMUNMAP = 0x1, 0x2, 0x4, 0x8
FREVERSE, FMREVERSE, FREAD1, FREAD2 = 0x10, 0x20, 0x40, 0x80


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """The SAM specification's bin of each [beg, end) interval, vectorised."""
    beg = np.maximum(np.asarray(beg, np.int64), 0)
    end = np.maximum(np.asarray(end, np.int64) - 1, 0)
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, ((1 << 15) - 1) // 7), (17, ((1 << 12) - 1) // 7),
                        (20, ((1 << 9) - 1) // 7), (23, ((1 << 6) - 1) // 7),
                        (26, ((1 << 3) - 1) // 7)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def header_bytes(text: str, refs) -> bytes:
    """The BAM header: magic, SAM text, and the (name, length) references."""
    t = text.encode()
    parts = [b"BAM\x01", struct.pack("<i", len(t)), t, struct.pack("<i", len(refs))]
    for name, length in refs:
        n = name.encode() + b"\x00"
        parts += [struct.pack("<i", len(n)), n, struct.pack("<i", length)]
    return b"".join(parts)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, "<i4")).view(np.uint8).reshape(-1, 4)


def _u16(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, "<u2")).view(np.uint8).reshape(-1, 2)


def build_records(*, names: np.ndarray, flag, ref_id, pos, mate_ref, mate_pos, tlen,
                  codes: np.ndarray, quals: np.ndarray, tags) -> np.ndarray:
    """[n, size] uint8: n mapped records of one read length, all M.

    names: uint8 [n, k] fixed-width read names (no NUL); codes / quals:
    [n, L] base codes (A C G T N = 0..4) and Phred bytes; tags: a list of
    (two-letter key, uint8 [n, m] fixed-width Z strings)."""
    n, length = codes.shape
    k = names.shape[1]
    z_len = sum(3 + t.shape[1] + 1 for _key, t in tags)
    core = 32 + (k + 1) + 4 + (length + 1) // 2 + length
    size = 4 + core + z_len
    rec = np.zeros((n, size), np.uint8)
    rec[:, 0:4] = _i32(np.full(n, size - 4))
    rec[:, 4:8] = _i32(ref_id)
    rec[:, 8:12] = _i32(pos)
    rec[:, 12] = k + 1
    rec[:, 13] = 60
    rec[:, 14:16] = _u16(reg2bin(pos, np.asarray(pos, np.int64) + length))
    rec[:, 16:18] = _u16(np.ones(n))
    rec[:, 18:20] = _u16(flag)
    rec[:, 20:24] = _i32(np.full(n, length))
    rec[:, 24:28] = _i32(mate_ref)
    rec[:, 28:32] = _i32(mate_pos)
    rec[:, 32:36] = _i32(tlen)
    o = 36
    rec[:, o:o + k] = names
    o += k + 1
    rec[:, o:o + 4] = _i32(np.full(n, length << 4))  # one M op
    o += 4
    nib = NIBBLE_OF_CODE[codes]
    if length % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    rec[:, o:o + nib.shape[1] // 2] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    o += nib.shape[1] // 2
    rec[:, o:o + length] = quals
    o += length
    for key, text in tags:
        rec[:, o:o + 2] = np.frombuffer(key.encode(), np.uint8)
        rec[:, o + 2] = ord("Z")
        rec[:, o + 3:o + 3 + text.shape[1]] = text
        o += 3 + text.shape[1] + 1
    return rec


def _deflate_block(data: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    return b"".join((
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00",
        struct.pack("<H", len(body) + 25), body,
        struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)),
    ))


def write_bgzf(path: str, payload: memoryview | bytes, level: int = 1, threads: int = 4) -> int:
    """payload as BGZF blocks of at most BGZF_BLOCK bytes, plus the EOF
    block; returns the bytes written."""
    view = memoryview(payload)
    chunks = [bytes(view[i:i + BGZF_BLOCK]) for i in range(0, len(view), BGZF_BLOCK)]
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        blocks = list(pool.map(lambda b: _deflate_block(b, level), chunks))
    with open(path, "wb") as fh:
        for b in blocks:
            fh.write(b)
        fh.write(BGZF_EOF)
    return sum(map(len, blocks)) + len(BGZF_EOF)


def write_bam(path: str, header: bytes, records: np.ndarray, level: int = 1,
              threads: int = 4) -> int:
    """A BAM of `header` and the [n, size] record matrix, in row order."""
    return write_bgzf(path, header + records.tobytes(), level, threads)


def inflate_bgzf(path: str) -> bytes:
    """The whole decompressed stream of a BGZF file."""
    with open(path, "rb") as fh:
        data = fh.read()
    out = []
    pos = 0
    while pos < len(data):
        d = zlib.decompressobj(31)
        out.append(d.decompress(data[pos:]))
        rest = d.unused_data
        pos = len(data) - len(rest)
        if not rest:
            break
    return b"".join(out)


def read_header(buf: bytes) -> tuple[int, list]:
    """(offset of the first record, [(name, length)]) of a BAM stream."""
    if buf[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    o = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, o)
    o += 4
    refs = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", buf, o)
        name = buf[o + 4:o + 4 + ln - 1].decode()
        (length,) = struct.unpack_from("<i", buf, o + 4 + ln)
        refs.append((name, length))
        o += 8 + ln
    return o, refs


def record_offsets(buf: bytes, start: int) -> list[int]:
    """Offsets of every record's block_size field."""
    offs = []
    o = start
    n = len(buf)
    unpack = struct.unpack_from
    while o < n:
        offs.append(o)
        o += 4 + unpack("<i", buf, o)[0]
    return offs


def record_name(buf: bytes, off: int) -> str:
    l_name = buf[off + 12]
    return buf[off + 36:off + 36 + l_name - 1].decode()


_ARRAY_TYPES = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}
_SCALAR = {"c": ("<b", 1), "C": ("<B", 1), "s": ("<h", 2), "S": ("<H", 2),
           "i": ("<i", 4), "I": ("<I", 4), "f": ("<f", 4)}


def decode_record(buf: bytes, off: int) -> dict:
    """One record as a dict: core fields, 'seq' (ACGTN string), 'qual'
    (bytes), 'cigar' [(op, len)], and 'tags' {key: value}; B arrays as
    numpy arrays, 'f' values as float32."""
    (size, ref_id, pos, l_name, mapq, _bin, n_cig, flag, l_seq, mref, mpos,
     tlen) = struct.unpack_from("<iiiBBHHHiiii", buf, off)
    end = off + 4 + size
    o = off + 36
    name = buf[o:o + l_name - 1].decode()
    o += l_name
    cig = struct.unpack_from(f"<{n_cig}I", buf, o)
    o += 4 * n_cig
    packed = np.frombuffer(buf, np.uint8, (l_seq + 1) // 2, o)
    o += (l_seq + 1) // 2
    nib = np.empty(packed.size * 2, np.uint8)
    nib[0::2] = packed >> 4
    nib[1::2] = packed & 15
    seq = "".join(SEQ_CHARS[v] for v in nib[:l_seq])
    qual = bytes(buf[o:o + l_seq])
    o += l_seq
    tags = {}
    while o < end:
        key = buf[o:o + 2].decode()
        t = chr(buf[o + 2])
        o += 3
        if t == "Z":
            z = buf.index(b"\x00", o)
            tags[key] = buf[o:z].decode()
            o = z + 1
        elif t == "A":
            tags[key] = chr(buf[o])
            o += 1
        elif t == "B":
            sub = chr(buf[o])
            (cnt,) = struct.unpack_from("<i", buf, o + 1)
            dt = np.dtype("<" + _ARRAY_TYPES[sub])
            tags[key] = np.frombuffer(buf, dt, cnt, o + 5).copy()
            o += 5 + cnt * dt.itemsize
        else:
            fmt, w = _SCALAR[t]
            (v,) = struct.unpack_from(fmt, buf, o)
            tags[key] = np.float32(v) if t == "f" else int(v)
            o += w
    return {"qname": name, "flag": flag, "ref_id": ref_id, "pos": pos, "mapq": mapq,
            "cigar": [(c & 15, c >> 4) for c in cig], "next_ref_id": mref,
            "next_pos": mpos, "tlen": tlen, "seq": seq, "qual": qual, "tags": tags}
