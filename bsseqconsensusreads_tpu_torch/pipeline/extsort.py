"""Writing a consensus batch stream, with the bounded-memory coordinate
sort for 'self' mode.

The port of write_batch_stream from the JAX package's pipeline/extsort.py
with its python sort engine: records stream in, sorted runs of at most
`buffer_records` spill to BGZF BAM shards on disk, and a k-way heap merge
streams them back out. Keys are read at fixed offsets of the encoded
records (no decode). Both sorts are stable and the merge breaks ties by
run order, so the output bytes equal the JAX package's. The native and
bucketed engines, spill CRCs and the background spill writer are later
slices of the port.
"""

from __future__ import annotations

import heapq
import os
import struct
import tempfile
from typing import Iterable, Iterator

from bsseqconsensusreads_tpu_torch.io.bam import (
    BamHeader,
    BamReader,
    BamWriter,
    RawRecords,
    encode_record,
    write_items,
)

#: Default spill threshold (records held in RAM per sorted run).
DEFAULT_BUFFER_RECORDS = 100_000

#: Max spill runs merged (and thus file descriptors held) at once; beyond
#: this, runs are pre-merged in groups (multi-pass merge).
MERGE_FANIN = 64


def raw_coordinate_key(blob: bytes) -> tuple:
    """Coordinate order read at the fixed offsets of an encoded record blob
    (block_size +0, then ref_id +4, pos +8, l_qname +12, flag +18, qname
    +36): unmapped last, then qname bytes and flag as tie-breaks."""
    ref_id, pos = struct.unpack_from("<ii", blob, 4)
    (flag,) = struct.unpack_from("<H", blob, 18)
    return (
        ref_id if ref_id >= 0 else 1 << 30,
        pos if pos >= 0 else 1 << 30,
        blob[36 : 36 + blob[12] - 1],
        flag,
    )


def iter_record_blobs(items: Iterable) -> Iterator[bytes]:
    """Normalize a mixed BamRecord / RawRecords / raw-blob stream to
    per-record encoded blobs."""
    for item in items:
        if isinstance(item, RawRecords):
            blob = item.blob
            off = 0
            n = len(blob)
            while off < n:
                (size,) = struct.unpack_from("<i", blob, off)
                yield blob[off : off + 4 + size]
                off += 4 + size
        elif isinstance(item, (bytes, memoryview)):
            yield item
        else:
            yield encode_record(item)


def external_sort_raw(
    blobs: Iterable[bytes],
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    key=raw_coordinate_key,
) -> Iterator[bytes]:
    """Yield encoded record blobs in `key` order with bounded host memory.
    If the input fits one buffer no file is ever written; spill shards are
    deleted as the merge finishes, even if the consumer abandons the
    iterator."""
    if buffer_records < 1:
        raise ValueError(f"buffer_records must be >= 1, got {buffer_records}")
    buf: list = []
    run_paths: list[str] = []
    tmpdir: tempfile.TemporaryDirectory | None = None

    def write_run(path: str, items) -> None:
        # spill shards are deleted after the merge: fast compression
        with BamWriter(path, header, level=1) as w:
            w.write_raw_many(items)

    def spill() -> None:
        nonlocal tmpdir, buf
        buf.sort(key=key)
        if tmpdir is None:
            tmpdir = tempfile.TemporaryDirectory(prefix="bsseq_extsort_", dir=workdir)
        path = os.path.join(tmpdir.name, f"run{len(run_paths):05d}.bam")
        run_paths.append(path)
        write_run(path, buf)
        buf = []

    def merged(paths: list[str], readers: list):
        for p in paths:
            r = BamReader(p)
            readers.append(r)
        return heapq.merge(*(r.raw_records() for r in readers), key=key)

    try:
        for item in blobs:
            buf.append(item)
            if len(buf) >= buffer_records:
                spill()
        if not run_paths:  # everything fit in one buffer: no disk round-trip
            buf.sort(key=key)
            yield from buf
            return
        if buf:
            spill()
        pass_index = 0
        while len(run_paths) > MERGE_FANIN:
            merged_paths: list[str] = []
            for gi in range(0, len(run_paths), MERGE_FANIN):
                group = run_paths[gi : gi + MERGE_FANIN]
                out = os.path.join(
                    tmpdir.name, f"pass{pass_index:02d}_{len(merged_paths):05d}.bam"
                )
                readers: list = []
                try:
                    write_run(out, merged(group, readers))
                finally:
                    for r in readers:
                        r.close()
                for p in group:
                    os.remove(p)
                merged_paths.append(out)
            run_paths = merged_paths
            pass_index += 1
        readers = []
        try:
            yield from merged(run_paths, readers)
        finally:
            for r in readers:
                r.close()
    finally:
        if tmpdir is not None:
            tmpdir.cleanup()


def write_batch_stream(
    batches: Iterable,
    out_path: str,
    header: BamHeader,
    mode: str,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    level: int = 6,
) -> None:
    """Write a consensus batch stream (lists of BamRecord / RawRecords) to
    a BAM: straight through in 'unaligned' mode, via the external
    coordinate sort in 'self' mode — never the whole output in RAM.
    `level` is the BGZF deflate level."""
    with BamWriter(out_path, header, level=level) as writer:
        if mode == "self":
            writer.write_raw_many(
                external_sort_raw(
                    iter_record_blobs(item for batch in batches for item in batch),
                    header, workdir=workdir, buffer_records=buffer_records,
                )
            )
        else:
            for batch in batches:
                write_items(writer, batch)
