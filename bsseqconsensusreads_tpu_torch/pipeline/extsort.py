"""Writing a consensus batch stream, with the bounded-memory coordinate
sort for 'self' mode.

The port of write_batch_stream and the raw coordinate sort from the JAX
package's pipeline/extsort.py. Records stream in, sorted runs of at most
`buffer_records` spill to BGZF BAM shards on disk (level 1), and a k-way
merge streams them back out into the output writer. Two engines, the
same bytes:

* 'native' — runs accumulate as one byte buffer (RawRecords blocks append
  whole), each run sorts in C (io.wirepack.sort_raw_records), and the
  k-way merge and its BGZF compression run in C through the output
  writer's codec (io.native.merge_runs). No per-record Python between
  the producer's batches and the bytes on disk.
* 'python' — per-record blobs sorted by raw_coordinate_key and merged by
  heapq.merge: the parity twin.

Keys are read at fixed offsets of the encoded records. Both in-run sorts
are stable and both merges break ties by run order, so the output equals
the JAX package's. external_sort runs the same spill/merge machinery over
BamRecord objects under a pipeline.record_ops key (the zipper's and
sam-to-fastq's name and coordinate sorts, and sorted_write, the `sort`
subcommand's); raw_name_key is name_key over blobs (UMI grouping's and
the consensus filter's name sorts).

Faults and threads, as in the JAX package: every spill run and merged
run carries a CRC32 verified before its merge opens it
(BSSEQ_TPU_VERIFY_SPILLS, default on); a run write fires the
`extsort_spill` failpoint and runs under the bounded retrier, a merge
fires `extsort_merge`; and with BSSEQ_TPU_HOST_WORKERS >= 1 a
double-buffered background thread writes run N while run N+1
accumulates (at most one write in flight; run order, and so the output,
is fixed on the caller's thread). resolve_sort_engine also resolves
'bucket', the third engine (pipeline.bucketemit): records route to
coordinate-range buckets as they arrive and the output is the buckets'
concatenation, with no merge tail.
"""

from __future__ import annotations

import contextlib
import heapq
import os
import struct
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.faults import retry as _faultretry
from bsseqconsensusreads_tpu_torch.utils import observe

from bsseqconsensusreads_tpu_torch.io.bam import (
    FREAD2,
    attach_codec_metrics,
    BamHeader,
    BamReader,
    BamRecord,
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


def raw_name_key(blob: bytes) -> tuple:
    """record_ops.name_key read at the fixed offsets of an encoded record
    blob (l_qname +12, flag +18, qname +36; ASCII qnames byte-compare in
    str order)."""
    (flag,) = struct.unpack_from("<H", blob, 18)
    return (blob[36 : 36 + blob[12] - 1], bool(flag & FREAD2), flag)


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


def _timer(metrics, name: str = "sort_write"):
    return metrics.timed(name) if metrics is not None else contextlib.nullcontext()


def _verify_spills() -> bool:
    """Whether spill runs carry a CRC32 verified before every merge open
    (BSSEQ_TPU_VERIFY_SPILLS, default on): a run corrupted between spill
    and merge is a hard IntegrityError, never merged garbage."""
    return os.environ.get("BSSEQ_TPU_VERIFY_SPILLS", "1") != "0"


class _Spiller:
    """The run writes of one external sort. Each write fires the
    `extsort_spill` failpoint and runs under the bounded retrier (a
    failed attempt rewrites the same path whole: the sorted run is still
    in memory), then records the run's CRC. With host workers
    (parallel.hostpool.host_workers() >= 1) the write runs on one
    background thread, double-buffered: the next spill first joins the
    previous write. `write_file(path, payload)` writes one run."""

    def __init__(self, write_file, metrics=None):
        from bsseqconsensusreads_tpu_torch.parallel import hostpool

        self._write_file = write_file
        self._metrics = metrics
        self.crcs: dict[str, int] = {}
        self._verify = _verify_spills()
        self._use_bg = hostpool.host_workers() >= 1
        self._pool = None
        self._pending = None

    def _write(self, path: str, payload, n: int, run_index: int, t0: float) -> None:
        def attempt() -> None:
            _failpoints.fire("extsort_spill", run=run_index)
            self._write_file(path, payload)

        with _timer(self._metrics, "spill_write"):
            _faultretry.guarded(attempt, metrics=self._metrics, stage="extsort_spill",
                                batch=run_index)
        self.record(path)
        if self._metrics is not None:
            self._metrics.count("spill_runs")
            self._metrics.count("spill_records", n)
        observe.emit("spill", {"run": run_index, "records": n,
                               "seconds": round(time.monotonic() - t0, 3)})

    def spill(self, path: str, payload, n: int, run_index: int, t0: float) -> None:
        """Write one run; `t0` is when its spill began (the sort included),
        the start of the 'spill' ledger line's seconds."""
        if not self._use_bg:
            self._write(path, payload, n, run_index, t0)
            return
        self.drain()  # double buffer: write N-1 lands before N detaches
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="bsseq-spill")
        self._pending = self._pool.submit(self._write, path, payload, n, run_index, t0)

    def drain(self) -> None:
        """Join the in-flight write: its CRC must be recorded before any
        merge opens the run, and its error must surface here."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def record(self, path: str) -> None:
        if self._verify:
            self.crcs[path] = _integrity.file_crc32(path)

    def check(self, path: str) -> None:
        """A corrupt run fails here, before one record of it merges."""
        want = self.crcs.pop(path, None)
        if want is not None:
            _integrity.verify_file_crc32(path, want, what=f"spill run {path}")

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            # graftlint: disable=thread-unsafe-mutation -- closed by the caller thread
            # after the pool joined
            self._pool = None


def _external_sort_core(
    items: Iterable,
    key,
    header: BamHeader,
    workdir: str | None,
    buffer_records: int,
    write_items_fn,
    read_run,
    metrics=None,
) -> Iterator:
    """The spill/merge machinery behind external_sort (BamRecord objects)
    and external_sort_raw (encoded blobs): runs of `buffer_records` are
    sorted in RAM (stable) and spilled as level-1 BGZF BAM shards under
    `workdir` (a private temp dir when None) by a _Spiller; merges hold
    one item per run and break ties by run order, collapsing runs in
    MERGE_FANIN groups first. If the input fits one buffer no file is
    ever written; shards are deleted as the merge finishes, even if the
    consumer abandons the iterator. write_items_fn(writer, items) appends
    a run's items; read_run(reader) yields them back in order. metrics:
    the in-stream sorts, and everything after the input ends (the final
    sort or merge and the consumer's work), accrue under 'sort_write';
    the run writes under 'spill_write'."""
    if buffer_records < 1:
        raise ValueError(f"buffer_records must be >= 1, got {buffer_records}")
    buf: list = []
    run_paths: list[str] = []
    tmpdir: tempfile.TemporaryDirectory | None = None

    def write_run(path: str, run_items) -> None:
        # spill shards are deleted after the merge: fast compression
        with BamWriter(path, header, level=1) as w:
            write_items_fn(w, run_items)

    spiller = _Spiller(write_run, metrics)

    def spill() -> None:
        nonlocal tmpdir, buf
        t0 = time.monotonic()
        with _timer(metrics):
            buf.sort(key=key)
            if tmpdir is None:
                tmpdir = tempfile.TemporaryDirectory(prefix="bsseq_extsort_", dir=workdir)
            run_index = len(run_paths)
            path = os.path.join(tmpdir.name, f"run{run_index:05d}.bam")
            run_paths.append(path)
            run_items, buf = buf, []
        spiller.spill(path, run_items, len(run_items), run_index, t0)

    def merged(paths: list[str], readers: list):
        for p in paths:
            spiller.check(p)
            readers.append(BamReader(p, threads=1))
        return heapq.merge(*(read_run(r) for r in readers), key=key)

    try:
        try:
            for item in items:
                buf.append(item)
                if len(buf) >= buffer_records:
                    spill()
            if run_paths and buf:
                spill()
            spiller.drain()  # every run durable + CRC'd before a merge opens it
        finally:
            spiller.close()
        with _timer(metrics):
            if not run_paths:  # everything fit in one buffer: no disk round-trip
                buf.sort(key=key)
                yield from buf
                return
            pass_index = 0
            while len(run_paths) > MERGE_FANIN:
                _failpoints.fire("extsort_merge", runs=len(run_paths))
                observe.emit("merge_pass", {"pass": pass_index, "runs": len(run_paths)})
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
                    spiller.record(out)  # merged runs are durable state too
                    merged_paths.append(out)
                run_paths = merged_paths
                pass_index += 1
            _failpoints.fire("extsort_merge", runs=len(run_paths))
            readers = []
            try:
                yield from merged(run_paths, readers)
            finally:
                for r in readers:
                    r.close()
    finally:
        if tmpdir is not None:
            tmpdir.cleanup()


def external_sort_raw(
    blobs: Iterable[bytes],
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    key=raw_coordinate_key,
    metrics=None,
) -> Iterator[bytes]:
    """Yield encoded record blobs in `key` order with bounded host memory
    (the Python engine of the raw coordinate sort)."""
    return _external_sort_core(
        blobs, key, header, workdir, buffer_records,
        write_items_fn=lambda w, run: w.write_raw_many(run),
        read_run=lambda r: r.raw_records(),
        metrics=metrics,
    )


def external_sort(
    records: Iterable[BamRecord],
    key,
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
) -> Iterator[BamRecord]:
    """Yield BamRecord objects in `key` order (a pipeline.record_ops sort
    key) with bounded host memory — the sorts behind the zipper and
    sam-to-fastq."""
    return _external_sort_core(
        records, key, header, workdir, buffer_records,
        write_items_fn=lambda w, run: w.write_all(run),
        read_run=iter,
    )


def sorted_write(
    records: Iterable[BamRecord],
    key,
    out_path: str,
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    level: int = 6,
) -> int:
    """external_sort + streaming write to `out_path` at BGZF deflate
    `level`; returns the record count (the `sort` subcommand and the
    self-mode consensus filter)."""
    n = 0
    with BamWriter(out_path, header, level=level) as w:
        for rec in external_sort(
            records, key, header, workdir=workdir, buffer_records=buffer_records
        ):
            w.write(rec)
            n += 1
    return n


def resolve_sort_engine(engine: str = "auto") -> str:
    """The raw coordinate sort's engine: 'auto' and 'native' take the C
    engine (both host libraries are loaded here, so a broken build fails
    before any record is sorted), 'python' the heapq twin, 'bucket' the
    bucketed engine (pipeline.bucketemit: records route to coordinate
    buckets as they arrive, each bucket sorts on its own, the output is
    their concatenation; its in-bucket sorts are the C sort). The JAX
    package's BSSEQ_TPU_SORT_ENGINE overrides the passed value, and
    'auto' never resolves to 'bucket' there either. Every engine writes
    the same bytes."""
    engine = os.environ.get("BSSEQ_TPU_SORT_ENGINE", engine)
    if engine not in ("auto", "native", "python", "bucket"):
        raise ValueError(f"unknown sort engine {engine!r}; use auto|native|python|bucket")
    if engine == "python":
        return "python"
    from bsseqconsensusreads_tpu_torch.io import native, wirepack

    native.lib()
    wirepack.lib()
    return "bucket" if engine == "bucket" else "native"


def _append_item(buf: bytearray, item) -> int:
    """Append one stream item's encoded bytes to a run buffer; returns the
    record count appended. RawRecords blocks append whole, so a run may
    end mid-block: runs stay contiguous chunks of the input stream, and
    the stable in-run sort with the run-ordered merge tie-break still
    reproduces the Python engine's bytes."""
    if isinstance(item, RawRecords):
        buf += item.blob
        return item.count
    if isinstance(item, (bytes, memoryview)):
        buf += item
        return 1
    buf += encode_record(item)
    return 1


def external_sort_raw_to_writer(
    items: Iterable,
    writer: BamWriter,
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    metrics=None,
    engine: str = "auto",
    sort_buckets: int = 0,
) -> int:
    """Coordinate-sort a mixed item stream (RawRecords blocks / encoded
    blobs / BamRecords) into an open BamWriter whose header is already
    written; returns the records written. The bytes are the same under
    every engine (`sort_buckets` sizes the bucket engine's plan)."""
    resolved = resolve_sort_engine(engine)
    if resolved == "bucket":
        from bsseqconsensusreads_tpu_torch.pipeline import bucketemit

        return bucketemit.bucket_sort_to_writer(
            items, writer, header, workdir=workdir, buffer_records=buffer_records,
            metrics=metrics, buckets=sort_buckets,
        )
    if resolved == "python":
        return writer.write_raw_many(
            external_sort_raw(
                iter_record_blobs(items), header, workdir=workdir,
                buffer_records=buffer_records, metrics=metrics,
            )
        )
    return _native_sort_to_writer(items, writer, header, workdir, buffer_records, metrics)


def _native_sort_to_writer(items: Iterable, writer: BamWriter, header: BamHeader,
                           workdir: str | None, buffer_records: int, metrics=None) -> int:
    """The native raw external sort: accumulate ~buffer_records records
    per run, sort each in C and spill it, pre-merge in MERGE_FANIN groups,
    then one C merge into `writer`. The seconds land under 'sort_write',
    with its parts as 'sort_write.key_extract', 'sort_write.order',
    'sort_write.merge' and 'sort_write.merge_bgzf'. The run buffer, and
    a sorted run until it is written, are the host memory account's
    'sort_buffer'; with `metrics`, a memory sample is taken when the
    stream ends ('sort') and after the final write ('sort_end')."""
    from bsseqconsensusreads_tpu_torch.io import wirepack
    from bsseqconsensusreads_tpu_torch.io.native import (
        NativeBgzfReader,
        NativeBgzfWriter,
        _skip_header,
        merge_runs,
    )

    if buffer_records < 1:
        raise ValueError(f"buffer_records must be >= 1, got {buffer_records}")
    if not isinstance(writer._bgzf, NativeBgzfWriter):
        # fail before any spill work: the C merge writes through the
        # output writer's native codec
        raise OSError("native sort needs a native-codec output writer (BamWriter engine 'auto'/'native')")

    def sub(name: str, dt: float) -> None:
        if metrics is not None:
            metrics.add_seconds(name, dt)

    def sort_buf(data: bytearray) -> tuple[bytes, int]:
        out, n, key_s, order_s = wirepack.sort_raw_records(data)
        sub("sort_write.key_extract", key_s)
        sub("sort_write.order", order_s)
        return out, n

    def merge_into(paths: list[str], out_writer: NativeBgzfWriter) -> int:
        readers: list = []
        t0 = time.monotonic()
        try:
            for p in paths:
                r = NativeBgzfReader(p, threads=1)
                readers.append(r)
                _skip_header(r, p)
            n, write_s = merge_runs(readers, out_writer)
        finally:
            for r in readers:
                r.close()
        sub("sort_write.merge", time.monotonic() - t0)
        sub("sort_write.merge_bgzf", write_s)
        return n

    def write_file(path: str, payload: bytes) -> None:
        with BamWriter(path, header, level=1, engine="native") as w:
            w.write_raw(payload)

    spiller = _Spiller(write_file, metrics)

    def merge_checked(paths: list[str], out_writer: NativeBgzfWriter) -> int:
        for p in paths:
            spiller.check(p)
        return merge_into(paths, out_writer)

    buf = bytearray()
    buf_n = 0
    run_paths: list[str] = []
    tmpdir: tempfile.TemporaryDirectory | None = None
    held = observe.MemGauge("sort_buffer")

    def sample(where: str) -> None:
        if metrics is not None:
            observe.mem_sample(metrics, where)

    def spill() -> None:
        nonlocal tmpdir, buf, buf_n
        t0 = time.monotonic()
        with _timer(metrics):
            data, n = sort_buf(buf)
            buf, buf_n = bytearray(), 0
            held.set(len(data))
            if tmpdir is None:
                tmpdir = tempfile.TemporaryDirectory(prefix="bsseq_extsort_", dir=workdir)
            run_index = len(run_paths)
            path = os.path.join(tmpdir.name, f"run{run_index:05d}.bam")
            run_paths.append(path)
        spiller.spill(path, data, n, run_index, t0)

    try:
        try:
            for item in items:
                buf_n += _append_item(buf, item)
                held.set(len(buf))
                if buf_n >= buffer_records:
                    spill()
            if run_paths and buf_n:
                spill()
            spiller.drain()  # every run durable + CRC'd before a merge opens it
            held.set(len(buf))
        finally:
            spiller.close()
        sample("sort")
        with _timer(metrics):
            if not run_paths:  # fits one buffer: straight to the writer
                data, total = sort_buf(buf)
                held.set(len(buf) + len(data))
                if data:
                    writer.write_raw(data)
                sample("sort_end")
                return total
            pass_index = 0
            while len(run_paths) > MERGE_FANIN:
                _failpoints.fire("extsort_merge", runs=len(run_paths))
                observe.emit("merge_pass", {"pass": pass_index, "runs": len(run_paths)})
                merged_paths: list[str] = []
                for gi in range(0, len(run_paths), MERGE_FANIN):
                    group = run_paths[gi : gi + MERGE_FANIN]
                    out = os.path.join(
                        tmpdir.name, f"pass{pass_index:02d}_{len(merged_paths):05d}.bam"
                    )
                    with BamWriter(out, header, level=1, engine="native") as w:
                        merge_checked(group, w._bgzf)
                    for p in group:
                        os.remove(p)
                    spiller.record(out)
                    merged_paths.append(out)
                run_paths = merged_paths
                pass_index += 1
            _failpoints.fire("extsort_merge", runs=len(run_paths))
            merged = merge_checked(run_paths, writer._bgzf)
            sample("sort_end")
            return merged
    finally:
        held.close()
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
    sort_engine: str = "auto",
    metrics=None,
    sort_buckets: int = 0,
) -> None:
    """Write a consensus batch stream (lists of BamRecord / RawRecords) to
    a BAM: straight through in 'unaligned' mode, via the external
    coordinate sort in 'self' mode — never the whole output in RAM.
    `level` is the BGZF deflate level, `sort_engine` the sort's engine
    (resolve_sort_engine). metrics (a stage's utils.observe.Metrics):
    the seconds this function spends sorting, spilling, merging and
    writing — not the time the producer takes for its batches — accrue
    there under 'sort_write'."""
    engine = resolve_sort_engine(sort_engine) if mode == "self" else None
    with _timer(metrics):
        writer = BamWriter(out_path, header, level=level)
    if metrics is not None:
        attach_codec_metrics(writer, metrics)
    try:
        if mode == "self":
            external_sort_raw_to_writer(
                (item for batch in batches for item in batch),
                writer, header, workdir=workdir,
                buffer_records=buffer_records, metrics=metrics, engine=engine,
                sort_buckets=sort_buckets,
            )
        else:
            for batch in batches:
                with _timer(metrics):
                    write_items(writer, batch)
    finally:
        with _timer(metrics):
            writer.close()
