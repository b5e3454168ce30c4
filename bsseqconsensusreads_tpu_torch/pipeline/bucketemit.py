"""Sort-free coordinate-bucketed emit: the third sort engine.

The port's copy of the JAX package's pipeline/bucketemit.py. The
external-sort engines (pipeline.extsort, python|native) buy bounded
memory with a k-way merge tail: every record funnels through one merge
loop on one thread. This module removes the merge instead.

Consensus output is coordinate-sorted, and coordinates are known at emit
time — a retired record can land directly in the bucket that owns its
(ref, pos) range. Buckets partition the combined coordinate key space
(``ref * 2^31 + pos``; boundaries are (ref, pos) points, so records with
equal full sort keys never straddle a boundary). Each bucket then sorts
on its own — small, in-core, on the host pool — and the output is the
concatenation of the buckets in plan order. Every in-bucket sort is
stable and arrival order within a bucket is kept end to end (spill runs
in spill order, live buffer last, heapq.merge breaking ties by stream
index), so the concatenation IS the global stable coordinate sort: the
bytes equal sort_engine=python|native for any bucket and worker count
(tests/test_torch_bucketemit.py).

Memory stays bounded without a global merge: when the buffered records
reach ``buffer_records`` the LARGEST bucket spills its buffer as one
sorted level-1 BGZF run (CRC'd, retried, the `bucket_spill` failpoint).

Durability: under a batch checkpoint (`finalize_checkpoint`) the engine
adds a bucket-run manifest beside the target (`<target>.bucketruns/`)
riding the same CRC + fingerprint machinery as the shard manifest —
Phase A routes every durable shard record into per-bucket sorted runs
and commits the manifest atomically; Phase B streams buckets in plan
order through the checkpoint's atomic finalize (`bucket_finalize`
failpoint per bucket). A kill + resume verifies every run CRC and
replays ONLY the damaged buckets (`bucket_replayed` counter) before
re-finalizing.

The BGZF stream is one continuous writer across buckets — block cutting
never flushes at a bucket boundary, so the compressed bytes match the
stream engines too. The routing pass and the in-bucket sorts are the C
sweeps of io.wirepack (bucket_split, sort_raw_records); the port has no
Python twin of them here (a failed build raises NativeLibraryError).
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import struct
import tempfile
from functools import partial
from typing import Iterable, Iterator

import numpy as np

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.faults import retry as _faultretry
from bsseqconsensusreads_tpu_torch.io.bam import (
    BamHeader,
    BamReader,
    BamWriter,
    RawRecords,
    encode_record,
)
from bsseqconsensusreads_tpu_torch.pipeline.extsort import (
    DEFAULT_BUFFER_RECORDS,
    _verify_spills,
    raw_coordinate_key,
)
from bsseqconsensusreads_tpu_torch.utils import observe

#: Combined bucket key: ref * 2^31 + pos (pos < 2^31 by the BAM spec, so
#: the fold is collision-free and fits int64, and combined-key order ==
#: lexicographic (ref, pos) order). ref_id=-1 and pos=-1 each take the
#: external-sort sentinel (1<<30) INDEPENDENTLY — exactly the first two
#: fields of extsort.raw_coordinate_key, so a mapped-ref/unplaced-pos
#: record buckets within its contig, not at the end. MUST stay in sync
#: with the native sweep (csrc/host/wirepack.cpp wirepack_bucket_assign).
REF_SHIFT = 31
UNMAPPED_SENTINEL = 1 << 30

#: Default bucket count under `sort_buckets=0`. Buckets are cheap when
#: empty (one bytearray), and more buckets mean smaller in-core sorts
#: and more hostpool parallelism — 32 keeps per-bucket run counts tiny
#: even when spilling while staying far under any fd limit.
DEFAULT_BUCKETS = 32

ENV_BUCKETS = "BSSEQ_TPU_SORT_BUCKETS"

#: Bucket-run manifest name inside `<target>.bucketruns/`.
MANIFEST_NAME = "MANIFEST.json"


def resolve_buckets(buckets: int = 0) -> int:
    """Bucket count for the plan: BSSEQ_TPU_SORT_BUCKETS overrides
    (experiments / A-B runs), else the passed knob
    (FrameworkConfig.sort_buckets), else DEFAULT_BUCKETS."""
    env = os.environ.get(ENV_BUCKETS)
    if env is not None:
        try:
            buckets = int(env)
        except ValueError:
            buckets = 0
    return buckets if buckets >= 1 else DEFAULT_BUCKETS


def blob_bucket_key(blob: bytes) -> int:
    """Combined coordinate key of one encoded record blob (fixed offsets:
    ref_id +4, pos +8 — same fields raw_coordinate_key reads)."""
    ref_id, pos = struct.unpack_from("<ii", blob, 4)
    if ref_id < 0:
        ref_id = UNMAPPED_SENTINEL
    if pos < 0:
        pos = UNMAPPED_SENTINEL
    return (ref_id << REF_SHIFT) + pos


class BucketPlan:
    """Partition of the combined coordinate key space into contiguous
    buckets. boundaries[b] is bucket b's inclusive lower bound;
    boundaries[0] is always 0 and the last bucket extends to +inf
    (including the unmapped sentinel), so every key has exactly one
    owner. Planned from the header's reference dictionary: interior
    boundaries land at equal cumulative-genome-length strides, which
    spreads uniform coverage evenly and degrades gracefully (never
    incorrectly) under positional skew — a hot bucket just sorts more
    records or spills."""

    def __init__(self, boundaries: list[int]):
        if not boundaries or boundaries[0] != 0:
            raise ValueError("bucket plan must start at key 0")
        if sorted(set(boundaries)) != list(boundaries):
            raise ValueError("bucket boundaries must be strictly ascending")
        self.boundaries = list(boundaries)
        self.nbuckets = len(boundaries)

    @classmethod
    def from_header(cls, header: BamHeader, buckets: int = 0) -> "BucketPlan":
        n = resolve_buckets(buckets)
        total = sum(length for _, length in header.references)
        if n <= 1 or total <= 0:
            return cls([0])
        bounds = [0]
        cum = [0]
        for _, length in header.references:
            cum.append(cum[-1] + max(0, length))
        for i in range(1, n):
            target = total * i // n
            # contig owning the target stride, position within it
            ref = bisect.bisect_right(cum, target) - 1
            ref = min(ref, len(header.references) - 1)
            pos = target - cum[ref]
            key = (ref << REF_SHIFT) + pos
            if key > bounds[-1]:
                bounds.append(key)
        return cls(bounds)

    def bucket_of(self, key: int) -> int:
        return bisect.bisect_right(self.boundaries, key) - 1

    def as_array(self) -> np.ndarray:
        return np.asarray(self.boundaries, dtype=np.int64)


def _split_blobs(blob: bytes) -> Iterator[bytes]:
    """Per-record frames of a concatenated raw-record blob (4-byte
    block_size prefixes, io.bam encoding)."""
    off = 0
    n = len(blob)
    while off < n:
        (size,) = struct.unpack_from("<i", blob, off)
        yield blob[off : off + 4 + size]
        off += 4 + size


class BucketRouter:
    """Routes a mixed item stream (RawRecords blocks / encoded blobs /
    BamRecord objects) into per-bucket buffers, spilling the largest
    bucket as a sorted run when the total buffered records reach
    `buffer_records`. Routing uses the native frame-scan + scatter
    sweeps (io.wirepack.bucket_split); a single record routes in Python
    by its key. Arrival order is kept within each bucket.

    rundir=None keeps runs in a private temp dir (deleted with the
    router); a concrete rundir makes them durable state for the
    checkpointed two-phase finalize."""

    def __init__(self, plan: BucketPlan, header: BamHeader,
                 workdir: str | None = None,
                 buffer_records: int = DEFAULT_BUFFER_RECORDS,
                 metrics=None, rundir: str | None = None):
        if buffer_records < 1:
            raise ValueError(
                f"buffer_records must be >= 1, got {buffer_records}"
            )
        self.plan = plan
        self.header = header
        self.metrics = metrics
        self.buffer_records = buffer_records
        self._bounds = plan.as_array()
        self._bounds_list = plan.boundaries
        self._bufs = [bytearray() for _ in range(plan.nbuckets)]
        self._counts = [0] * plan.nbuckets
        self._total_buffered = 0
        self.total_records = 0
        #: per-bucket ordered run paths (spill order == arrival order
        #: partition — the merge tie-break depends on it)
        self.runs: list[list[str]] = [[] for _ in range(plan.nbuckets)]
        self.run_crcs: dict[str, int] = {}
        self.run_records: dict[str, int] = {}
        self._verify = _verify_spills()
        self._rundir = rundir
        self._tmpdir: tempfile.TemporaryDirectory | None = None
        self._workdir = workdir
        self._route_s = 0.0
        self._spill_s = 0.0
        self._spills = 0

    # ---------------------------------------------------------------- routing

    def route(self, item) -> None:
        import time as _time

        t0 = _time.monotonic()
        if isinstance(item, RawRecords):
            self._route_blob(item.blob, item.count)
        elif isinstance(item, (bytes, memoryview)):
            self._route_one(bytes(item))
        else:
            self._route_one(encode_record(item))
        self._route_s += _time.monotonic() - t0
        if self._total_buffered >= self.buffer_records:
            self.spill_largest()

    def _route_one(self, blob: bytes) -> None:
        b = bisect.bisect_right(self._bounds_list, blob_bucket_key(blob)) - 1
        self._bufs[b] += blob
        self._counts[b] += 1
        self._total_buffered += 1
        self.total_records += 1

    def _route_blob(self, blob: bytes, count: int) -> None:
        if not blob:
            return
        if count != 1:
            from bsseqconsensusreads_tpu_torch.io import wirepack as _wirepack

            parts, counts = _wirepack.bucket_split(blob, self._bounds)
            for b, part in enumerate(parts):
                if part:
                    self._bufs[b] += part
                    self._counts[b] += int(counts[b])
            n = int(counts.sum())
            self._total_buffered += n
            self.total_records += n
        else:
            self._route_one(blob)

    # ---------------------------------------------------------------- sorting

    def _sort_payload(self, buf) -> tuple[bytes, int]:
        """Stable in-core coordinate sort of one bucket's buffer: the C
        sweep the native engine's runs use; returns (sorted bytes, record
        count)."""
        if not buf:
            return b"", 0
        from bsseqconsensusreads_tpu_torch.io import wirepack as _wirepack

        data, n, key_s, order_s = _wirepack.sort_raw_records(buf)
        if self.metrics is not None:
            if key_s:
                self.metrics.add_seconds("sort_write.key_extract", key_s)
            if order_s:
                self.metrics.add_seconds("sort_write.order", order_s)
        return data, n

    # ---------------------------------------------------------------- spills

    def _run_root(self) -> str:
        if self._rundir is not None:
            os.makedirs(self._rundir, exist_ok=True)
            return self._rundir
        if self._tmpdir is None:
            self._tmpdir = tempfile.TemporaryDirectory(
                prefix="bsseq_bucket_", dir=self._workdir
            )
        return self._tmpdir.name

    def _write_run_file(self, path: str, payload: bytes, bucket: int,
                        run_index: int) -> None:
        """One bucket-run write attempt — the retry unit for transient
        spill I/O (the sorted payload stays in memory; a failed attempt
        rewrites the same path whole, byte-identical)."""
        _failpoints.fire("bucket_spill", bucket=bucket, run=run_index)
        with BamWriter(path, self.header, level=1) as w:
            w.write_raw(payload)
        if self._verify:
            self.run_crcs[path] = _integrity.file_crc32(path)

    def _spill_bucket(self, bucket: int) -> None:
        import time as _time

        t0 = _time.monotonic()
        data, n = self._sort_payload(self._bufs[bucket])
        self._bufs[bucket] = bytearray()
        self._total_buffered -= self._counts[bucket]
        self._counts[bucket] = 0
        if not n:
            return
        run_index = len(self.runs[bucket])
        path = os.path.join(
            self._run_root(), f"bucket{bucket:04d}_run{run_index:05d}.bam"
        )
        _faultretry.guarded(
            partial(self._write_run_file, path, data, bucket, run_index),
            metrics=self.metrics, stage="bucket_spill", batch=bucket,
        )
        self.runs[bucket].append(path)
        self.run_records[path] = n
        self._spills += 1
        self._spill_s += _time.monotonic() - t0
        if self.metrics is not None:
            self.metrics.count("bucket_spill_runs")
            self.metrics.count("spill_records", n)
        observe.emit("bucket_spill", {"bucket": bucket, "run": run_index, "records": n,
                                      "seconds": round(_time.monotonic() - t0, 3)})

    def spill_largest(self) -> None:
        """Spill ONLY the largest bucket's buffer: frees the most memory
        per run file, and keeps every other bucket's buffer live so the
        common case still concatenates pure in-core sorts."""
        b = max(range(self.plan.nbuckets), key=lambda i: self._counts[i])
        if self._counts[b]:
            self._spill_bucket(b)

    def flush_all_runs(self) -> None:
        """Spill every non-empty buffer (durable Phase A: after this,
        every record lives in a CRC'd sorted run on disk)."""
        for b in range(self.plan.nbuckets):
            if self._counts[b]:
                self._spill_bucket(b)

    # ---------------------------------------------------------------- output

    def account_stream_seconds(self) -> None:
        """Book the in-stream routing + spill seconds accumulated by
        route() into 'sort_write' (these happen BETWEEN the producer's
        yields, like the external sort's in-stream spills) with dotted
        sub-phase attribution. Idempotent: booked seconds reset."""
        if self.metrics is None:
            self._route_s = self._spill_s = 0.0
            return
        if self._route_s:
            self.metrics.add_seconds("sort_write", self._route_s)
            self.metrics.add_seconds(
                "sort_write.bucket_route", self._route_s
            )
            self._route_s = 0.0
        if self._spill_s:
            self.metrics.add_seconds("sort_write", self._spill_s)
            self.metrics.add_seconds(
                "sort_write.bucket_spill", self._spill_s
            )
            self._spill_s = 0.0

    def _open_runs(self, paths: list[str], readers: list) -> list:
        streams = []
        for p in paths:
            want = self.run_crcs.get(p)
            if want is not None:
                _integrity.verify_file_crc32(p, want, what=f"bucket run {p}")
            r = BamReader(p, threads=1)
            readers.append(r)
            streams.append(r.raw_records())
        return streams

    def write_to(self, writer: BamWriter) -> int:
        """Stream every bucket to `writer` in plan order. Buffer-only
        buckets sort on the hostpool (bounded in-flight window, strictly
        in-order writes — identical bytes for any worker count); buckets
        with spill runs stream through a per-bucket heapq merge whose
        tie-break (run order, live buffer last) reproduces arrival
        order. One continuous BGZF stream: no flush between buckets."""
        import time as _time

        from bsseqconsensusreads_tpu_torch.parallel import hostpool as _hostpool

        self.account_stream_seconds()

        # the stage's own pool counted its host_pool_workers already:
        # this one is ledgered, not counted again
        n = _hostpool.host_workers()
        _hostpool.announce(n, "bucket_sort")
        pool = _hostpool.HostPool(n, self.metrics, "bucket_sort") if n > 0 else None
        sort_s = 0.0
        concat_s = 0.0
        written = 0
        try:
            pending: list = []  # (bucket, future|payload) in plan order
            window = (pool.workers * 2) if pool is not None else 1

            def emit_one(bucket: int, payload) -> None:
                nonlocal sort_s, concat_s, written
                _failpoints.fire("bucket_finalize", bucket=bucket)
                if isinstance(payload, tuple):
                    data, n = payload
                else:
                    t0 = _time.monotonic()
                    data, n = payload.result()
                    sort_s += _time.monotonic() - t0
                t0 = _time.monotonic()
                if self.runs[bucket]:
                    readers: list = []
                    try:
                        streams = self._open_runs(self.runs[bucket], readers)
                        streams.append(_split_blobs(data))
                        n = writer.write_raw_many(
                            heapq.merge(*streams, key=raw_coordinate_key)
                        )
                    finally:
                        for r in readers:
                            r.close()
                elif data:
                    writer.write_raw(data)
                concat_s += _time.monotonic() - t0
                written += n

            for b in range(self.plan.nbuckets):
                if pool is not None and self._counts[b]:
                    while len(pending) >= window:
                        emit_one(*pending.pop(0))
                    pending.append(
                        (b, pool.submit(self._sort_payload, self._bufs[b],
                                        batch=b))
                    )
                else:
                    t0 = _time.monotonic()
                    payload = self._sort_payload(self._bufs[b])
                    sort_s += _time.monotonic() - t0
                    while pending:
                        emit_one(*pending.pop(0))
                    emit_one(b, payload)
            while pending:
                emit_one(*pending.pop(0))
        finally:
            if pool is not None:
                pool.shutdown()
            if self._tmpdir is not None:
                self._tmpdir.cleanup()
                self._tmpdir = None

        if self.metrics is not None:
            self.metrics.add_seconds("sort_write", sort_s + concat_s)
            if sort_s:
                self.metrics.add_seconds("sort_write.bucket_sort", sort_s)
            if concat_s:
                self.metrics.add_seconds("sort_write.bucket_concat",
                                             concat_s)
        return written

    def stream_to(self, writer: BamWriter) -> Iterator[bytes]:
        """write_to's inter-stage tee: write every bucket to `writer` in
        plan order (serially — the consumer drives the pace) AND yield
        each record's encoded blob right after it lands, so a downstream
        stage can group the sorted stream without re-reading the file
        (FrameworkConfig.stream_interstage). The written bytes are
        identical to write_to's — same record order through the same
        continuous BGZF stream."""
        import time as _time

        self.account_stream_seconds()
        sort_s = 0.0
        concat_s = 0.0
        try:
            for b in range(self.plan.nbuckets):
                _failpoints.fire("bucket_finalize", bucket=b)
                t0 = _time.monotonic()
                data, _n = self._sort_payload(self._bufs[b])
                self._bufs[b] = bytearray()
                sort_s += _time.monotonic() - t0
                if self.runs[b]:
                    readers: list = []
                    try:
                        streams = self._open_runs(self.runs[b], readers)
                        streams.append(_split_blobs(data))
                        for blob in heapq.merge(
                            *streams, key=raw_coordinate_key
                        ):
                            t0 = _time.monotonic()
                            writer.write_raw(blob)
                            concat_s += _time.monotonic() - t0
                            yield blob
                    finally:
                        for r in readers:
                            r.close()
                elif data:
                    t0 = _time.monotonic()
                    writer.write_raw(data)
                    concat_s += _time.monotonic() - t0
                    for blob in _split_blobs(data):
                        yield blob
        finally:
            if self.metrics is not None:
                self.metrics.add_seconds("sort_write", sort_s + concat_s)
                if sort_s:
                    self.metrics.add_seconds(
                        "sort_write.bucket_sort", sort_s
                    )
                if concat_s:
                    self.metrics.add_seconds(
                        "sort_write.bucket_concat", concat_s
                    )
            if self._tmpdir is not None:
                self._tmpdir.cleanup()
                self._tmpdir = None

    def close(self) -> None:
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            # graftlint: disable=thread-unsafe-mutation -- closed by the emitting thread
            # that owns the router
            self._tmpdir = None


def bucket_sort_to_writer(
    items: Iterable,
    writer: BamWriter,
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    metrics=None,
    buckets: int = 0,
) -> int:
    """sort_engine=bucket entry (external_sort_raw_to_writer dispatches
    here): route, per-bucket sort, concatenate. Returns records written.
    Output bytes are identical to the python/native external-sort
    engines on the same stream."""
    plan = BucketPlan.from_header(header, buckets)
    if metrics is not None:
        metrics.count("bucket_count", plan.nbuckets)
    observe.emit("bucket_plan", {"buckets": plan.nbuckets, "records_per_spill": buffer_records})
    router = BucketRouter(
        plan, header, workdir=workdir, buffer_records=buffer_records,
        metrics=metrics,
    )
    try:
        for item in items:
            router.route(item)
        n = router.write_to(writer)
        if metrics is not None:
            metrics.count("bucket_records", n)
        return n
    finally:
        router.close()


# ------------------------------------------------------------------ durable


def _manifest_path(rundir: str) -> str:
    return os.path.join(rundir, MANIFEST_NAME)


def _save_manifest(rundir: str, doc: dict) -> None:
    path = _manifest_path(rundir)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _load_manifest(rundir: str) -> dict | None:
    try:
        with open(_manifest_path(rundir)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _router_manifest(router: BucketRouter, fingerprint: dict) -> dict:
    return {
        "fingerprint": fingerprint,
        "boundaries": router.plan.boundaries,
        "complete": True,
        "buckets": [
            [
                [os.path.basename(p), router.run_crcs.get(p, 0),
                 router.run_records.get(p, 0)]
                for p in router.runs[b]
            ]
            for b in range(router.plan.nbuckets)
        ],
    }


def _damaged_buckets(rundir: str, doc: dict) -> list[int]:
    """Buckets whose runs fail their CRC (or vanished) — ONLY these
    replay on resume."""
    bad = []
    for b, runs in enumerate(doc["buckets"]):
        for name, crc, _n in runs:
            try:
                _integrity.verify_file_crc32(
                    os.path.join(rundir, name), crc,
                    what=f"bucket run {name}",
                )
            except OSError:
                bad.append(b)
                break
    return bad


def _replay_buckets(ck, rundir: str, doc: dict, damaged: list[int],
                    plan: BucketPlan, header: BamHeader, metrics=None) -> None:
    """Re-route the durable shard stream, keeping ONLY the damaged
    buckets' records; rewrite each as one fresh sorted run and commit
    the repaired manifest atomically."""
    damaged_set = set(damaged)
    router = BucketRouter(plan, header, rundir=rundir,
                          buffer_records=1 << 62, metrics=metrics)
    for blob in ck.iter_raw_records():
        if plan.bucket_of(blob_bucket_key(blob)) in damaged_set:
            router.route(blob)
    for b in damaged:
        for name, _crc, _n in doc["buckets"][b]:
            try:
                os.remove(os.path.join(rundir, name))
            except FileNotFoundError:
                pass
        router._spill_bucket(b)
        doc["buckets"][b] = [
            [os.path.basename(p), router.run_crcs.get(p, 0),
             router.run_records.get(p, 0)]
            for p in router.runs[b]
        ]
    router.account_stream_seconds()
    _save_manifest(rundir, doc)
    if metrics is not None:
        metrics.count("bucket_replayed", len(damaged))
    observe.event("bucket_replayed", {"target": ck.target, "buckets": damaged})


def _write_manifest_buckets(writer: BamWriter, rundir: str, doc: dict,
                            verify: bool) -> int:
    """Phase B: stream every bucket's runs to the open target writer in
    plan order (single-run fast path copies raw bytes; multi-run buckets
    heap-merge with run-order tie-break)."""
    written = 0
    for b, runs in enumerate(doc["buckets"]):
        _failpoints.fire("bucket_finalize", bucket=b)
        if not runs:
            continue
        readers: list = []
        try:
            streams = []
            for name, crc, _n in runs:
                path = os.path.join(rundir, name)
                if verify:
                    _integrity.verify_file_crc32(
                        path, crc, what=f"bucket run {name}"
                    )
                r = BamReader(path, threads=1)
                readers.append(r)
                streams.append(r.raw_records())
            if len(streams) == 1:
                written += writer.write_raw_many(streams[0])
            else:
                written += writer.write_raw_many(
                    heapq.merge(*streams, key=raw_coordinate_key)
                )
        finally:
            for r in readers:
                r.close()
    return written


def finalize_checkpoint(
    ck,
    header: BamHeader,
    workdir: str | None = None,
    buffer_records: int = DEFAULT_BUFFER_RECORDS,
    metrics=None,
    buckets: int = 0,
) -> int:
    """Two-phase bucketed finalize of a BatchCheckpoint (the
    sort_engine=bucket branch of stages._write_stage_output).

    Phase A routes every durable shard record into per-bucket sorted
    level-1 runs under `<target>.bucketruns/` and commits a manifest
    (checkpoint fingerprint + plan + per-run CRCs) atomically — crash
    here and the next resume redoes Phase A from the still-present
    shards. Phase B streams buckets in plan order through the
    checkpoint's atomic finalize; crash here and the next resume finds
    the complete manifest, verifies every run CRC, replays ONLY damaged
    buckets from the shards (`bucket_replayed`), and re-finalizes —
    byte-identical output either way."""
    rundir = ck.target + ".bucketruns"
    plan = BucketPlan.from_header(header, buckets)
    if metrics is not None:
        metrics.count("bucket_count", plan.nbuckets)
    fingerprint = dict(ck.manifest.fingerprint)
    fingerprint["bucket_boundaries"] = plan.boundaries
    doc = _load_manifest(rundir)
    if (
        doc is not None
        and doc.get("complete")
        and doc.get("fingerprint") == fingerprint
        and doc.get("boundaries") == plan.boundaries
        and len(doc.get("buckets", [])) == plan.nbuckets
    ):
        damaged = _damaged_buckets(rundir, doc)
        if damaged:
            _replay_buckets(ck, rundir, doc, damaged, plan, header, metrics)
        observe.emit("bucket_manifest_resumed", {"target": ck.target, "replayed": len(damaged)})
    else:
        if doc is not None:
            observe.event("bucket_manifest_discarded",
                          {"target": ck.target,
                           "reason": "incomplete_or_fingerprint_mismatch"})
        import shutil

        shutil.rmtree(rundir, ignore_errors=True)
        router = BucketRouter(
            plan, header, workdir=workdir, buffer_records=buffer_records,
            metrics=metrics, rundir=rundir,
        )
        for blob in ck.iter_raw_records():
            router.route(blob)
        router.flush_all_runs()
        router.account_stream_seconds()
        doc = _router_manifest(router, fingerprint)
        _save_manifest(rundir, doc)

    import time as _time

    from bsseqconsensusreads_tpu_torch.io.bam import attach_codec_metrics

    verify = _verify_spills()

    def writer_fn(w: BamWriter) -> int:
        if metrics is not None:
            attach_codec_metrics(w, metrics)
        return _write_manifest_buckets(w, rundir, doc, verify)

    t0 = _time.monotonic()
    n = ck.finalize(writer_fn=writer_fn)
    if metrics is not None:
        dt = _time.monotonic() - t0
        metrics.add_seconds("sort_write", dt)
        metrics.add_seconds("sort_write.bucket_concat", dt)
    import shutil

    shutil.rmtree(rundir, ignore_errors=True)
    if metrics is not None:
        metrics.count("bucket_records", n)
    return n
