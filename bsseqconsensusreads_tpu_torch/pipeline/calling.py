"""Streaming consensus callers on the card: BAM records in, consensus
records out.

The port of the JAX package's pipeline/calling.py (layout 'packed' or
'padded'; one device or a mesh). Replaces the reference's two JVM
consensus engines:

* call_molecular_batches — `fgbio CallMolecularConsensusReads`
  (main.snake.py:46-55)
* call_duplex_batches    — the whole convert -> extend -> sort -> duplex
  chain (main.snake.py:121-164) as one fused device stage

Both stream MI families in bounded batches. Per batch the host encodes
numpy tensors, copies them to the device, launches the vote (ops.cuda_vote)
and the elementwise ops around it, records a CUDA event, and moves on:
the batch retires (event sync timed as 'device_wait', one D2H copy and
the host unpack timed as 'fetch', then the record emit) only after the
NEXT batch has been dispatched, so the device works while the host
encodes and emits. Output order is the batch order, exactly as in the JAX
package.

Two transports (_resolve_transport; 'auto' = the wire on the card, the
unpacked tensors on the CPU, the JAX package's single-device rule):
* 'wire' — ONE packed u32 array in (ops.wire). Molecular: the
  packed-rows wire v2 (or the v1 envelope wire under layout 'padded').
  Duplex: the packed batch, its reference windows gathered on the device
  from the whole genome, read and uploaded once per stage (ops.refstore
  — the encode skips the per-family host fetch, the rawize reads
  RefStore.host_windows).
* 'unpacked' — the batch's tensors in.
Both return the same packed output planes (one D2H copy) and write the
same bytes. The JAX package's slim molecular and b0 duplex outputs are
not ported: on the card's PCIe link the bytes they save are worth less
than the host rebuild they cost (PERF.md).

Alignment modes for the emitted consensus:
* 'unaligned' — parity with fgbio: unmapped records in sequencing
  orientation, to be realigned externally.
* 'self' — window-space consensus keeps genomic coordinates, so records
  are emitted already aligned.

Host engines: records come in as BamRecords from a BamReader or as
pre-grouped columnar family runs from the C decoder
(pipeline.ingest.GroupedColumnarStream, chosen by pipeline.stages); emit
is 'native' (the C batch record emit, with the C cB histogram, duplex
rawize and strand-call sweeps, and on the wire the C packs —
io.wirepack) or 'python' (BamRecord objects and the numpy twins). Both
engines write the same bytes.

Deep families (more kept templates than deep_threshold, default
MAX_TEMPLATES) take the JAX package's single-device deep route: padded
dispatches bucketed by template count (_split_deep, _bucket_deep), up to
DEEP_TEMPLATE_CAP templates; only families beyond the cap are skipped
and counted ('deep_skipped_families').

With methyl (a methyl.tally.MethylAccumulator), call_duplex_batches also
computes the methylation planes of every batch (methyl.context): on the
batch's device inside the duplex dispatch (on the wire its output wire
carries them after the duplex planes) or with the numpy twin on the host
(methyl_engine 'host'), and adds their tallies to the accumulator in
the ordered retire.

The batch engine (the JAX package's accelerator defaults): every batch
is one task — its dispatch + fetch unit under the bounded retrier
(faults.retry.guarded), then its record emit against shadow stats — on
the stage's one executor (_batch_executor): the overlap workers on the
card (_overlap_workers, BSSEQ_TPU_OVERLAP_THREADS; each owns a CUDA
stream and pinned staging buffers, _OverlapPool and _Staging), else the
host workers (parallel.hostpool, BSSEQ_TPU_HOST_WORKERS, min(4,
cores-1)), else the dispatch thread itself (_Inline). The host workers
also encode one chunk ahead (_hp_prefetch). One retire joins each task
in batch order (_pipelined), so the bytes are the same for any worker
count; the shadow counts, the methyl tallies and checkpoint
skip_batches all see batches in order. The failpoint sites are
dispatch_kernel, fetch_out and retire_future; a batch that keeps
failing degrades to its unit once more on the stage's own device with
the failpoints bypassed (counted 'batches_degraded' and printed on
stderr; a card run's batch is never voted on the CPU), a CUDA, card
memory or kernel build error is never retried, and the stall watchdog
(BSSEQ_TPU_STALL_TIMEOUT_S) re-runs a wedged batch inline. The input guard's family admission (faults.guard.guard_groups)
runs on the group stream.

Meshes (parallel.mesh; mesh='auto' shards over every visible card when
there is more than one, as the JAX package does over its devices): the
family axis shards over the mesh's data axis (parallel.sharding, each
shard on its own device and stream, no collective), or an explicit
'wire' round-robins whole batches over the mesh's slots
(_WireRoundRobin); the deep route splits its template axis over every
slot (parallel.deep_family). Every route writes the one-device bytes,
except that a deep family's quals may differ by one.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field
from functools import partial
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import NBASE
from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import guard as _guard_mod
from bsseqconsensusreads_tpu_torch.faults import retry as _faultretry
from bsseqconsensusreads_tpu_torch.faults.guard import MissingTagError
from bsseqconsensusreads_tpu_torch.io.bam import (
    CDEL,
    CHARD_CLIP,
    CINS,
    CMATCH,
    CSOFT_CLIP,
    FMREVERSE,
    FMUNMAP,
    FPAIRED,
    FPROPER_PAIR,
    FREAD1,
    FREAD2,
    FREVERSE,
    FUNMAP,
    BamRecord,
    RawRecords,
)
from bsseqconsensusreads_tpu_torch.methyl.context import (
    methyl_epilogue_host,
    unpack_methyl_planes,
)
from bsseqconsensusreads_tpu_torch.models.duplex import (
    ROLE_STRAND_ROWS,
    duplex_call_pipeline_packed,
    duplex_call_pipeline_packed_methyl,
    duplex_call_wire_fused,
    duplex_call_wire_fused_methyl,
    unpack_duplex_outputs,
)
from bsseqconsensusreads_tpu_torch.models.molecular import (
    molecular_base_counts,
    molecular_consensus,
    molecular_consensus_packed,
    molecular_wire_kernel,
    molecular_wire_packed_kernel,
    host_segment_offsets,
    pack_molecular_outputs,
    regular_offsets,
    singleton_consensus_host,
    sparsify_base_counts,
    unpack_molecular_outputs,
)
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import hosttwin
from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore
from bsseqconsensusreads_tpu_torch.ops.wire import (
    pack_duplex_inputs,
    pack_molecular_inputs,
    pack_molecular_rows_wire,
)
from bsseqconsensusreads_tpu_torch.ops.encode import (
    CONVERT_ROWS,
    DUPLEX_ROW_OF_FLAG,
    INDEL_POLICIES,
    MAX_TEMPLATES,
    bucket_templates,
    codes_to_seq,
    encode_duplex_families,
    encode_molecular_families,
    pack_molecular_rows,
    scan_matches,
    shard_packed_rows,
    trim_softclips,
)
from bsseqconsensusreads_tpu_torch.ops import cuda_vote
from bsseqconsensusreads_tpu_torch.parallel import hostpool as _hostpool
from bsseqconsensusreads_tpu_torch.parallel import sharding as _sharding
from bsseqconsensusreads_tpu_torch.parallel.deep_family import deep_family_consensus
from bsseqconsensusreads_tpu_torch.parallel.mesh import make_mesh, pad_families
from bsseqconsensusreads_tpu_torch.utils import compilecache, observe
from bsseqconsensusreads_tpu_torch.utils.device import resolve_device
from bsseqconsensusreads_tpu_torch.utils.observe import Metrics
from bsseqconsensusreads_tpu_torch.utils.oracle import oracle_convert_read

_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")

#: Ceiling of the deep-family route: keeps per-column depth inside the
#: int16 output dtypes (models.molecular.narrow_outputs) with margin.
#: Families beyond it are skipped AND counted ('deep_skipped_families').
DEEP_TEMPLATE_CAP = 16_384


def _revcomp(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


@contextlib.contextmanager
def _compile_probe(seen: set, key: tuple, stage: str):
    """Book the FIRST dispatch of each batch shape of one stage call as a
    'compile' span on the proc trace — the port's counterpart of the JAX
    package's probe around its first jit dispatch, read by `observe trace`
    beside jax_import / worker_spawn. On the card a stage also books the
    kernel library's load and the qual tables' vote_finalize launches
    (_warm_device, shape ['load', 'cuda']); later dispatches of a shape,
    and every dispatch with the ledger off, pay one set lookup. `seen`
    races benignly under the pools (at worst a duplicate span)."""
    if key in seen or observe.stats_sink() is None:
        yield
        return
    seen.add(key)
    t0 = time.time()
    try:
        yield
    finally:
        observe.emit_span("compile", t0, time.time(), ctx=observe.proc_trace(),
                          stage=stage, shape=list(key))


@dataclass
class StageStats:
    """Observability for one streaming stage: record/family counts and the
    per-phase wall-clock splits (metrics) that attribute a slow stage to
    host tensorization, device work, or record building."""

    stage: str = ""
    records_in: int = 0
    families: int = 0
    consensus_out: int = 0
    skipped_families: int = 0
    leftover_records: int = 0
    refragmented_families: int = 0
    batches: int = 0
    #: indel_policy 'align': indel reads the banded aligner placed / refused
    indel_aligned: int = 0
    indel_dropped: int = 0
    pad_cells: int = 0
    used_cells: int = 0
    wall_seconds: float = 0.0
    metrics: Metrics = field(default_factory=Metrics)

    # pad_cells/used_cells count DEVICE-ISSUED batches only (a batch the
    # singleton host vote absorbed issues no device work); `used` counts
    # real observation cells, the denominator is the rows actually issued

    def __post_init__(self):
        if not self.metrics.stage:
            self.metrics.stage = self.stage

    @property
    def pad_waste(self) -> float:
        total = self.pad_cells + self.used_cells
        return self.pad_cells / total if total else 0.0

    @property
    def families_per_second(self) -> float:
        return self.families / self.wall_seconds if self.wall_seconds else 0.0

    #: first-class stage fields read from the locked metrics counters
    #: (worker threads increment them): the retry executor's recovery
    #: accounting (faults.retry) and the input guard's (faults.guard) —
    #: a run summary can never hide that batches were retried,
    #: re-dispatched after a stall or degraded to the CPU, or that input
    #: was dropped or altered. Reconciliation: records_seen = records_in
    #: + records_quarantined.
    _GUARD_FIELDS = (
        ("records_seen", "records_seen"),
        ("records_quarantined", "records_quarantined"),
        ("records_repaired", "records_repaired"),
        ("families_quarantined", "families_quarantined"),
        ("family_records_quarantined", "family_records_quarantined"),
        ("stream_gaps", "stream_gap"),
        ("stream_truncations", "stream_truncated"),
        ("frame_resyncs", "frame_resync"),
        ("frames_lost", "frame_lost"),
    )
    _RETRY_FIELDS = ("batches_retried", "batches_recovered", "batches_degraded",
                     "batches_stalled")

    @property
    def effective_flop_utilization(self) -> float:
        """Data cells over issued cells: the complement of pad_waste."""
        total = self.pad_cells + self.used_cells
        return self.used_cells / total if total else 1.0

    def counter(self, name: str) -> int:
        return self.metrics.counters.get(name, 0)

    def as_dict(self) -> dict:
        """The stage's ledger line, in the JAX package's key order, with
        the phase summary (host_s, device_s, stall_s, chip_busy,
        unattributed_s) last."""
        return {
            "records_in": self.records_in,
            **{field: self.counter(name) for field, name in self._GUARD_FIELDS},
            "families": self.families,
            "consensus_out": self.consensus_out,
            "skipped_families": self.skipped_families,
            "leftover_records": self.leftover_records,
            "refragmented_families": self.refragmented_families,
            "batches": self.batches,
            "pad_waste": round(self.pad_waste, 4),
            "effective_flop_utilization": round(self.effective_flop_utilization, 4),
            "families_per_second": round(self.families_per_second, 1),
            "wall_seconds": round(self.wall_seconds, 3),
            "indel_aligned": self.indel_aligned,
            "indel_dropped": self.indel_dropped,
            **{name: self.counter(name) for name in self._RETRY_FIELDS},
            **self.metrics.as_dict(),
            **self.metrics.phase_summary(self.wall_seconds),
        }


#: Batch-composition flush sentinel: a GroupSource may interleave this
#: between families to cut the chunk under composition at once (the serve
#: scheduler's continuous-batching flush — resident families retire on an
#: idle queue instead of waiting for a full chunk). The batchers consume
#: it; it never reaches encode. In sequential batching a flush on an EMPTY
#: buffer yields an empty chunk — a sync barrier whose "now" event drains
#: the deferred retires, and which the host pool's prefetch does not look
#: past (_hp_prefetch).
FLUSH_BATCH = object()


class GroupSource:
    """A pre-grouped batch-composition source: an iterable of (mi, records)
    families, optionally interleaved with FLUSH_BATCH sentinels.
    stream_mi_groups passes it through ungrouped, so one engine call can be
    fed families composed outside it — the serve scheduler's multi-job
    source, which tags each family's mi with its job (serve.scheduler
    .JobMi, a str subclass: the same bytes on the wire and in the emitted
    qname, its job read back at the retire)."""

    __slots__ = ("groups",)

    def __init__(self, groups: Iterable):
        self.groups = groups

    def __iter__(self):
        return iter(self.groups)


def stream_mi_groups(
    records: Iterable[BamRecord],
    strip_suffix: bool = False,
    grouping: str = "gather",
    flush_margin: int = 10_000,
    stats: StageStats | None = None,
) -> Iterator[tuple[str, list[BamRecord]]]:
    """Yield (mi, records) groups from a record stream.

    grouping:
    * 'gather'     — hold all groups until the stream ends; correct for any
                     input order, memory O(file).
    * 'adjacent'   — yield a group when the MI changes; O(1 family) memory;
                     requires MI-grouped input.
    * 'coordinate' — bounded memory for coordinate-sorted input: a group is
                     flushed once the stream has moved flush_margin bases past
                     its last read. A family that reappears after being
                     flushed is processed as a second family and counted in
                     stats.refragmented_families.

    Records without an MI tag raise, matching the reference
    (tools/2.extend_gap.py:180).

    A pipeline.ingest.GroupedColumnarStream (records grouped in C, the
    same groups in the same order as this function's 'coordinate' or
    'adjacent' mode) delegates straight through; its grouping,
    strip_suffix and, in 'coordinate' mode, flush_margin must match this
    call's. A GroupSource passes straight through (its records still count
    in records_in).
    """
    if isinstance(records, GroupSource):
        for item in records:
            if item is not FLUSH_BATCH and stats is not None:
                stats.records_in += len(item[1])
            yield item
        return
    iter_groups = getattr(records, "iter_groups", None)
    if iter_groups is not None:
        if records.grouping != grouping:
            raise ValueError(
                f"pre-grouped stream was built for grouping={records.grouping!r}; "
                f"caller wants {grouping!r}"
            )
        if records.strip_suffix != strip_suffix or (
            grouping == "coordinate" and records.flush_margin != flush_margin
        ):
            raise ValueError(
                "pre-grouped stream was built with "
                f"(strip_suffix={records.strip_suffix}, flush_margin={records.flush_margin}); "
                f"caller wants ({strip_suffix}, {flush_margin})"
            )
        yield from iter_groups(stats)
        return

    def mi_of(rec: BamRecord) -> str:
        try:  # one tag parse per record, not a has_tag/get_tag pair
            mi = rec.get_tag("MI")
        except KeyError:
            raise MissingTagError(rec.qname) from None
        mi = str(mi)
        return mi.split("/")[0] if strip_suffix else mi

    if grouping == "gather":
        groups: dict[str, list[BamRecord]] = {}
        n = 0
        for rec in records:
            n += 1
            groups.setdefault(mi_of(rec), []).append(rec)
        if stats is not None:
            stats.records_in += n
        yield from groups.items()
        return

    if grouping == "adjacent":
        current_mi: str | None = None
        bucket: list[BamRecord] = []
        seen: set[int] = set()  # hash(mi) — backs only the refragment counter
        for rec in records:
            if stats is not None:
                stats.records_in += 1
            mi = mi_of(rec)
            if mi != current_mi:
                if bucket:
                    yield current_mi, bucket
                if stats is not None:
                    h = hash(mi)
                    if h in seen:
                        stats.refragmented_families += 1
                    seen.add(h)
                current_mi, bucket = mi, []
            bucket.append(rec)
        if bucket:
            yield current_mi, bucket
        return

    if grouping != "coordinate":
        raise ValueError(f"unknown grouping {grouping!r}")

    open_groups: dict[str, list[BamRecord]] = {}
    group_end: dict[str, tuple[int, int]] = {}  # mi -> (ref_id, max end)
    flushed: set[int] = set()  # hash(mi)
    # sweep open groups only after the stream advances a fraction of the
    # margin (or changes contig): the JAX package's amortized flush rule,
    # which fixes the group order both packages emit
    sweep_stride = max(flush_margin // 4, 1)
    last_sweep = (-1, -(1 << 62))
    for rec in records:
        if stats is not None:
            stats.records_in += 1
        mi = mi_of(rec)
        pos = rec.pos
        ref_id = rec.ref_id
        if (
            pos >= 0
            and open_groups
            and (ref_id != last_sweep[0] or pos - last_sweep[1] >= sweep_stride)
        ):
            done = [
                g
                for g, (rid, end) in group_end.items()
                if rid != ref_id or end + flush_margin < pos
            ]
            for g in done:
                yield g, open_groups.pop(g)
                del group_end[g]
                if stats is not None:
                    flushed.add(hash(g))
            last_sweep = (ref_id, pos)
        if stats is not None and mi not in open_groups and hash(mi) in flushed:
            stats.refragmented_families += 1
        open_groups.setdefault(mi, []).append(rec)
        if pos >= 0:
            rid, end = group_end.get(mi, (ref_id, -1))
            group_end[mi] = (ref_id, max(end, rec.reference_end))
    yield from open_groups.items()


def _group_batches(groups, size: int):
    buf: list = []
    for g in groups:
        if g is FLUSH_BATCH:
            # cut the partial chunk now; on an empty buffer, an empty
            # chunk: the sync barrier that drains the deferred retires
            yield buf
            buf = []
            continue
        buf.append(g)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf


def _kept_template_count(records, indel_policy: str = "drop") -> int:
    """Distinct qnames among records the encoder keeps: hardclipped reads
    never encode, indel reads do not under indel_policy 'drop' — the
    template-depth estimate shared by the deep-family splitter and the
    bucketed batcher, so both agree with what encode materializes."""
    drop_indels = indel_policy == "drop"
    drop_ops = (CINS, CDEL, CHARD_CLIP) if drop_indels else (CHARD_CLIP,)

    def kept(r) -> bool:
        info = getattr(r, "clip_info", None)
        if info is not None:  # columnar view: the C CIGAR digest
            return not (info[3] or (drop_indels and info[2]))
        return not any(op in drop_ops for op, _ in r.cigar)

    return len({r.qname for r in records if kept(r)})


def _group_batches_bucketed(groups, size: int, indel_policy: str = "drop"):
    """Depth-homogeneous chunking for the molecular stage: families
    accumulate per template bucket (ops.encode.bucket_templates of the
    kept-qname count) and a chunk is emitted when its bucket fills (at
    `size` families or size*8 records), remaining buckets in bucket order
    at the end — the JAX package's chunk composition, so both packages cut
    identical batches. FLUSH_BATCH cuts every open bucket, in bucket
    order."""
    pending: dict[int, list] = {}
    counts: dict[int, int] = {}
    max_records = size * 8
    for g in groups:
        if g is FLUSH_BATCH:
            for b in sorted(pending):
                yield pending.pop(b)
                counts.pop(b)
            continue
        if scan_matches(g, indel_policy):  # the C scan counted the templates
            n_tpl, n_rec = g.ntpl_est, g.n
        else:
            _, records = g
            n_tpl, n_rec = _kept_template_count(records, indel_policy), len(records)
        b = bucket_templates(n_tpl)
        lst = pending.setdefault(b, [])
        lst.append(g)
        counts[b] = counts.get(b, 0) + n_rec
        if len(lst) >= size or counts[b] >= max_records:
            yield pending.pop(b)
            counts.pop(b)
    for b in sorted(pending):
        yield pending[b]


def _split_deep(chunk, threshold: int, indel_policy: str = "drop"):
    """Partition groups by encodable template count: families whose count
    exceeds `threshold` go to the deep-family route (_bucket_deep, the
    padded vote) instead of being skipped at encode's max_templates cap.

    Counts distinct qnames of the records the encoder keeps
    (_kept_template_count), so a family padded with droppable reads is not
    misrouted. Families with <= threshold records skip the CIGAR scan (the
    count cannot exceed the record count); families carrying the C encode
    scan skip the record walk altogether. Deep entries carry the count:
    (group, depth)."""
    normal, deep = [], []
    for g in chunk:
        if scan_matches(g, indel_policy):  # the C scan counted the templates
            if g.ntpl_est <= threshold:
                normal.append(g)
            else:
                deep.append((g, g.ntpl_est))
            continue
        _, records = g
        if len(records) <= threshold:
            normal.append(g)
            continue
        n = _kept_template_count(records, indel_policy)
        if n > threshold:
            deep.append((g, n))
        else:
            normal.append(g)
    return normal, deep


def _pad_templates(bases, quals, n: int):
    """Pad the template axis of [K, T, 2, W] to a multiple of n (the deep
    mesh's reads size) with empty templates: NBASE bases add nothing to
    the vote."""
    pad = (-bases.shape[1]) % n
    if pad:
        widths = ((0, 0), (0, pad), (0, 0), (0, 0))
        bases = np.pad(bases, widths, constant_values=NBASE)
        quals = np.pad(quals, widths, constant_values=0)
    return bases, quals


def _bucket_deep(deep):
    """Group deep families into shared padded dispatches by template
    bucket (ops.encode.bucket_templates): families of one bucket vote as
    one [K, T, 2, W] batch, families of very different depth never pad
    each other. Each dispatch holds at most DEEP_TEMPLATE_CAP padded
    templates (K * T), so a deep-heavy chunk never builds an unbounded
    batch. Buckets yield in first-appearance order; families keep input
    order within a bucket."""
    buckets: dict[int, list] = {}
    for g, depth in deep:
        buckets.setdefault(bucket_templates(depth), []).append(g)
    for bucket, group in buckets.items():
        max_k = max(1, DEEP_TEMPLATE_CAP // bucket)
        for i in range(0, len(group), max_k):
            yield group[i:i + max_k]


def _pipelined(events, depth: int = 1):
    """Dispatch/retire software pipeline shared by the batch callers.

    `events` yields one ("now", records) or ("deferred", retire_fn) item per
    input chunk. A "deferred" retire (event sync + D2H copy + record emit
    of an already-dispatched batch, or the join of a pool's future) is
    held until `depth` newer dispatches are in flight; "now" results
    first drain the held retires. Exactly one yield per event, in event
    order — the invariant checkpoint resume's skip_batches counting
    depends on, so the bytes are the same for any depth. The held
    retires are dropped at once when the consumer abandons the
    generator, so a failing stage leaks no in-flight batch."""
    depth = max(depth, 1)
    pending: deque = deque()
    try:
        for kind, payload in events:
            if kind == "deferred":
                while len(pending) >= depth:
                    yield pending.popleft()()
                pending.append(payload)
            else:
                while pending:
                    yield pending.popleft()()
                yield payload
        while pending:
            yield pending.popleft()()
    finally:
        pending.clear()


def _overlap_workers(device: torch.device) -> int:
    """Worker threads of the dispatch/fetch overlap pipeline: the JAX
    package's rule — 2 on an accelerator (the card), 0 on the CPU, where
    the kernels run on the cores the pipeline needs.
    BSSEQ_TPU_OVERLAP_THREADS overrides (0 disables)."""
    env = os.environ.get("BSSEQ_TPU_OVERLAP_THREADS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return 2 if device.type == "cuda" else 0


class _Staging:
    """One overlap worker's pinned host staging: each upload copies its
    array into a region of a reused pinned buffer and leaves it with a
    non_blocking copy. reset() starts a task, after the worker's stream
    has drained (a task that failed may have left copies in flight)."""

    _ALIGN = 256

    def __init__(self):
        self._buf = None
        self._held: list = []  # outgrown buffers still read by this task
        self._off = 0

    def reset(self) -> None:
        self._held.clear()
        # graftlint: disable=thread-unsafe-mutation -- a _Staging is per worker (the
        # worker's thread-local _WORKER.staging)
        self._off = 0

    def upload(self, arr: np.ndarray, device: torch.device) -> torch.Tensor:
        nbytes = arr.nbytes
        if self._buf is None or self._off + nbytes > self._buf.numel():
            if self._buf is not None:
                self._held.append(self._buf)
            size = max(1 << 20, 2 * (self._off + nbytes))
            # graftlint: disable=thread-unsafe-mutation -- per-worker _Staging, as above
            self._buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
            observe.mem_track(self._buf, pinned_staging=size)
            # graftlint: disable=thread-unsafe-mutation -- per-worker _Staging, as above
            self._off = 0
        region = self._buf[self._off:self._off + nbytes]
        # graftlint: disable=thread-unsafe-mutation -- per-worker _Staging, as above
        self._off += -(-nbytes // self._ALIGN) * self._ALIGN
        region.numpy()[:] = arr.reshape(-1).view(np.uint8)
        host = region.view(torch.from_numpy(arr[:0].reshape(-1)).dtype).view(arr.shape)
        return host.to(device, non_blocking=True)


_WORKER = threading.local()


class _OverlapPool:
    """The overlap workers: a thread pool whose threads each own one CUDA
    stream per device they launch on and one pinned _Staging on a card
    (the torch form of the JAX package's dispatch-on-a-worker). A task runs
    under its worker's stream, so its uploads, launches (ops.cuda_vote
    launches on the current stream), output event and D2H copy all sit on
    that stream; every stream first waits on its device's `ready` event,
    recorded on the dispatching thread's stream when the pool opens —
    after the genome upload and the cached device tables. A task of the
    round-robin wire enters its target device through _on_device, which
    takes the worker's stream there. On the CPU the tasks just run."""

    def __init__(self, workers: int, device: torch.device, devices=()):
        self.workers = workers
        self.device = _norm_device(device)
        self._ready: dict = {}
        if device.type == "cuda":
            for dev in {self.device, *(_norm_device(d) for d in devices)}:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                self._ready[dev] = ev
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="bsseq-ovl")

    def stream(self, dev: torch.device):
        """This worker thread's stream on `dev`, made on first use and
        ordered after the pool's ready event there."""
        streams = _WORKER.streams
        s = streams.get(dev)
        if s is None:
            s = streams[dev] = torch.cuda.Stream(dev)
            s.wait_event(self._ready[dev])
        return s

    def _run_task(self, fn, args):
        if not self._ready:
            return fn(*args)
        if getattr(_WORKER, "pool", None) is not self:
            _WORKER.pool, _WORKER.streams, _WORKER.staging = self, {}, _Staging()
        stream = self.stream(self.device)
        for s in _WORKER.streams.values():  # a failed task may have left copies in flight
            # graftlint: disable=host-sync -- idle after a task that finished (its
            # fetch waited on the batch's event); it waits only on what a failed
            # task left in flight, before the next task reuses the staging
            s.synchronize()
        _WORKER.staging.reset()
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            return fn(*args)

    def submit(self, fn, *args, batch=None):
        return self._pool.submit(self._run_task, fn, args)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


def _norm_device(dev: torch.device) -> torch.device:
    """A CUDA device with its index ('cuda' is the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """Run the block on `dev` (the round-robin wire's target): on an
    overlap worker under the worker's stream there, else under the
    device's current stream."""
    if dev.type != "cuda":
        yield
        return
    dev = _norm_device(dev)
    pool = getattr(_WORKER, "pool", None)
    with torch.cuda.device(dev):
        if pool is None:
            yield
            return
        with torch.cuda.stream(pool.stream(dev)):
            yield


class _Inline:
    """The batch executor with no workers: a task runs when it is
    submitted, on the dispatch thread, and its future is already done
    (an error it raised surfaces at the retire's join)."""

    workers = 0

    def submit(self, fn, *args, batch=None):
        fut = Future()
        try:
            fut.set_result(fn(*args))
        except Exception as exc:
            fut.set_exception(exc)
        return fut

    def shutdown(self) -> None:
        pass


def _make_overlap_pool(device: torch.device, stats: "StageStats", sharded: bool = False,
                       wire_rr: "_WireRoundRobin | None" = None) -> "_OverlapPool | None":
    """The overlap workers, or None when the stage has none (the CPU, an
    explicit disable, or the sharded mesh route, which launches every
    shard on the mesh's own streams from the dispatching thread). A
    disabled pool is loud: the stage counts 'overlap_pool_disabled' and
    ledgers the reason; an enabled one counts 'overlap_pool_workers'
    ('overlap_pool_enabled'). With the round-robin wire the workers are
    raised to at least its device count, so each device keeps a batch in
    flight ('overlap_rr_composed', 'overlap_pool_composed')."""
    stage = stats.stage
    n = 0 if sharded else _overlap_workers(device)
    if n <= 0:
        stats.metrics.count("overlap_pool_disabled")
        if sharded:
            reason = "sharded mesh path pipelines by device count"
        elif os.environ.get("BSSEQ_TPU_OVERLAP_THREADS") is not None:
            reason = "BSSEQ_TPU_OVERLAP_THREADS explicit disable"
        else:
            reason = "host backend: no device waits to hide"
        observe.emit("overlap_pool_disabled", {"stage": stage, "reason": reason})
        return None
    devices = ()
    if wire_rr is not None:
        n = max(n, len(wire_rr))
        devices = [dev for _slot, dev in wire_rr.slots]
        stats.metrics.count("overlap_rr_composed")
        observe.emit("overlap_pool_composed",
                     {"stage": stage, "workers": n, "devices": len(wire_rr)})
    stats.metrics.count("overlap_pool_workers", n)
    observe.emit("overlap_pool_enabled", {"stage": stage, "workers": n})
    return _OverlapPool(n, device, devices)


def _batch_executor(device: torch.device, stats: "StageStats", hpool, sharded: bool = False,
                    wire_rr: "_WireRoundRobin | None" = None):
    """The one executor a stage's batch tasks run on: the overlap
    workers when there are any, else the host pool `hpool`, else the
    dispatch thread (_Inline). The retire pipeline's depth is its
    workers + 1 (every worker holds one batch, one more sits queued), and
    at least the round-robin's device count (_pipeline_depth)."""
    return _make_overlap_pool(device, stats, sharded, wire_rr) or hpool or _Inline()


def _join_with_watchdog(fut, batch, bi, redispatch, stats: "StageStats", stage: str):
    """Join one batch task, with the stall watchdog when
    BSSEQ_TPU_STALL_TIMEOUT_S is set: a worker that has not produced the
    batch by the deadline is abandoned (a thread wedged in a CUDA call
    cannot be cancelled) and the batch re-run inline
    (`redispatch(batch, bi)`); the abandoned future's result, if it ever
    comes, is discarded, so the batch retires exactly once. Counted
    'batches_stalled' and printed on stderr."""
    timeout = _faultretry.stall_timeout()
    if timeout <= 0:
        return fut.result()
    try:
        return fut.result(timeout=timeout)
    except FutureTimeout:
        fut.cancel()
        stats.metrics.count("batches_stalled")
        observe.event("batch_stall_redispatch", {"stage": stage, "batch": bi,
                                                 "timeout_s": timeout})
        return redispatch(batch, bi)


#: StageStats integer fields the shadow/merge protocol carries
#: (everything a task-side emit may increment; metrics is shared and
#: locked, so it is not shadowed)
_HP_MERGE_FIELDS = ("families", "consensus_out", "skipped_families", "leftover_records",
                    "pad_cells", "used_cells")


def _count_vote_plans(metrics: Metrics, batch, data_size: int = 1,
                      reads_split: int = 1) -> None:
    """Count the deep tiles' work in the seg_vote launches of one
    device-voted molecular batch (the 'vote.' counters of
    cuda_vote.plan_counts, summed over the launches) from the host offsets
    they take: the packed rows, or each mesh shard's; else the padded envelope
    (offsets k * T), its families split over `data_size` data shards or
    its templates over `reads_split` slots (the deep route on a mesh).
    Host arithmetic on the dispatch thread, once per batch; the same on
    the card and on the CPU."""
    w = batch.bases.shape[-1]
    sp, pk = batch.packed_shards, batch.packed
    if sp is not None:
        plans = [(host_segment_offsets(seg, sp.fams_per_shard), seg.shape[0]) for seg in sp.seg]
    elif pk is not None:
        plans = [(host_segment_offsets(pk.seg, pk.num_families), pk.bases.shape[0])]
    else:
        f = -(-batch.bases.shape[0] // data_size)
        t = -(-batch.bases.shape[1] // reads_split)
        plans = [(regular_offsets(f, t), f * t)] * (data_size * reads_split)
    for offsets, n in plans:
        for k, v in cuda_vote.plan_counts(offsets, n, 2, w).items():
            metrics.count(k, v)


def _hp_stats_shadow(stats: "StageStats") -> "StageStats":
    """A per-task StageStats for a batch task: shares the stage's locked
    Metrics but has private integer fields, which merge at the ordered
    retire (_hp_stats_merge) — every count is the same for any
    executor."""
    return StageStats(stage=stats.stage, metrics=stats.metrics)


def _hp_stats_merge(dst: "StageStats", src: "StageStats") -> None:
    """Fold one retired task's shadow counts into the stage stats
    (dispatch thread, batch order)."""
    for name in _HP_MERGE_FIELDS:
        setattr(dst, name, getattr(dst, name) + getattr(src, name))


def _hp_prefetch(items, pool, task_fn, barrier=None, metrics=None):
    """Double-buffered host-pool map: task_fn(item N+1) runs on a worker
    while the caller consumes task_fn(item N)'s result. Results yield in
    input order, and at most one task is in flight: task N+1 is submitted
    only after task N has finished, so `ref_fetch` (a FASTA handle's
    seek + read) never has two callers. The JAX package's _hp_prefetch
    submits task N+1 before it joins task N, so two encodes can overlap
    there (ROADMAP queue 3). `items` is pulled on the caller's thread, so
    record ingest stays on the dispatch thread.

    An item for which `barrier(item)` holds (the serve source's empty sync
    chunk) is not looked past: the pending result and the barrier's own
    (run on the caller's thread) yield before the next item is pulled, so
    a source that waits for its retires (serve.scheduler) is never asked
    for more while one of its chunks sits in the prefetch. The JAX
    package's prefetch pulls past it, and its serve engine does not drain
    with host workers on (ROADMAP queue 3).

    With `metrics`, the caller's waits on a task are timed as 'stall',
    its part 'stall.encode': the dispatch thread blocked on the
    encode-ahead."""
    def join(fut):
        if metrics is None:
            return fut.result()
        with metrics.timed("stall"), metrics.timed("stall.encode"):
            return fut.result()

    pending = None
    try:
        for item in items:
            if barrier is not None and barrier(item):
                if pending is not None:
                    fut, pending = pending, None
                    yield join(fut)
                yield task_fn(item)
                continue
            if pending is None:
                pending = pool.submit(task_fn, item)
                continue
            done = join(pending)
            pending = pool.submit(task_fn, item)
            yield done
        if pending is not None:
            fut, pending = pending, None
            yield join(fut)
    finally:
        if pending is not None:
            pending.cancel()


def _warm_device(params: ConsensusParams, device: torch.device, singleton: bool,
                 mesh=None, stage: str = "") -> None:
    """Build, before any worker starts, what the workers would otherwise
    race to build: the vote kernels' load (ops.cuda_vote), the cached
    log-likelihood table (on every card of the mesh too) and (for the
    singleton host vote) the qual tables on the card. The pool's ready
    event, and each mesh slot's wait on the current stream, then order
    every worker and slot stream after these uploads."""
    if device.type != "cuda":
        return
    from bsseqconsensusreads_tpu_torch.ops import phred

    with _compile_probe(set(), ("load", device.type), stage):
        cuda_vote._load()
        phred.log_table(params.error_rate_post_umi, device)
        if mesh is not None:
            for d, r in mesh.local_slots():
                phred.log_table(params.error_rate_post_umi, mesh.device(d, r))
        if singleton:
            from bsseqconsensusreads_tpu_torch.ops.reconstruct import qual_tables

            qual_tables(params, device)


class _Inflight:
    """One dispatched batch: its device output wire and the CUDA event
    recorded after its last launch (None on the CPU), or the per-shard
    outputs of a sharded mesh launch (parallel.sharding.ShardOutputs)."""

    __slots__ = ("wire", "event")

    def __init__(self, wire):
        self.wire = wire
        self.event = None
        if isinstance(wire, torch.Tensor) and wire.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(wire.device))

    def fetch(self, metrics: Metrics) -> np.ndarray:
        """Wait for the device ('device_wait': the device still owned the
        batch), then copy the wire to the host ('fetch'; its bytes counted
        as 'd2h_bytes'). Shards are waited for and copied one by one and
        concatenated family-major."""
        sharded = not isinstance(self.wire, torch.Tensor)
        with metrics.timed("device_wait"):
            if sharded:
                self.wire.synchronize()
            elif self.event is not None:
                self.event.synchronize()
        with metrics.timed("fetch"):
            host = self.wire.host() if sharded else self.wire.cpu().numpy()
        parts = host if isinstance(host, tuple) else (host,)
        metrics.count("d2h_bytes", sum(a.nbytes for a in parts))
        observe.mem_track_arrays("inflight", *parts)
        return host


def _track_emitted(recs) -> None:
    """Count a batch's emitted record blocks in the host memory account
    ('inflight') until they are collected: past the retire, once the sort
    has copied them into its buffer."""
    for rec in recs:
        if isinstance(rec, RawRecords):
            observe.mem_track(rec, inflight=len(rec.blob))


def _to_device(arr: np.ndarray, device: torch.device, metrics: Metrics) -> torch.Tensor:
    """One H2D copy, timed as 'kernel.h2d' (a part of the dispatch's
    'kernel'), its bytes counted as 'h2d_bytes'. On an overlap
    worker the copy leaves the worker's pinned staging non_blocking on
    its stream (_Staging); elsewhere it is a plain pageable copy."""
    arr = np.ascontiguousarray(arr)
    metrics.count("h2d_bytes", arr.nbytes)
    staging = getattr(_WORKER, "staging", None)
    with metrics.timed("kernel.h2d"):
        if staging is not None and device.type == "cuda" and arr.nbytes:
            return staging.upload(arr, device)
        return torch.from_numpy(arr).to(device)


def _wire_to_device(words: np.ndarray, device: torch.device, metrics: Metrics) -> torch.Tensor:
    """A u32 wire as ONE H2D copy of its bytes (a uint8 view)."""
    return _to_device(np.ascontiguousarray(words, dtype=np.uint32).view(np.uint8), device, metrics)


def _batch_spans(depth):
    """Per-(family, role) covered-span digest of one retired batch: (has,
    first, last, span_mask) — the contiguous [first, last] covered window
    every emitter slices (interior no-call columns included)."""
    pres = np.asarray(depth) > 0
    w = pres.shape[-1]
    has = pres.any(axis=-1)
    first = pres.argmax(axis=-1)
    last = w - 1 - pres[..., ::-1].argmax(axis=-1)
    idx = np.arange(w)
    span = (idx >= first[..., None]) & (idx <= last[..., None])
    return has, first, last, span


def _span_stats(arr, span):
    """(max, min, sum int64) over the covered span per (family, role).
    Rows without coverage return sentinel garbage; callers skip them."""
    a = np.asarray(arr)
    s = np.where(span, a, 0).sum(axis=-1, dtype=np.int64)
    mx = np.where(span, a, np.int32(-(1 << 30))).max(axis=-1)
    mn = np.where(span, a, np.int32(1 << 30)).min(axis=-1)
    return mx, mn, s


def _consensus_tags(depth_arr, err_arr, mi, rx, bcount=None,
                    flip: bool = False, pre=None):
    """The consensus tag block fgbio emits: cD/cM/cE + per-base cd/ce.

    pre: optional (dmax, dmin, dtot, etot) ints precomputed by the
    batch-level _span_stats pass. bcount (uint16 [4, n] or None) adds the
    cB raw base histogram — 4 plane-major runs of per-base counts (A,C,G,T
    order), the duplex stage's input for exact raw-unit errors. flip: the
    record is emitted reverse-complemented — per-base arrays reverse with
    the SEQ and the histogram's base planes complement."""
    depth_arr = np.asarray(depth_arr)
    err_arr = np.asarray(err_arr)
    if flip:
        depth_arr = depth_arr[::-1]
        err_arr = err_arr[::-1]
        if bcount is not None:
            bcount = bcount[::-1, ::-1]  # complement planes + reverse cols
    if pre is not None:
        dmax, dmin, total, errs = pre
    else:
        total = int(depth_arr.sum(dtype=np.int64))
        errs = int(err_arr.sum(dtype=np.int64))
        dmax = int(depth_arr.max()) if depth_arr.size else 0
        dmin = int(depth_arr.min()) if depth_arr.size else 0
    tags = {
        "MI": ("Z", mi),
        "cD": ("i", dmax),
        "cM": ("i", dmin),
        "cE": ("f", errs / total if total else 0.0),
        "cd": ("B", ("S", np.ascontiguousarray(depth_arr))),
        "ce": ("B", ("S", np.ascontiguousarray(err_arr))),
    }
    if bcount is not None:
        flat = np.ascontiguousarray(bcount).reshape(-1)
        # uint8 subtype when every count fits, u16 otherwise
        sub = "C" if (flat.size == 0 or int(flat.max()) < 256) else "S"
        tags["cB"] = ("B", (sub, flat))
    if rx:
        tags["RX"] = ("Z", rx)
    return tags


def _emit_read(
    *,
    qname: str,
    role: int,
    seq_fwd: str,
    quals_fwd: bytes,
    tags: dict,
    mode: str,
    reverse: bool,
    ref_id: int,
    pos: int,
    mate_pos: int,
    mate_reverse: bool,
    tlen: int,
) -> BamRecord:
    """Build one consensus record in either alignment mode."""
    role_flag = FREAD2 if role else FREAD1
    if mode == "self":
        mate_exists = mate_pos >= 0
        flag = FPAIRED | role_flag
        if mate_exists:
            flag |= FPROPER_PAIR
            if mate_reverse:
                flag |= FMREVERSE
        else:
            flag |= FMUNMAP
        if reverse:
            flag |= FREVERSE
        return BamRecord(
            qname=qname,
            flag=flag,
            ref_id=ref_id,
            pos=pos,
            mapq=60,
            cigar=[(CMATCH, len(seq_fwd))],
            next_ref_id=ref_id if mate_exists else -1,
            next_pos=mate_pos if mate_exists else -1,
            tlen=tlen,
            seq=seq_fwd,
            qual=quals_fwd,
            tags=tags,
        )
    seq = _revcomp(seq_fwd) if reverse else seq_fwd
    qual = quals_fwd[::-1] if reverse else quals_fwd
    return BamRecord(
        qname=qname,
        flag=FPAIRED | FUNMAP | FMUNMAP | role_flag,
        ref_id=-1,
        pos=-1,
        mapq=0,
        cigar=[],
        next_ref_id=-1,
        next_pos=-1,
        tlen=0,
        seq=seq,
        qual=qual,
        tags=tags,
    )


def _resolve_kernel_layout(layout: str | None = None) -> str:
    """The molecular stage's vote input layout: the argument, else
    BSSEQ_TPU_KERNEL_LAYOUT, else 'packed' (the JAX package's rule).
    'packed' = segment-packed rows, 'padded' = the [F, T, 2, W] envelope;
    the same bytes either way."""
    choice = layout or os.environ.get("BSSEQ_TPU_KERNEL_LAYOUT", "packed")
    if choice not in ("packed", "padded"):
        raise ValueError(f"unknown kernel layout {choice!r} (want 'packed'|'padded')")
    return choice


def _resolve_emit(emit: str) -> bool:
    """True for the native batch emit. 'auto' and 'native' take it (every
    mode can emit raw records, so nothing sends 'auto' to Python); the
    library is loaded here, so a broken build fails before the stage
    reads a record. 'python' is the BamRecord twin."""
    if emit not in ("auto", "native", "python"):
        raise ValueError(f"unknown emit {emit!r}; use auto|native|python")
    if emit == "python":
        return False
    from bsseqconsensusreads_tpu_torch.io import wirepack

    wirepack.lib()
    return True


TRANSPORTS = ("auto", "wire", "unpacked")


def check_route(transport: str, indel_policy: str = "drop") -> None:
    """The transports and indel policies the port runs: transport 'auto',
    'wire' and 'unpacked' (_resolve_transport), indel policy 'drop' or
    'align'; anything else raises — never a silent substitute."""
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r} (auto | wire | unpacked)")
    if indel_policy not in INDEL_POLICIES:
        raise ValueError(f"unknown indel_policy {indel_policy!r} (drop | align)")


def _resolve_mesh(mesh, device: torch.device):
    """'auto' -> a data mesh over every visible CUDA device when the stage
    runs on the card and more than one is visible, else None (one device;
    the CPU never shards under 'auto'). A parallel.mesh.Mesh or None
    passes through; a mesh must hold devices of the stage's kind — a card
    run never shards onto the CPU, nor a CPU run onto a card."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a Mesh; got {mesh!r}")
        if device.type != "cuda" or torch.cuda.device_count() <= 1:
            return None
        from bsseqconsensusreads_tpu_torch.parallel.mesh import make_mesh

        return make_mesh(n_data=torch.cuda.device_count(), n_reads=1)
    if mesh is not None:
        kinds = {d.type for d, p in zip(mesh.devices.flat, mesh.processes.flat)
                 if d.type != "meta"}
        if kinds != {device.type}:
            raise ValueError(f"a {device.type} stage cannot run on a mesh of {sorted(kinds)}")
    return mesh


def _resolve_transport(transport: str, device: torch.device, mesh=None) -> str:
    """The ONE transport policy of the consensus stages (the JAX
    package's):

    * 'wire'    — one device, the packed wire: an explicit 'wire' off a
                  mesh, or 'auto' on the card;
    * 'wire-mc' — an explicit 'wire' on a mesh: whole batches round-robin
                  over the mesh's slots (_WireRoundRobin);
    * 'off'     — plain unpacked tensors: 'unpacked', 'auto' on the CPU,
                  and 'auto' on a mesh (the sharded route)."""
    check_route(transport)
    if mesh is not None:
        return "wire-mc" if transport == "wire" else "off"
    if transport == "wire" or (transport == "auto" and device.type == "cuda"):
        return "wire"
    return "off"


class _WireRoundRobin:
    """Round-robin whole-batch placement for the wire on a mesh, shared by
    both stages: batch k goes whole to slot k mod n of this process's mesh
    slots. The slot is picked on the dispatching thread, in batch order,
    so a batch's device does not depend on the executor."""

    def __init__(self, mesh):
        self.slots = [(slot, mesh.device(*slot)) for slot in mesh.local_slots()]
        self._i = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.slots)

    def next_slot(self) -> tuple[tuple[int, int], torch.device]:
        with self._lock:
            slot = self.slots[self._i % len(self.slots)]
            self._i += 1
        return slot


def _pipeline_depth(executor, wire_rr: "_WireRoundRobin | None") -> int:
    """Retire-pipeline depth: every worker holds one batch and one more
    sits queued; the round-robin keeps at least one batch per device."""
    return max(executor.workers + 1, len(wire_rr) if wire_rr is not None else 1)


def _emit_raw(batch, out, params, mode, stats, *, n_reads, role_reverse,
              duplex, bcount=None, strand_calls=None, strand_err=None) -> RawRecords:
    """The native batch emit (io.wirepack.emit_consensus_records), timed
    as 'emit.pack' apart from the emit span's tag prologue: one C call
    from output planes to record bytes, byte-identical to the Python
    emitters."""
    from bsseqconsensusreads_tpu_torch.io import wirepack

    with stats.metrics.timed("emit.pack"):
        blob, n, skipped = wirepack.emit_consensus_records(
            out,
            ref_id=[m.ref_id for m in batch.meta],
            window_start=[m.window_start for m in batch.meta],
            n_reads=n_reads,
            role_reverse=role_reverse,
            mi=[m.mi for m in batch.meta],
            rx=[m.rx or "" for m in batch.meta],
            min_reads=params.min_reads,
            mode_self=(mode == "self"),
            duplex=duplex,
            bcount=bcount,
            strand_calls=strand_calls,
            strand_err=strand_err,
        )
    stats.families += len(batch.meta)
    stats.skipped_families += skipped
    stats.consensus_out += n
    return RawRecords(blob, n)


def _emit_molecular_batch_raw(batch, out, params, mode, stats,
                              base_counts: bool = True) -> RawRecords:
    """Native molecular emit: with base_counts, the sparse cB histogram in
    one C sweep (co-call + filter + tally + sparsify —
    io.wirepack.bcount_sparse), timed as 'emit.tags', then the batch
    emit."""
    from bsseqconsensusreads_tpu_torch.io import wirepack

    with stats.metrics.timed("emit.tags"):
        bcount = None
        if base_counts:
            bcount = out.get("bcount")  # the singleton pass tallied it already
            if bcount is not None:
                bcount = sparsify_base_counts(bcount, out["base"])
            else:
                bcount = wirepack.bcount_sparse(batch.bases, batch.quals, out["base"], params)
        n_reads = (batch.bases != NBASE).any(axis=-1).sum(axis=(-2, -1)).astype(np.int32)
        role_reverse = np.array(
            [[int(m.role_reverse[0]), int(m.role_reverse[1])] for m in batch.meta],
            np.uint8,
        )
    return _emit_raw(batch, out, params, mode, stats, n_reads=n_reads,
                     role_reverse=role_reverse, duplex=False, bcount=bcount)


def _emit_duplex_batch_raw(batch, out, params, mode, stats) -> RawRecords:
    """Native duplex emit: the per-strand tag surface aD/bD/aM/bM/ad/bd,
    ac/bc and aE/bE/ae/be where the rawize pass derived them; roles are
    (forward, reverse) by construction."""
    sc = (out["a_call"], out["b_call"]) if "a_call" in out else None
    se = ((out["a_ss_err"], out["b_ss_err"], out["ss_valid"])
          if "a_ss_err" in out else None)
    return _emit_raw(
        batch, out, params, mode, stats,
        n_reads=np.array([m.n_templates for m in batch.meta], np.int32),
        role_reverse=np.tile(np.array([0, 1], np.uint8), (len(batch.meta), 1)),
        duplex=True, strand_calls=sc, strand_err=se,
    )


def _emit_molecular_batch(batch, out, params, mode, stats,
                          base_counts: bool = True) -> list[BamRecord]:
    """Build consensus records (with the sparse cB histogram when
    base_counts) from one molecular output batch."""
    base = np.asarray(out["base"])
    qual = np.asarray(out["qual"])
    depth = np.asarray(out["depth"])
    errors = np.asarray(out["errors"])
    bcounts = None
    if base_counts:
        bcounts = out.get("bcount")  # the singleton pass tallied it already
        if bcounts is None:
            bcounts = molecular_base_counts(batch.bases, batch.quals, params)
        bcounts = sparsify_base_counts(bcounts, out["base"])
    has, first, last, span = _batch_spans(depth)
    dmax, dmin, dtot = _span_stats(depth, span)
    _emx, _emn, etot = _span_stats(errors, span)
    n_reads_fam = (batch.bases != NBASE).any(axis=-1).sum(axis=(-2, -1))
    emitted: list[BamRecord] = []
    for fi, meta in enumerate(batch.meta):
        stats.families += 1
        if int(n_reads_fam[fi]) < params.min_reads:
            stats.skipped_families += 1
            continue
        starts = [
            meta.window_start + int(first[fi, r]) if has[fi, r] else -1
            for r in range(2)
        ]
        for role in range(2):
            if not has[fi, role]:
                continue
            # CONTIGUOUS span [first, last] covered column: interior
            # no-call columns emit as N/qual-2 like fgbio's consensus reads
            sl = slice(int(first[fi, role]), int(last[fi, role]) + 1)
            seq_fwd = codes_to_seq(base[fi, role, sl])
            quals_fwd = qual[fi, role, sl].astype(np.uint8, copy=False).tobytes()
            tags = _consensus_tags(
                depth[fi, role, sl], errors[fi, role, sl], meta.mi, meta.rx,
                bcount=None if bcounts is None else bcounts[fi, role, :, sl],
                flip=mode != "self" and bool(meta.role_reverse[role]),
                pre=(
                    int(dmax[fi, role]), int(dmin[fi, role]),
                    int(dtot[fi, role]), int(etot[fi, role]),
                ),
            )
            other = 1 - role
            tlen = 0
            if starts[0] >= 0 and starts[1] >= 0:
                lo = min(starts)
                hi = max(
                    meta.window_start + int(last[fi, r]) + 1 for r in range(2)
                )
                tlen = (hi - lo) if starts[role] == lo else -(hi - lo)
            emitted.append(_emit_read(
                qname=meta.mi,
                role=role,
                seq_fwd=seq_fwd,
                quals_fwd=quals_fwd,
                tags=tags,
                mode=mode,
                reverse=meta.role_reverse[role],
                ref_id=meta.ref_id,
                pos=starts[role],
                mate_pos=starts[other],
                mate_reverse=meta.role_reverse[other],
                tlen=tlen,
            ))
            stats.consensus_out += 1
    return emitted


def call_molecular_batches(
    records: Iterable[BamRecord],
    params: ConsensusParams = ConsensusParams(min_reads=1),
    mode: str = "unaligned",
    batch_families: int = 512,
    max_window: int = 4096,
    grouping: str = "gather",
    stats: StageStats | None = None,
    batching: str = "bucketed",
    layout: str | None = None,
    device=None,
    emit: str = "python",
    skip_batches: int = 0,
    indel_policy: str = "drop",
    transport: str = "auto",
    base_counts: bool = True,
    deep_threshold: int | None = None,
    guard=None,
    mesh="auto",
) -> Iterator[list]:
    """Molecular (single-strand) consensus over MI families, one list of
    consensus records per batch — the checkpoint/resume granularity
    (pipeline.checkpoint): batching is deterministic given identical input
    and parameters, so skip_batches replays the stream past the first
    skip_batches chunks (counted after bucketing, empty ones included)
    without encoding or launching anything for them.

    records: BamRecords, or a pipeline.ingest.GroupedColumnarStream
    (pipeline.stages.molecular_ingest_stream) whose families carry the C
    encode scan. emit: 'python' yields lists of BamRecord; 'native' and
    'auto' yield one io.bam.RawRecords block per batch (the C batch emit,
    byte-identical records). Writers take both (io.bam.write_items).

    batching: 'bucketed' (default) groups families into depth-homogeneous
    chunks per template bucket; 'sequential' chunks in input order.
    layout: 'packed' votes segment-packed rows (ops.encode
    .pack_molecular_rows — one seg_vote launch with ragged offsets),
    'padded' the [F, T, 2, W] envelope (offsets k * T); identical output.
    None takes BSSEQ_TPU_KERNEL_LAYOUT, else 'packed' (_resolve_kernel_layout).
    T == 1 batches (the cfDNA majority) take the singleton host path
    (models.molecular.singleton_consensus_host), timed as 'host_vote',
    unless BSSEQ_TPU_SINGLETON=0 sends them to the device too.

    base_counts: every record carries the cB raw base histogram tag — the
    duplex stage's input for exact raw-unit errors (disable to shave tag
    bytes when no duplex stage follows). min_reads filters whole families
    by raw read count.

    transport: 'wire' packs each device batch into ONE u32 array — the
    packed-rows wire v2 under layout 'packed' (ops.wire
    .pack_molecular_rows_wire), the v1 envelope wire under 'padded';
    'unpacked' copies the tensors; both fetch the same output planes;
    'auto' is the wire on the card, unpacked on the CPU
    (_resolve_transport). Same bytes on every route; device-issued
    batches count as 'route_batches_<route>' (single, wire, sharded,
    wire_mc). device: 'cuda' (default) or 'cpu'; no silent fallback.

    indel_policy: 'drop' (the reference's: indel reads never vote) or
    'align' (they are banded-aligned into their family's window in the
    encode — ops.encode._align_pending, its DP on `device` — and vote;
    counted in stats.indel_aligned / indel_dropped, the latter the reads
    the aligner refused). Indel reads count as kept templates for the
    batcher and the deep splitter under 'align'.

    mesh: 'auto' (default: every visible card when the stage runs on the
    card and there is more than one, else one device — _resolve_mesh),
    None (one device) or a parallel.mesh.Mesh. On a mesh the family axis
    shards over its data axis (parallel.sharding: the packed rows split at
    family boundaries, ops.encode.shard_packed_rows, or the padded
    envelope), each shard launching the single-device vote on its own
    device and stream, the outputs fetched shard by shard; T == 1 batches
    go to the mesh too (no host vote), as in the JAX package. An explicit
    'wire' on a mesh round-robins whole batches over the mesh's slots
    instead (_WireRoundRobin). Same bytes on every route.

    Families deeper than deep_threshold kept templates (default: encode's
    MAX_TEMPLATES) take the deep-family route, as in the JAX package:
    bucketed by template count (_bucket_deep), encoded with max_templates
    DEEP_TEMPLATE_CAP and voted as padded [K, T, 2, W] dispatches — on one
    device models.molecular.molecular_consensus (seg_vote over offsets
    k * T), on a mesh the template axis split over all its slots
    (parallel.deep_family: seg_vote's partials mode per slot, the sums
    added in rank order and finalized by vote_finalize; a qual may differ
    by one from one device) — their records emitted after their chunk's
    normal batch. 'deep_routed_families' counts them; only families beyond
    DEEP_TEMPLATE_CAP are skipped, counted in skipped_families and
    'deep_skipped_families'.
    """
    device = resolve_device(device)
    check_route(transport, indel_policy)
    if deep_threshold is None:
        deep_threshold = MAX_TEMPLATES
    mesh = _resolve_mesh(mesh, device)
    wire_mode = _resolve_transport(transport, device, mesh)
    use_wire = wire_mode != "off"
    wire_rr = _WireRoundRobin(mesh) if wire_mode == "wire-mc" else None
    sharded = mesh is not None and wire_rr is None
    route = "sharded" if sharded else "wire_mc" if wire_rr else "wire" if use_wire else "single"
    deep_fn = None
    if mesh is not None:
        data_size = len(mesh.local_data())
        outwire_fn = _sharding.sharded_molecular_outwire(mesh, params)
        slots = [mesh.device(*slot) for slot in mesh.local_slots()]
        deep_fn = deep_family_consensus(
            make_mesh(n_data=1, n_reads=len(slots), devices=slots), params)
    layout = _resolve_kernel_layout(layout)
    singleton_on = os.environ.get("BSSEQ_TPU_SINGLETON", "1") != "0"
    native_emit = _resolve_emit(emit)
    emit_fn = partial(
        _emit_molecular_batch_raw if native_emit else _emit_molecular_batch,
        base_counts=base_counts,
    )
    stats = stats if stats is not None else StageStats(stage="molecular")
    stats.metrics.count("deep_skipped_families", 0)  # reported even when 0
    t0 = time.monotonic()
    metrics = stats.metrics
    stage_label = stats.stage or "molecular"
    observe.mem_sample(metrics, "start")
    #: batch shapes already dispatched once — _compile_probe bookkeeping
    compile_shapes: set = set()

    def dispatch_wire(batch, dev):
        """The input wire packed (the C sweep on the native engine), one
        H2D copy, the unpack and vote on `dev`; returns (in-flight output
        wire, padded f)."""
        pk = batch.packed
        w = batch.bases.shape[-1]
        if pk is not None:
            with metrics.timed("kernel.pack"):
                words, qmode = pack_molecular_rows_wire(
                    pk.bases, pk.quals, pk.seg, pk.num_families, pk.n_real_rows,
                    qual_mode="auto", native=native_emit,
                )
            wire = molecular_wire_packed_kernel(
                _wire_to_device(words, dev, metrics), pk.bases.shape[0],
                pk.num_families, w, params, qual_mode=qmode,
                host_offsets=host_segment_offsets(pk.seg, pk.num_families),
            )
            pf = pk.num_families
        else:
            f, t = batch.bases.shape[:2]
            with metrics.timed("kernel.pack"):
                # graftlint: disable=padded-envelope-dispatch -- the sanctioned
                # layout='padded' wire: pk is None here
                win = pack_molecular_inputs(batch.bases, batch.quals, qual_mode="auto",
                                            native=native_emit)
                words = win.to_words()
            qmode = win.qual_mode
            wire = molecular_wire_kernel(
                _wire_to_device(words, dev, metrics), f, t, w, params,
                qual_mode=qmode,
            )
            pf = f
        metrics.count(f"wire_qual_{qmode}")
        return _Inflight(wire), pf

    def dispatch_sharded(batch):
        """The batch over the mesh's data shards: the packed row plan
        (sharded_molecular_rows) or the padded envelope
        (sharded_molecular_outwire), each shard on its own stream; returns
        (in-flight shard outputs, padded f)."""
        sp = batch.packed_shards
        if sp is not None:
            arrays = (sp.bases, sp.quals, sp.seg)
            fn, pf = _sharding.sharded_molecular_rows(mesh, sp.fams_per_shard, params), \
                sp.total_families
        else:
            f = batch.bases.shape[0]
            # graftlint: disable=padded-envelope-dispatch -- the sanctioned
            # layout='padded' sharded envelope fallback
            arrays, pf = pad_families((batch.bases, batch.quals), f, data_size)
            fn = outwire_fn
        metrics.count("h2d_bytes", sum(a.nbytes for a in arrays))
        if sp is not None:  # each shard's host offsets, for seg_vote's deep plan
            arrays += (_sharding.HostArray(np.stack(
                [host_segment_offsets(seg, sp.fams_per_shard) for seg in sp.seg])),)
        return _Inflight(fn.launch(*arrays)), pf

    def dispatch(batch, wire):
        """H2D copies + the vote launch; returns (in-flight wire, padded
        f). On the round-robin wire the batch goes to its `slot`."""
        if sharded:
            return dispatch_sharded(batch)
        if batch.slot is not None:
            (d, r), dev = batch.slot
            with _on_device(dev), cuda_vote.launch_tag(f"{d},{r}"):
                return dispatch_wire(batch, dev)
        if wire:
            return dispatch_wire(batch, device)
        pk = batch.packed
        if pk is not None:
            out = molecular_consensus_packed(
                _to_device(pk.bases, device, metrics), _to_device(pk.quals, device, metrics),
                _to_device(pk.seg, device, metrics), pk.num_families, params,
                host_offsets=host_segment_offsets(pk.seg, pk.num_families),
            )
            pf = pk.num_families
        else:
            out = molecular_consensus(
                _to_device(batch.bases, device, metrics),
                _to_device(batch.quals, device, metrics), params,
            )
            pf = batch.bases.shape[0]
        return _Inflight(pack_molecular_outputs(out)), pf

    def singleton_vote(batch):
        # the Python emit reuses this pass's cB tally; the native emit
        # builds the sparse histogram in one C sweep
        return singleton_consensus_host(
            batch.bases, batch.quals, params, device,
            with_histogram=base_counts and not native_emit,
        )

    def host_voted(batch) -> bool:
        """T == 1 batches vote on the host, off a mesh (the JAX package's
        rule: the mesh routes take them to the device), unless
        BSSEQ_TPU_SINGLETON=0."""
        return batch.bases.shape[1] == 1 and mesh is None and singleton_on

    def dispatch_fetch(batch, bi=None, armed=True) -> dict:
        """The recovery unit: dispatch and the blocking fetch of one batch
        (a T == 1 batch votes on the host off a mesh), host arrays out. A
        retry, a stall re-run and the degrade re-run exactly this, never a
        half-retired batch; `armed=False` (the degrade) passes the
        failpoint sites by."""
        singleton = host_voted(batch)
        phase = "host_vote" if singleton else "kernel"
        with _compile_probe(compile_shapes, (phase, *batch.bases.shape), stage_label), \
                metrics.timed(phase):
            if armed:
                _failpoints.fire("dispatch_kernel", stage=stage_label, batch=bi)
            if singleton:
                inflight, out = None, singleton_vote(batch)
            else:
                inflight, pf = dispatch(batch, use_wire)
        if armed:
            _failpoints.fire("fetch_out", stage=stage_label, batch=bi)
        if inflight is None:
            return out
        f, w = batch.bases.shape[0], batch.bases.shape[-1]
        host = inflight.fetch(metrics)
        with metrics.timed("fetch"):
            out = unpack_molecular_outputs(host, f=pf, w=w)
        return {k: v[:f] for k, v in out.items()}

    def degrade_fetch(batch) -> dict:
        """A batch whose retries ran out: its unit once more on the
        stage's own device (or mesh) with the failpoints bypassed — the
        card's kernels on a card run (never the CPU), the plain PyTorch
        version on a CPU run; an error here propagates. Counted
        ('batches_degraded') and printed by faults.retry; timed as
        'degrade'."""
        with metrics.timed("degrade"):
            return dispatch_fetch(batch, armed=False)

    def dispatch_fetch_guarded(batch, bi):
        """dispatch_fetch under the bounded retrier with the degrade."""
        return _faultretry.guarded(
            partial(dispatch_fetch, batch, bi),
            degrade=partial(degrade_fetch, batch),
            metrics=metrics, stage=stage_label, batch=bi,
        )

    def recover_fetch(batch, bi, exc):
        """Re-run the whole dispatch+fetch unit under the retrier after
        `exc` — the retire's recovery."""
        return _faultretry.guarded(
            partial(dispatch_fetch, batch, bi),
            degrade=partial(degrade_fetch, batch),
            metrics=metrics, stage=stage_label, batch=bi, failed=exc,
        )

    def emit_out(out, batch, deep_emitted, st=None):
        """Record emit for one retired batch against `st`: the stage stats
        by default, a task's shadow (_hp_stats_shadow) in a batch task."""
        st = stats if st is None else st
        with metrics.timed("emit"):
            recs = emit_fn(batch, out, params, mode, st)
        recs = [recs] if isinstance(recs, RawRecords) else recs
        _track_emitted(recs)
        return recs + list(deep_emitted)

    def batch_task(batch, bi, deep_emitted):
        """One batch on the stage's executor: the guarded unit, then the
        record emit against a shadow stats."""
        with observe.bind_batch(bi, stage_label):
            shadow = _hp_stats_shadow(stats)
            out = dispatch_fetch_guarded(batch, bi)
            return emit_out(out, batch, deep_emitted, shadow), shadow

    def retire(fut, batch, bi, deep_emitted):
        """The ordered retire of one batch task on the dispatch thread:
        'stall' is the seconds it blocked on the task (its part
        'stall.batch'); the watchdog abandons a wedged task and re-runs
        the batch inline; a task that failed re-runs its unit under the
        retrier; the shadow counts merge here, in batch order."""
        with observe.bind_batch(bi, stage_label):
            try:
                _failpoints.fire("retire_future", stage=stage_label, batch=bi)
                with metrics.timed("stall"), metrics.timed("stall.batch"):
                    emitted, shadow = _join_with_watchdog(
                        fut, batch, bi, lambda b, i: batch_task(b, i, deep_emitted), stats,
                        stage_label,
                    )
            except _faultretry.RETRYABLE as exc:
                shadow = _hp_stats_shadow(stats)
                emitted = emit_out(recover_fetch(batch, bi, exc), batch, deep_emitted, shadow)
            _hp_stats_merge(stats, shadow)
            observe.mem_sample(metrics, "retire")
        observe.batch_close(bi, stage_label)
        return emitted

    def deep_records(deep) -> list:
        """Vote and emit one chunk's deep families on the dispatch thread:
        one padded dispatch per _bucket_deep group, retired at once (deep
        families are rare)."""
        emitted: list = []
        n_over = sum(1 for _g, depth in deep if depth > DEEP_TEMPLATE_CAP)
        metrics.count("deep_routed_families", len(deep))
        metrics.count("deep_skipped_families", n_over)
        for group in _bucket_deep(deep):
            with metrics.timed("encode"):
                dbatch, dskipped = encode_molecular_families(
                    group, max_window=max_window, max_templates=DEEP_TEMPLATE_CAP,
                    indel_policy=indel_policy, device=device,
                )
            stats.skipped_families += len(dskipped)
            stats.indel_aligned += dbatch.indel_aligned
            stats.indel_dropped += dbatch.indel_dropped
            if not dbatch.meta:
                continue
            stats.batches += 1
            used = int((dbatch.bases != NBASE).sum())
            stats.pad_cells += dbatch.bases.size - used
            stats.used_cells += used
            _count_vote_plans(metrics, dbatch,
                              reads_split=1 if deep_fn is None else deep_fn.mesh.shape["reads"])
            with metrics.timed("kernel"):
                if deep_fn is None:
                    inflight, _pf = dispatch(dbatch, False)
                else:  # the template axis over the mesh's slots
                    inflight = _Inflight(pack_molecular_outputs(deep_fn(*_pad_templates(
                        dbatch.bases, dbatch.quals, deep_fn.mesh.shape["reads"]))))
            f, w = dbatch.bases.shape[0], dbatch.bases.shape[-1]
            host = inflight.fetch(metrics)
            with metrics.timed("fetch"):
                out = unpack_molecular_outputs(host, f=f, w=w)
            emitted.extend(emit_out(out, dbatch, ()))
        return emitted

    # the time spent pulling groups (record decode + MI grouping) is
    # 'ingest', booked once per chunk (numbered_chunks), not per family
    groups = metrics.pulls(
        _guard_mod.guard_groups(
            stream_mi_groups(records, grouping=grouping, stats=stats), guard
        ),
        "ingest",
    )
    if batching == "bucketed":
        chunks = _group_batches_bucketed(groups, batch_families, indel_policy)
    elif batching == "sequential":
        chunks = _group_batches(groups, batch_families)
    else:
        raise ValueError(
            f"unknown batching {batching!r} (want 'bucketed'|'sequential')"
        )

    def encode_chunk(item):
        """Pure-host encode (and segment pack) of one chunk — a host-pool
        task when the pool is on (double-buffered by _hp_prefetch, so
        chunk N+1 encodes while batch N dispatches and retires). All
        stat counts apply on the dispatch thread, in batch order."""
        bi, chunk = item
        normal, deep = _split_deep(chunk, deep_threshold, indel_policy)
        with observe.bind_batch(bi, stage_label), metrics.timed("encode"):
            # the cap tracks the routing threshold: a family the splitter
            # called normal must never hit encode's cap
            batch, skipped = encode_molecular_families(
                normal, max_window=max_window,
                max_templates=min(deep_threshold, DEEP_TEMPLATE_CAP),
                indel_policy=indel_policy, device=device,
            )
            if layout == "packed" and batch.meta and not host_voted(batch):
                batch.packed = pack_molecular_rows(batch)
                if sharded:  # the mesh's shard plan is host work too
                    batch.packed_shards = shard_packed_rows(batch.packed, data_size)
        return bi, batch, skipped, deep

    def numbered_chunks():
        try:
            for batch_index, chunk in enumerate(chunks, start=1):
                groups.book()
                if batch_index <= skip_batches:
                    # resume replay: skipped batches never encode at all
                    continue
                observe.batch_open(batch_index, stage_label)
                yield batch_index, chunk
        finally:
            groups.book()

    def events():
        encoded = (
            _hp_prefetch(numbered_chunks(), hpool, encode_chunk, barrier=lambda it: not it[1],
                         metrics=metrics)
            if hpool is not None else map(encode_chunk, numbered_chunks())
        )
        for batch_index, batch, skipped, deep in encoded:
            observe.mem_track_arrays("inflight", batch)
            stats.skipped_families += len(skipped)
            stats.indel_aligned += batch.indel_aligned
            stats.indel_dropped += batch.indel_dropped
            deep_emitted = []
            if deep:
                with observe.bind_batch(batch_index, stage_label):
                    deep_emitted = deep_records(deep)
            if not batch.meta:
                observe.batch_close(batch_index, stage_label)
                yield "now", deep_emitted
                continue
            stats.batches += 1
            if not host_voted(batch):
                issued = (batch.packed_shards or batch.packed or batch).bases
                used = int((issued != NBASE).sum())
                stats.pad_cells += issued.size - used
                stats.used_cells += used
                _count_vote_plans(metrics, batch, data_size if sharded else 1)
                metrics.count(f"route_batches_{route}")
                if wire_rr is not None:
                    batch.slot = wire_rr.next_slot()
            fut = executor.submit(batch_task, batch, batch_index, deep_emitted,
                                  batch=batch_index)
            yield "deferred", partial(retire, fut, batch, batch_index, deep_emitted)

    _warm_device(params, device, singleton=singleton_on, mesh=mesh, stage=stage_label)
    hpool = _hostpool.make_pool(metrics, stage_label)
    executor = _batch_executor(device, stats, hpool, sharded, wire_rr)
    try:
        yield from _pipelined(events(), depth=_pipeline_depth(executor, wire_rr))
    finally:
        executor.shutdown()
        if hpool is not None:
            hpool.shutdown()
    stats.wall_seconds += time.monotonic() - t0
    compilecache.publish(stats.metrics)


def _duplex_sidecar(chunk, pos0: str = "skip") -> dict:
    """Raw per-strand depth/error arrays for the duplex emitters.

    The duplex stage's input records are molecular consensus reads whose
    cd/ce tags carry RAW per-read depths/errors — what fgbio's duplex
    caller reports in ad/bd/cd. Capture them per family BEFORE encode
    consumes the records: {mi: [{row: (pos, cd, ce, cb)}, ...]} — one dict
    per chunk occurrence of the MI — with row = DUPLEX_ROW_OF_FLAG and
    arrays softclip-trimmed into the register the encoder places (incl.
    the pos0='shift' one-column displacement). Records without cd/ce are
    absent; the emitters fall back to presence units there.
    """
    side: dict = {}
    for mi, records in chunk:
        rows: dict = {}
        for rec in records:
            row = DUPLEX_ROW_OF_FLAG.get(rec.flag)
            if row is None or row in rows:
                continue
            # columnar views: one aux decode and the C CIGAR digest
            aux_fn = getattr(rec, "consensus_aux", None)
            if aux_fn is not None:
                trip = aux_fn()
                if trip is None:
                    continue
                cd, ce, cbflat = trip
                lead, trail, _indel, hard = rec.clip_info
                if hard:
                    continue
            else:
                try:
                    _sub, cd = rec.get_tag("cd")
                    _sub, ce = rec.get_tag("ce")
                except (KeyError, TypeError, ValueError):
                    continue
                # uint16, as the native decoder's aux planes: the native
                # rawize assembles its flat buffer with one concatenate
                cd = np.asarray(cd, dtype=np.uint16)
                ce = np.asarray(ce, dtype=np.uint16)
                cbflat = None
                try:
                    _sub, cbv = rec.get_tag("cB")
                    cbflat = np.asarray(cbv, dtype=np.uint16)
                except (KeyError, TypeError, ValueError):
                    pass
                cigar = rec.cigar
                if any(op == CHARD_CLIP for op, _ in cigar):
                    continue
                lead = cigar[0][1] if cigar and cigar[0][0] == CSOFT_CLIP else 0
                trail = (
                    cigar[-1][1]
                    if len(cigar) > 1 and cigar[-1][0] == CSOFT_CLIP
                    else 0
                )
            n = len(cd)
            if len(ce) != n or n <= lead + trail:
                continue
            pos = rec.pos
            if pos0 == "shift" and pos == 0 and row in CONVERT_ROWS:
                pos = 1  # mirror the encoder's register-shift placement
            end = n - trail
            # cB raw base DISSENT histogram (4 plane-major runs, call plane
            # zero): the exact-ce input; absent/malformed -> None
            cb = None
            if cbflat is not None and cbflat.size == 4 * n:
                cb = cbflat.reshape(4, n)[:, lead:end]
            rows[row] = (pos, cd[lead:end], ce[lead:end], cb)
        if rows:
            side.setdefault(mi, []).append(rows)
    return side


def _place_raw(entry, presence, window_start, w):
    """One strand's raw per-base array into window space [w], masked and
    edge-filled against the kernel's presence plane: columns the kernel
    says the strand covered but the raw array does not (the conversion
    prepend / extend-gap boundary columns) take the nearest raw value."""
    pos, arr = entry
    out = np.zeros(w, dtype=np.int32)
    off = pos - window_start
    lo, hi = max(off, 0), min(off + len(arr), w)
    if hi > lo:
        out[lo:hi] = arr[lo - off : hi - off]
    halo = presence & (out == 0)
    if halo.any() and hi > lo:
        idx = np.nonzero(halo)[0]
        out[idx] = out[np.clip(idx, lo, hi - 1)]
    return np.where(presence, out, 0)


def _sidecar_rows_for(meta, sidecar: dict, w: int):
    """The sidecar occurrence whose reads intersect this meta's window."""
    for cand in sidecar.get(meta.mi, ()):
        if any(
            pos < meta.window_start + w and pos + len(cd) > meta.window_start
            for pos, cd, *_rest in cand.values()
        ):
            return cand
    return None


def _duplex_rawize(out: dict, batch, sidecar: dict, ref, native: bool = False,
                   strand_tags: bool = True) -> dict:
    """Raw-unit + strand-call enrichment of one retired duplex batch, on
    the host (the JAX package's _duplex_rawize; ref is the batch's
    [F, W+1] reference windows). native: passes 1 and 2 run as C sweeps
    (io.wirepack.strand_calls, io.wirepack.duplex_rawize) instead of the
    numpy twins — same planes.

    1. STRAND CALLS: per-strand consensus call planes from the host twin
       of the convert/extend transforms (ops.hosttwin.strand_call_planes).
       With strand_tags they become a_call/b_call [F, 2, W], masked by the
       kernel's per-strand presence bits — the ac/bc tags; without, they
       are computed only when pass 3 needs them.
    2. RAW DEPTHS: ad/bd become raw per-read strand depths wherever the
       sidecar carries the molecular cd arrays, cd their sum; a_err/b_err
       hold raw-unit per-strand error counts (err-bit split rule).
    3. EXACT ERRORS: wherever the sidecar also carries the molecular cB
       histogram, per-strand errors are recomputed exactly against the
       DUPLEX call (_exact_strand_errors).

    Families absent from the sidecar keep presence units; rows without
    cB keep the err-bit rule."""
    f, _, w = np.asarray(out["a_depth"]).shape
    a_pres = np.asarray(out["a_depth"]) > 0
    b_pres = np.asarray(out["b_depth"]) > 0
    a_errbit = np.asarray(out["a_err"]) > 0
    b_errbit = np.asarray(out["b_err"]) > 0
    need_exact = bool(sidecar) and any(
        entry[3] is not None
        for occs in sidecar.values() for rows in occs for entry in rows.values()
    )
    calls = None
    if strand_tags or need_exact:
        if native:
            from bsseqconsensusreads_tpu_torch.io import wirepack

            calls = wirepack.strand_calls(
                batch.bases, batch.cover, ref, batch.convert_mask, batch.extend_eligible,
            )
        else:
            calls, _ccov = hosttwin.strand_call_planes(
                batch.bases, batch.cover, ref, batch.convert_mask, batch.extend_eligible,
            )
    out = dict(out)
    if strand_tags:
        rows_a = [p[0] for p in ROLE_STRAND_ROWS]
        rows_b = [p[1] for p in ROLE_STRAND_ROWS]
        out["a_call"] = np.where(a_pres, calls[:, rows_a, :], np.int8(NBASE)).astype(np.int8)
        out["b_call"] = np.where(b_pres, calls[:, rows_b, :], np.int8(NBASE)).astype(np.int8)
    if not sidecar:
        return out

    ex_has = np.zeros((f, 4), bool)
    raw_rows = np.zeros((f, 4), bool)  # rows with sidecar cd (raw units)
    ex_fi: list[int] = []
    ex_row: list[int] = []
    ex_off: list[int] = []
    ex_cbs: list[np.ndarray] = []

    def collect_exact(fi, row, pos, wstart, cb) -> None:
        raw_rows[fi, row] = True
        if cb is None:
            return
        ex_has[fi, row] = True
        ex_fi.append(fi)
        ex_row.append(row)
        ex_off.append(pos - wstart)
        ex_cbs.append(cb)

    if native:
        raw = _rawize_native(out, batch, sidecar, w, collect_exact)
    else:
        raw = _rawize_numpy(out, batch, sidecar, w, collect_exact)
    # fgbio's ae/be tag surface: per-base STRAND-consensus error counts
    # (raw reads disagreeing with the strand's OWN call), computed BEFORE
    # the exact pass overwrites a_err/b_err. ss_valid gates emission per
    # (family, role): a COVERED strand without sidecar cd has no raw error
    # information, and the tags are omitted there.
    for pk, ek, eb in (
        ("a_depth", "a_err", a_errbit), ("b_depth", "b_err", b_errbit)
    ):
        ad_p = np.asarray(raw[pk]).astype(np.int32)
        ae_p = np.asarray(raw[ek]).astype(np.int32)
        raw["a_ss_err" if pk[0] == "a" else "b_ss_err"] = np.clip(
            np.where(eb, ad_p - ae_p, ae_p), 0, None
        ).astype(np.int16)
    ss_valid = np.zeros((f, 2), bool)
    for role, (a_row, b_row) in enumerate(ROLE_STRAND_ROWS):
        a_any = a_pres[:, role, :].any(axis=1)
        b_any = b_pres[:, role, :].any(axis=1)
        ss_valid[:, role] = (raw_rows[:, a_row] | ~a_any) & (
            raw_rows[:, b_row] | ~b_any
        )
    raw["ss_valid"] = ss_valid
    if ex_has.any():
        raw = _exact_strand_errors(
            raw, batch, (a_pres, b_pres), calls, ref,
            w, ex_has, ex_fi, ex_row, ex_off, ex_cbs,
        )
    return raw


def _rawize_numpy(out: dict, batch, sidecar: dict, w: int, collect_exact) -> dict:
    """Pass 2 of _duplex_rawize in numpy: each sidecar row's raw cd/ce
    placed into window space against the kernel's presence planes."""
    a_e = np.asarray(out["a_err"])
    b_e = np.asarray(out["b_err"])
    ad = (np.asarray(out["a_depth"]) > 0).astype(np.int32)
    bd = (np.asarray(out["b_depth"]) > 0).astype(np.int32)
    ae = a_e.astype(np.int32).copy()
    be = b_e.astype(np.int32).copy()
    for fi, meta in enumerate(batch.meta):
        rows = _sidecar_rows_for(meta, sidecar, w)
        if not rows:
            continue
        for role in range(2):
            a_row, b_row = ROLE_STRAND_ROWS[role]
            for row, dplane, eplane, errbit in (
                (a_row, ad, ae, a_e), (b_row, bd, be, b_e),
            ):
                entry = rows.get(row)
                if entry is None:
                    continue
                collect_exact(fi, row, entry[0], meta.window_start, entry[3])
                pres = dplane[fi, role] > 0
                raw_d = _place_raw(entry[:2], pres, meta.window_start, w)
                raw_e = _place_raw((entry[0], entry[2]), pres, meta.window_start, w)
                # strand disagrees with the duplex call -> its agreeing raw
                # reads are the errors (rows with cB are recomputed below)
                disagree = errbit[fi, role] > 0
                dplane[fi, role] = raw_d
                eplane[fi, role] = np.clip(
                    np.where(disagree, raw_d - raw_e, raw_e), 0, None
                )
    raw = dict(out)
    raw["a_depth"], raw["b_depth"] = ad.astype(np.int16), bd.astype(np.int16)
    raw["a_err"], raw["b_err"] = ae.astype(np.int16), be.astype(np.int16)
    raw["depth"] = (ad + bd).astype(np.int16)
    raw["errors"] = (ae + be).astype(np.int16)
    return raw


def _rawize_native(out: dict, batch, sidecar: dict, w: int, collect_exact) -> dict:
    """Pass 2 of _duplex_rawize as one C sweep (io.wirepack.duplex_rawize):
    the sidecar rows flattened into one cd/ce buffer with per-(family,
    row) position, offset and length."""
    from bsseqconsensusreads_tpu_torch.io import wirepack

    f = len(batch.meta)
    row_pos = np.full(f * 4, -1, np.int64)
    row_off = np.zeros(f * 4, np.int64)
    row_len = np.zeros(f * 4, np.int32)
    window_start = np.empty(f, np.int64)
    chunks: list[np.ndarray] = []
    cursor = 0
    for fi, meta in enumerate(batch.meta):
        window_start[fi] = meta.window_start
        rows = _sidecar_rows_for(meta, sidecar, w)
        if not rows:
            continue
        for row, (pos, cd, ce, cb) in rows.items():
            k = fi * 4 + row
            row_pos[k] = pos
            row_off[k] = cursor
            row_len[k] = len(cd)
            chunks.append(cd)
            chunks.append(ce)
            cursor += 2 * len(cd)
            collect_exact(fi, row, pos, meta.window_start, cb)
    aux = np.concatenate(chunks) if chunks else np.zeros(0, np.uint16)
    role_rows = np.asarray([r for pair in ROLE_STRAND_ROWS for r in pair], np.int32)
    return wirepack.duplex_rawize(out, row_pos, row_off, row_len, aux, window_start, role_rows)


def _exact_strand_errors(out: dict, batch, presence, calls, ref,
                         w: int, has, e_fi, e_row, e_off, cbs) -> dict:
    """Pass 3 of _duplex_rawize: exact per-strand raw error counts.

    For every sidecar row carrying the molecular cB DISSENT histogram, per
    column: ae = ad - cnt_match, where cnt_match = [strand's converted call
    == duplex call] * (ad - placed_ce) + the dissent cells whose
    conversion-mapped base (ops.hosttwin.convert_cell) equals the duplex
    call."""
    base = np.asarray(out["base"])
    f = base.shape[0]
    bases_raw = np.asarray(batch.bases)
    cover_raw = np.asarray(batch.cover)
    cmask = np.asarray(batch.convert_mask, bool)
    ref = np.asarray(ref)
    dissent = np.zeros((f, 4, w), np.int32)
    cb_all = (
        np.concatenate(cbs, axis=1) if cbs else np.zeros((4, 0), np.uint16)
    )
    pl_nz, el_nz = np.nonzero(cb_all)  # dissent cells are sparse
    if len(pl_nz):
        lens = np.fromiter((cb.shape[1] for cb in cbs), np.int64, len(cbs))
        cum = np.cumsum(lens)
        ent = np.searchsorted(cum, el_nz, side="right")
        fi_e = np.asarray(e_fi, dtype=np.int64)[ent]
        row_e = np.asarray(e_row, dtype=np.int64)[ent]
        col_e = np.asarray(e_off, dtype=np.int64)[ent] + (
            el_nz - (cum - lens)[ent]
        )
        x_e = pl_nz.astype(np.int8)
        v_e = cb_all[pl_nz, el_nz].astype(np.int32)
        inw = (col_e >= 0) & (col_e < w)
        fi_e, row_e, col_e = fi_e[inw], row_e[inw], col_e[inw]
        x_e, v_e = x_e[inw], v_e[inw]
        act = cmask[fi_e, row_e]
        refc = ref[fi_e, col_e]
        refn = ref[fi_e, col_e + 1]  # ref is [F, W+1]
        nxt_ok = col_e + 1 < w
        safe_n = np.minimum(col_e + 1, w - 1)
        nxt = np.where(nxt_ok, bases_raw[fi_e, row_e, safe_n], NBASE)
        nxtcov = np.where(nxt_ok, cover_raw[fi_e, row_e, safe_n], False)
        m = hosttwin.convert_cell(x_e, act, refc, refn, nxt, nxtcov)
        role_of_row = np.empty(4, np.int64)
        for role, (ar, br) in enumerate(ROLE_STRAND_ROWS):
            role_of_row[ar] = role
            role_of_row[br] = role
        role_e = role_of_row[row_e]
        callv = base[fi_e, role_e, col_e]
        match = (m == callv) & (callv != NBASE)
        np.add.at(
            dissent,
            (fi_e[match], row_e[match], col_e[match]),
            v_e[match],
        )
    a_pres, b_pres = presence
    for role, (a_row, b_row) in enumerate(ROLE_STRAND_ROWS):
        for srow, dkey, ekey, sskey, pres in (
            (a_row, "a_depth", "a_err", "a_ss_err", a_pres),
            (b_row, "b_depth", "b_err", "b_ss_err", b_pres),
        ):
            hb = has[:, srow]
            if not hb.any():
                continue
            ad = np.asarray(out[dkey])[:, role, :].astype(np.int32)
            placed_ce = np.asarray(out[sskey])[:, role, :].astype(np.int32)
            agree = calls[:, srow, :] == base[:, role, :]
            cnt = np.where(agree, ad - placed_ce, 0) + dissent[:, srow, :]
            prole = pres[:, role, :]
            upd = hb[:, None] & prole & (base[:, role, :] != NBASE)
            ae_new = np.clip(ad - cnt, 0, None)
            cur = np.asarray(out[ekey])
            cur[:, role, :] = np.where(upd, ae_new, cur[:, role, :]).astype(
                cur.dtype
            )
    out["errors"] = (
        np.asarray(out["a_err"]).astype(np.int32)
        + np.asarray(out["b_err"]).astype(np.int32)
    ).astype(np.int16)
    return out


def _emit_duplex_batch(batch, out, params, mode, stats) -> list[BamRecord]:
    """Decode one retired duplex batch into consensus BamRecords."""
    base = out["base"]
    qual = out["qual"]
    depth = out["depth"]
    errors = out["errors"]
    a_depth = out["a_depth"]
    b_depth = out["b_depth"]
    has, first, last, span = _batch_spans(depth)
    dmax, dmin, dtot = _span_stats(depth, span)
    _emx, _emn, etot = _span_stats(errors, span)
    amax, amin, atot = _span_stats(a_depth, span)
    bmax, bmin, btot = _span_stats(b_depth, span)
    have_ss = "a_ss_err" in out
    if have_ss:
        _x, _n, asetot = _span_stats(out["a_ss_err"], span)
        _x, _n, bsetot = _span_stats(out["b_ss_err"], span)
    emitted: list[BamRecord] = []
    for fi, meta in enumerate(batch.meta):
        stats.families += 1
        if meta.n_templates < params.min_reads:
            # family-level --min-reads filter (0 in the reference's
            # configuration = emit everything, README.md:9)
            stats.skipped_families += 1
            continue
        starts = [
            meta.window_start + int(first[fi, r]) if has[fi, r] else -1
            for r in range(2)
        ]
        for role in range(2):
            if not has[fi, role]:
                continue
            sl = slice(int(first[fi, role]), int(last[fi, role]) + 1)
            seq_fwd = codes_to_seq(base[fi, role, sl])
            quals_fwd = qual[fi, role, sl].astype(np.uint8, copy=False).tobytes()
            flip = mode != "self" and bool(role)
            tags = _consensus_tags(
                depth[fi, role, sl], errors[fi, role, sl], meta.mi, meta.rx,
                flip=flip,
                pre=(
                    int(dmax[fi, role]), int(dmin[fi, role]),
                    int(dtot[fi, role]), int(etot[fi, role]),
                ),
            )
            # fgbio duplex per-strand tag surface: aD/bD max depth, aM/bM
            # min depth, ad/bd per-base depth arrays — raw per-read strand
            # units when the input carried the molecular cd/ce tags,
            # presence units (0/1) otherwise; per-base arrays follow the
            # emitted SEQ orientation
            a_cov = a_depth[fi, role, sl]
            b_cov = b_depth[fi, role, sl]
            if flip:
                a_cov, b_cov = a_cov[::-1], b_cov[::-1]
            tags["aD"] = ("i", int(amax[fi, role]))
            tags["bD"] = ("i", int(bmax[fi, role]))
            tags["aM"] = ("i", int(amin[fi, role]))
            tags["bM"] = ("i", int(bmin[fi, role]))
            emit_ss = have_ss and bool(np.asarray(out["ss_valid"])[fi, role])
            if emit_ss:
                # aE/bE read-level rates + ae/be per-base counts, in
                # STRAND-vs-own-call units
                a_se = np.asarray(out["a_ss_err"])[fi, role, sl]
                b_se = np.asarray(out["b_ss_err"])[fi, role, sl]
                if flip:
                    a_se, b_se = a_se[::-1], b_se[::-1]
                a_tot = int(atot[fi, role])
                b_tot = int(btot[fi, role])
                tags["aE"] = (
                    "f", int(asetot[fi, role]) / a_tot if a_tot else 0.0
                )
                tags["bE"] = (
                    "f", int(bsetot[fi, role]) / b_tot if b_tot else 0.0
                )
            tags["ad"] = ("B", ("S", np.ascontiguousarray(a_cov)))
            tags["bd"] = ("B", ("S", np.ascontiguousarray(b_cov)))
            if emit_ss:
                tags["ae"] = ("B", ("S", np.ascontiguousarray(a_se)))
                tags["be"] = ("B", ("S", np.ascontiguousarray(b_se)))
            if "a_call" in out:
                # per-strand consensus call strings (fgbio's ac/bc)
                ac = codes_to_seq(out["a_call"][fi, role, sl])
                bc = codes_to_seq(out["b_call"][fi, role, sl])
                if flip:
                    ac, bc = _revcomp(ac), _revcomp(bc)
                tags["ac"] = ("Z", ac)
                tags["bc"] = ("Z", bc)
            other = 1 - role
            tlen = 0
            if starts[0] >= 0 and starts[1] >= 0:
                lo = min(starts)
                hi = max(
                    meta.window_start + int(last[fi, r]) + 1 for r in range(2)
                )
                tlen = (hi - lo) if starts[role] == lo else -(hi - lo)
            # duplex R1 merges the forward-mapped pair (99,163): emit
            # forward; duplex R2 merges the reverse pair (83,147)
            emitted.append(_emit_read(
                qname=meta.mi,
                role=role,
                seq_fwd=seq_fwd,
                quals_fwd=quals_fwd,
                tags=tags,
                mode=mode,
                reverse=bool(role),
                ref_id=meta.ref_id,
                pos=starts[role],
                mate_pos=starts[other],
                mate_reverse=not bool(role),
                tlen=tlen,
            ))
            stats.consensus_out += 1
    return emitted


def call_molecular(
    records: Iterable[BamRecord],
    params: ConsensusParams = ConsensusParams(min_reads=1),
    mode: str = "unaligned",
    batch_families: int = 512,
    max_window: int = 4096,
    grouping: str = "gather",
    stats: StageStats | None = None,
    **kwargs,
) -> Iterator[BamRecord]:
    """Flat-record view of call_molecular_batches (same arguments; the
    keyword ones, device= among them, pass through)."""
    for batch in call_molecular_batches(records, params, mode, batch_families, max_window,
                                        grouping, stats, **kwargs):
        yield from batch


#: Reference flag vocabulary at the convert stage: pass-through set and
#: B-strand conversion set (tools/1.convert_AG_to_CT.py:70-73); any other
#: flag is silently dropped there (:69-186 structure — no else branch).
_PASS_FLAGS = (0, 99, 147)
_CONVERT_FLAGS = (1, 83, 163)


def _passthrough_records(leftovers, ref_fetch, ref_names,
                         pos0: str = "skip") -> list[BamRecord]:
    """Reference-parity emission for records the duplex tensorizer rejected
    (off-vocabulary flags, duplicate rows, non-4-group members).

    Mirrors what the reference chain would do with them before fgbio:
    flags {0,99,147} pass through verbatim (tools/1.convert_AG_to_CT.py:
    70-72); flags {1,83,163} are softclip-trimmed and CT-converted (:73-186,
    via the scalar oracle transcription, incl. LA/RD tags; CIGAR emitted as
    one M run of the final length); indel/hardclip conversion candidates
    and every other flag are dropped (:79-80, no-else). Reads empty after
    trimming are dropped (they cannot be written as records).
    """
    out: list[BamRecord] = []
    for rec in leftovers:
        if rec.flag in _PASS_FLAGS:
            out.append(rec)
            continue
        if rec.flag not in _CONVERT_FLAGS:
            continue
        if any(op in (CINS, CDEL, CHARD_CLIP) for op, _ in rec.cigar):
            continue
        trimmed = trim_softclips(rec)
        if trimmed is None or len(trimmed[0]) == 0:
            continue
        codes, quals, pos = trimmed
        seq = codes_to_seq(codes)
        ws = max(pos - 1, 0)
        window = ref_fetch(ref_names[rec.ref_id], ws, pos + len(seq) + 2) if (
            0 <= rec.ref_id < len(ref_names)
        ) else ""
        cseq, cquals, cpos, la, rd = oracle_convert_read(
            seq, [int(q) for q in quals], pos - ws, window, pos0=pos0
        )
        new = BamRecord(
            qname=rec.qname, flag=rec.flag, ref_id=rec.ref_id,
            pos=cpos + ws, mapq=rec.mapq, cigar=[(CMATCH, len(cseq))],
            next_ref_id=rec.next_ref_id, next_pos=rec.next_pos,
            tlen=rec.tlen, seq=cseq, qual=bytes(int(q) for q in cquals),
            tags=dict(rec.tags),
        )
        new.tags["LA"] = ("i", la)
        new.tags["RD"] = ("i", rd)
        out.append(new)
    return out


def call_duplex_batches(
    records: Iterable[BamRecord],
    ref_fetch,
    ref_names: Sequence[str],
    params: ConsensusParams = ConsensusParams(min_reads=0),
    mode: str = "unaligned",
    batch_families: int = 512,
    max_window: int = 4096,
    grouping: str = "gather",
    stats: StageStats | None = None,
    pos0: str = "skip",
    device=None,
    emit: str = "python",
    skip_batches: int = 0,
    transport: str = "auto",
    strand_tags: bool = True,
    chemistry: str = "bisulfite",
    refstore: RefStore | str | None = None,
    methyl=None,
    methyl_engine: str | None = None,
    passthrough: bool = False,
    guard=None,
    mesh="auto",
) -> Iterator[list]:
    """The fused duplex stage: convert + extend + duplex merge per MI
    group on the device, one list of consensus records per batch (the
    checkpoint/resume unit — see call_molecular_batches for
    skip_batches).

    records: BamRecords, or a pipeline.ingest.GroupedColumnarStream
    (pipeline.stages.duplex_ingest_stream) whose families carry the C
    duplex scan. emit: 'python' yields BamRecords and rawizes in numpy;
    'native' and 'auto' rawize in C (strand calls + raw units) and yield
    one io.bam.RawRecords block per batch. Same bytes either way.

    Input: the aligned molecular consensus BAM, or call_molecular_batches
    (mode='self') output directly. min_reads=0 emits every group. Records
    that cannot be tensorized (flags outside {99,163,83,147}, duplicate
    flags, indel reads) are counted as leftovers. By default they are
    dropped (a documented deviation: the reference would pass some of
    them through to fgbio). passthrough=True restores reference parity:
    they are written through with the reference's convert-stage treatment
    (_passthrough_records — pass-through flags verbatim, B-strand flags
    CT-converted with LA/RD tags, every other flag dropped), as BamRecord
    objects after the batch's consensus records (after its RawRecords
    block on the native emit); a batch with no family left carries them
    alone. Passthrough needs full-tag Python records
    (pipeline.stages.duplex_ingest_stream) and refuses chemistry 'none'.

    pos0: conversion-prepend behavior for reads mapped at reference
    position 0 — 'skip' (default, documented deviation) or 'shift'
    (exact reference parity incl. the register shift). device: 'cuda'
    (default) or 'cpu'; no silent fallback.

    transport: 'wire' ships each batch as ONE packed u32 array (the C pack
    on the native engine) and gathers its reference windows on the device
    from `refstore` — an ops.refstore.RefStore, or a FASTA path loaded
    only when the wire engages — so the encode skips the per-family host
    reference fetch and the rawize reads RefStore.host_windows; the
    output planes are the unpacked route's. The genome is read and
    uploaded before the first batch, timed as 'genome_load' (its parts
    'genome_load.read' and '.upload'). An explicit 'wire' without a
    refstore raises; 'auto' is the wire on the card when a refstore is
    given, unpacked otherwise (_resolve_transport).
    Device-issued batches count as 'route_batches_wire' or
    'route_batches_single'.

    strand_tags: emit the ac/bc per-strand consensus call string tags.
    Exact raw-unit errors (from the input's cB histograms) engage
    regardless.

    chemistry: 'bisulfite' (default) and 'emseq' run the conversion-aware
    engine (identical computation; 'emseq' is provenance). 'none'
    declares an unconverted duplex library: the convert mask is cleared
    after encode, and pos0='shift' (a conversion-prepend behavior) and
    methylation extraction (it needs a converting chemistry) are refused.

    methyl: a methyl.tally.MethylAccumulator, or None. When set, every
    device batch also yields per-column methylation planes
    (methyl.context) and their sparse tallies land in the accumulator,
    batch index by batch index, in retire — after the rawize, before the
    emit. methyl_engine: 'auto' and 'device' run the epilogue on the
    batch's device inside the dispatch (duplex_call_wire_fused_methyl on
    the wire, whose input appends each family's contig origin and whose
    output carries the planes after the duplex planes;
    duplex_call_pipeline_packed_methyl unpacked, whose planes are appended
    to its output on the device so the fetch stays one copy); 'host' runs
    the numpy twin (methyl_epilogue_host) on the retired batch — an
    explicit choice, never a fallback; None takes BSSEQ_TPU_METHYL_ENGINE
    (the JAX package's knob), else 'auto'. On the sharded mesh route each data
    shard runs the epilogue on its own device
    (parallel.sharding.sharded_duplex_outwire_methyl); the JAX package's
    mesh route takes the host twin there, with the same bits.
    The extension windows and the tallies' global offsets come from the
    accumulator's RefStore through the BAM header's names (bind_names);
    give the same store as `refstore` so the wire gathers from it too.
    Seconds: 'methyl'.

    mesh: as in call_molecular_batches. On a mesh the family axis shards
    (parallel.sharding.sharded_duplex_outwire over the unpacked planes,
    padded to the data size), or, with an explicit 'wire', whole batches
    round-robin over the mesh's slots, the genome uploaded once per card.
    Same bytes on every route ('route_batches_<route>').
    """
    device = resolve_device(device)
    mesh = _resolve_mesh(mesh, device)
    wire_mode = _resolve_transport(transport, device, mesh)
    use_wire = wire_mode != "off"
    if use_wire and refstore is None:
        if transport == "wire":
            raise ValueError("transport 'wire' needs a refstore (a RefStore or a FASTA path)")
        use_wire = False  # 'auto' without a genome: the unpacked route
    wire_rr = _WireRoundRobin(mesh) if wire_mode == "wire-mc" else None
    sharded = mesh is not None and wire_rr is None
    route = "sharded" if sharded else "wire_mc" if wire_rr else "wire" if use_wire else "single"
    if sharded:
        data_size = len(mesh.local_data())
        duplex_fn = _sharding.sharded_duplex_outwire(mesh, params)
        duplex_methyl_fn = _sharding.sharded_duplex_outwire_methyl(mesh, params)
    if chemistry not in ("bisulfite", "emseq", "none"):
        raise ValueError(f"unknown chemistry {chemistry!r} (bisulfite | emseq | none)")
    unconverted = chemistry == "none"
    if unconverted and passthrough:
        raise ValueError(
            "chemistry='none' is incompatible with passthrough=True: the "
            "leftover surface re-applies the reference convert-stage "
            "treatment the chemistry disables"
        )
    if unconverted and pos0 == "shift":
        raise ValueError(
            "chemistry='none' is incompatible with pos0='shift' (the "
            "shift is a conversion-prepend behavior)"
        )
    if methyl_engine is None:
        # the JAX package's knob; read only when methyl is on, as there
        methyl_engine = (os.environ.get("BSSEQ_TPU_METHYL_ENGINE", "auto")
                         if methyl is not None else "auto")
    if methyl_engine not in ("auto", "device", "host"):
        raise ValueError(f"unknown methyl engine {methyl_engine!r} (auto | device | host)")
    methyl_device = False
    if methyl is not None:
        if unconverted:
            raise ValueError(
                "methylation extraction needs a converting chemistry "
                "(bisulfite or emseq), not chemistry='none'"
            )
        methyl_store = methyl.refstore
        methyl_rid_map = methyl_store.contig_indices(ref_names)
        # the tallies' global offsets take the same name mapping as the
        # extension windows: one coordinate system
        methyl.bind_names(ref_names)
        methyl_device = methyl_engine != "host"
    native_emit = _resolve_emit(emit)
    emit_fn = _emit_duplex_batch_raw if native_emit else _emit_duplex_batch
    stats = stats if stats is not None else StageStats(stage="duplex")
    t0 = time.monotonic()
    genomes: dict = {}  # the genome on each device the wire launches on
    rid_map = None
    if use_wire:
        # the whole genome is read (from a FASTA path) and uploaded only
        # when the wire engages — once per card of the round-robin
        with stats.metrics.timed("genome_load"):
            if isinstance(refstore, str):
                with stats.metrics.timed("genome_load.read"):
                    refstore = RefStore.from_fasta(refstore)
            with stats.metrics.timed("genome_load.upload"):
                for dev in ([d for _s, d in wire_rr.slots] if wire_rr else [device]):
                    dev = _norm_device(dev)
                    if dev not in genomes:
                        genomes[dev] = refstore.device_codes(dev)
        rid_map = refstore.contig_indices(ref_names)
    metrics = stats.metrics
    stage_label = stats.stage or "duplex"
    observe.mem_sample(metrics, "start")
    #: batch shapes already dispatched once — _compile_probe bookkeeping
    compile_shapes: set = set()

    def mapped_rids(batch, rmap):
        """Store contig index per family (-1 when unknown) through `rmap`
        (a store's contig_indices of the header's names)."""
        fb = len(batch.meta)
        rids = np.fromiter((m.ref_id for m in batch.meta), np.int64, fb)
        valid = (rids >= 0) & (rids < len(rmap))
        # a plain rmap[rids] would let -1 wrap to the last contig
        return np.where(valid, rmap[np.where(valid, rids, 0)], -1)

    def window_starts(batch):
        return np.fromiter((m.window_start for m in batch.meta), np.int64, len(batch.meta))

    def wire_window_offsets(batch):
        """(starts, limits) uint32 global genome offsets for one batch,
        computed once in dispatch and reused by the host rawize windows."""
        return refstore.window_offsets(mapped_rids(batch, rid_map), window_starts(batch))

    def methyl_ref_ext(batch):
        """[F, W+4] extension windows from the accumulator's store, on the
        host: the unpacked dispatch's input and the host twin's."""
        mapped = mapped_rids(batch, methyl_rid_map)
        starts, limits = methyl_store.window_offsets(mapped, window_starts(batch))
        return methyl_store.host_windows_ext(
            starts, methyl_store.window_origins(mapped), limits, batch.bases.shape[-1] + 4
        )

    def host_ref(batch, windows):
        """[F, W+1] reference windows for the host rawize passes: the
        encode-fetched plane off the wire, the host genome copy on it."""
        if windows is None:
            return batch.ref
        return refstore.host_windows(*windows, batch.bases.shape[-1] + 1)

    def dispatch(batch, wire, methyl_dev):
        """H2D copies + the fused convert/extend/merge; returns
        (the in-flight output wire, the wire's (starts, limits) or None).
        On the round-robin wire the batch goes to its `slot`."""
        if batch.slot is not None:
            (d, r), dev = batch.slot
            with _on_device(dev), cuda_vote.launch_tag(f"{d},{r}"):
                return dispatch_wire(batch, methyl_dev, dev)
        if wire:
            return dispatch_wire(batch, methyl_dev, device)
        if sharded:
            # the unpacked planes over the data shards, with the extension
            # windows when the epilogue runs there too
            planes = (batch.bases, batch.quals.astype(np.int16), batch.cover, batch.ref,
                      batch.convert_mask, batch.extend_eligible)
            if methyl_dev:
                planes += (methyl_ref_ext(batch),)
            arrays, _pf = pad_families(planes, batch.bases.shape[0], data_size)
            metrics.count("h2d_bytes", sum(a.nbytes for a in arrays))
            fn = duplex_methyl_fn if methyl_dev else duplex_fn
            return _Inflight(fn.launch(*arrays)), None
        # off the wire the rawize reads the encode-fetched plane
        arrays = [
            _to_device(a, device, metrics) for a in (
                batch.bases, batch.quals.astype(np.int16), batch.cover,
                batch.ref, batch.convert_mask, batch.extend_eligible,
            )
        ]
        if methyl_dev:
            out, _la, _rd, planes = duplex_call_pipeline_packed_methyl(
                *arrays, _to_device(methyl_ref_ext(batch), device, metrics), params=params,
            )
            # the planes ride the same fetch, after the duplex planes
            out = torch.cat([out, planes.reshape(-1)])
        else:
            out, _la, _rd = duplex_call_pipeline_packed(*arrays, params=params)
        return _Inflight(out), None

    def dispatch_wire(batch, methyl_dev, dev):
        """The packed input wire on `dev`, its windows gathered there from
        the card's genome; returns (in-flight output wire, (starts,
        limits))."""
        genome = genomes[_norm_device(dev)]
        f, w = batch.bases.shape[0], batch.bases.shape[-1]
        windows = wire_window_offsets(batch)
        with metrics.timed("kernel.pack"):
            win = pack_duplex_inputs(
                batch.bases, batch.quals.astype(np.uint8), batch.cover,
                batch.convert_mask, batch.extend_eligible, *windows,
                qual_mode="auto", native=native_emit,
            )
            words = win.to_words()
        metrics.count(f"wire_qual_{win.qual_mode}")
        if methyl_dev:
            # the methyl input appendix: each family's contig origin
            # (the extension gather's lower bound) after the base wire
            los = refstore.window_origins(mapped_rids(batch, rid_map))
            out = duplex_call_wire_fused_methyl(
                _wire_to_device(np.concatenate([words, los]), dev, metrics),
                genome, f, w, params=params, qual_mode=win.qual_mode,
            )
        else:
            out = duplex_call_wire_fused(
                _wire_to_device(words, dev, metrics),
                genome, f, w, params=params, qual_mode=win.qual_mode,
            )
        return _Inflight(out), windows

    def rawize(host, windows, batch, sidecar, methyl_dev):
        """Unpack + the methyl planes + the rawize of one fetched wire;
        returns (rawized outputs, methyl planes or None)."""
        f, w = batch.bases.shape[0], batch.bases.shape[-1]
        with metrics.timed("fetch"):
            out = unpack_duplex_outputs(host, f=f, w=w)
        planes = None
        if methyl is not None:
            with metrics.timed("methyl"):
                if methyl_dev:  # the planes ride the fetched wire's tail
                    planes = unpack_methyl_planes(host[f * 4 * w:], f, w)
                else:
                    planes = methyl_epilogue_host(
                        batch.bases, batch.quals, batch.cover, batch.convert_mask,
                        out["base"], methyl_ref_ext(batch), params.min_input_base_quality,
                    )
        with metrics.timed("rawize"):
            out = _duplex_rawize(
                out, batch, sidecar,
                host_ref(batch, windows) if (strand_tags or sidecar) else None,
                native=native_emit, strand_tags=strand_tags,
            )
        return out, planes

    def dispatch_fetch(batch, sidecar, bi=None, armed=True):
        """The recovery unit: dispatch + blocking fetch + rawize of one
        batch (see the molecular stage's; `armed=False` passes the
        failpoint sites by). The methyl tallies are NOT added here: they
        land on the ordered retire (land), in batch order."""
        with _compile_probe(compile_shapes, ("kernel", *batch.bases.shape), stage_label), \
                metrics.timed("kernel"):
            if armed:
                _failpoints.fire("dispatch_kernel", stage=stage_label, batch=bi)
            inflight, windows = dispatch(batch, use_wire, methyl_device)
        if armed:
            _failpoints.fire("fetch_out", stage=stage_label, batch=bi)
        host = inflight.fetch(metrics)
        if sharded:
            # the shards' (packed, la, rd), or (packed, methyl planes):
            # the planes after the real families' duplex planes, as on
            # one device
            f, w = batch.bases.shape[0], batch.bases.shape[-1]
            host = (np.concatenate([host[0][: f * 4 * w], host[1].reshape(-1)])
                    if methyl_device else host[0])
        return rawize(host, windows, batch, sidecar, methyl_device)

    def degrade_fetch(batch, sidecar):
        """A batch whose retries ran out: its unit once more on the
        stage's own device (or mesh) with the failpoints bypassed (the
        card's kernels on a card run, never the CPU); timed as
        'degrade'."""
        with metrics.timed("degrade"):
            return dispatch_fetch(batch, sidecar, armed=False)

    def dispatch_fetch_guarded(batch, sidecar, bi):
        return _faultretry.guarded(
            partial(dispatch_fetch, batch, sidecar, bi),
            degrade=partial(degrade_fetch, batch, sidecar),
            metrics=metrics, stage=stage_label, batch=bi,
        )

    def recover_fetch(batch, sidecar, bi, exc):
        """Re-run the whole dispatch+fetch+rawize unit under the retrier
        after `exc` — the retire's recovery."""
        return _faultretry.guarded(
            partial(dispatch_fetch, batch, sidecar, bi),
            degrade=partial(degrade_fetch, batch, sidecar),
            metrics=metrics, stage=stage_label, batch=bi, failed=exc,
        )

    def emit_out(done, batch, passed, st):
        """Record emit for one batch against `st` (a task's shadow
        stats); returns (records, planes) so the ordered retire adds the
        methyl tallies."""
        out, planes = done
        with metrics.timed("emit"):
            recs = emit_fn(batch, out, params, mode, st)
        recs = [recs] if isinstance(recs, RawRecords) else recs
        _track_emitted(recs)
        return recs + passed, planes

    def batch_task(batch, sidecar, bi, passed):
        """One batch on the stage's executor: the guarded unit, then the
        record emit against a shadow stats."""
        with observe.bind_batch(bi, stage_label):
            shadow = _hp_stats_shadow(stats)
            done = dispatch_fetch_guarded(batch, sidecar, bi)
            return emit_out(done, batch, passed, shadow), shadow

    def retire(fut, batch, sidecar, bi, passed):
        """The ordered retire of one batch task (see the molecular
        stage's), then the batch's methyl tallies, in batch order, and
        its records."""
        with observe.bind_batch(bi, stage_label):
            try:
                _failpoints.fire("retire_future", stage=stage_label, batch=bi)
                with metrics.timed("stall"), metrics.timed("stall.batch"):
                    (recs, planes), shadow = _join_with_watchdog(
                        fut, batch, bi, lambda b, i: batch_task(b, sidecar, i, passed),
                        stats, stage_label,
                    )
            except _faultretry.RETRYABLE as exc:
                shadow = _hp_stats_shadow(stats)
                recs, planes = emit_out(recover_fetch(batch, sidecar, bi, exc), batch, passed,
                                        shadow)
            _hp_stats_merge(stats, shadow)
            if methyl is not None:
                with metrics.timed("methyl"):
                    methyl.add_planes(bi, planes, batch.meta)
            observe.mem_sample(metrics, "retire")
        observe.batch_close(bi, stage_label)
        return recs

    groups = metrics.pulls(  # 'ingest', booked once per chunk
        _guard_mod.guard_groups(
            stream_mi_groups(records, strip_suffix=True, grouping=grouping, stats=stats),
            guard,
        ),
        "ingest",
    )

    def encode_chunk(item):
        """Pure-host encode of one duplex chunk — the encode, the sidecar
        capture and the passthrough records run as ONE host-pool task
        (double-buffered by _hp_prefetch), so `ref_fetch` is only ever
        called from one thread at a time. Stat counts apply on the
        dispatch thread, in batch order."""
        bi, chunk = item
        with observe.bind_batch(bi, stage_label), metrics.timed("encode"):
            # on the wire the device gathers the reference windows, so
            # the per-family host fetch is skipped (batch.ref stays N)
            batch, leftovers, skipped = encode_duplex_families(
                chunk, ref_fetch, ref_names, max_window=max_window,
                fetch_ref=not use_wire, pos0=pos0,
            )
            if unconverted:
                # an unconverted library: clearing the flag-derived mask
                # disables the convert transform wholesale
                batch.convert_mask = np.zeros_like(batch.convert_mask)
            sidecar = _duplex_sidecar(chunk, pos0=pos0) if batch.meta else None
        passed = (_passthrough_records(leftovers, ref_fetch, ref_names, pos0=pos0)
                  if passthrough and leftovers else [])
        return bi, batch, leftovers, skipped, passed, sidecar

    def numbered_chunks():
        try:
            for batch_index, chunk in enumerate(_group_batches(groups, batch_families),
                                                start=1):
                groups.book()
                if batch_index <= skip_batches:
                    # resume replay: skipped batches never encode at all
                    continue
                observe.batch_open(batch_index, stage_label)
                yield batch_index, chunk
        finally:
            groups.book()

    def events():
        encoded = (
            _hp_prefetch(numbered_chunks(), hpool, encode_chunk, metrics=metrics)
            if hpool is not None else map(encode_chunk, numbered_chunks())
        )
        for batch_index, batch, leftovers, skipped, passed, sidecar in encoded:
            observe.mem_track_arrays("inflight", batch)
            stats.skipped_families += len(skipped)
            stats.leftover_records += len(leftovers)
            if not batch.meta:
                observe.batch_close(batch_index, stage_label)
                yield "now", passed
                continue
            stats.batches += 1
            used = int(batch.cover.sum())
            stats.pad_cells += batch.cover.size - used
            stats.used_cells += used
            metrics.count(f"route_batches_{route}")
            if wire_rr is not None:
                batch.slot = wire_rr.next_slot()
            fut = executor.submit(batch_task, batch, sidecar, batch_index, passed,
                                  batch=batch_index)
            yield "deferred", partial(retire, fut, batch, sidecar, batch_index, passed)

    _warm_device(params, device, singleton=False, mesh=mesh, stage=stage_label)
    hpool = _hostpool.make_pool(metrics, stage_label)
    executor = _batch_executor(device, stats, hpool, sharded, wire_rr)
    try:
        yield from _pipelined(events(), depth=_pipeline_depth(executor, wire_rr))
    finally:
        executor.shutdown()
        if hpool is not None:
            hpool.shutdown()
    stats.wall_seconds += time.monotonic() - t0
    compilecache.publish(stats.metrics)



def call_duplex(
    records: Iterable[BamRecord],
    ref_fetch,
    ref_names: Sequence[str],
    params: ConsensusParams = ConsensusParams(min_reads=0),
    mode: str = "unaligned",
    batch_families: int = 512,
    max_window: int = 4096,
    grouping: str = "gather",
    stats: StageStats | None = None,
    passthrough: bool = False,
    pos0: str = "skip",
    **kwargs,
) -> Iterator[BamRecord]:
    """Flat-record view of call_duplex_batches (same arguments; the
    keyword ones, device= among them, pass through)."""
    for batch in call_duplex_batches(records, ref_fetch, ref_names, params, mode,
                                     batch_families, max_window, grouping, stats,
                                     passthrough=passthrough, pos0=pos0, **kwargs):
        yield from batch
