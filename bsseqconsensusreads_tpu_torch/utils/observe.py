"""Observability: per-stage metrics and the run ledger.

The port's counterpart of the JAX package's utils/observe.py.

* **Metrics** — named counters and nested, thread-aware phase timers for
  one stage, with the JAX package's `phase_summary` (host_s / device_s /
  stall_s / chip_busy / unattributed_s). Phases the stages time: ingest
  (the group stream's pulls, booked once per chunk: `Metrics.pulls`),
  encode, kernel (host-side dispatch: its parts kernel.pack, the wire's
  C pack, and kernel.h2d, the H2D copies; the rest is the launches),
  device_wait (CUDA event
  sync — the device still owned the batch), fetch (D2H copy + unpack),
  host_vote (singleton host path), rawize (duplex raw units + strand
  calls), emit, sort_write (the output writer's sort, spill, merge and
  deflate), genome_load (the duplex wire's whole-genome read and upload,
  or the methyl accumulator's read, once per stage), methyl (the
  methylation planes peeled or computed on the host, and their tallies
  added), methyl_finalize (the tally merge and the bedMethyl / CX
  writes), stall (the dispatch thread blocked on a pool's future: its
  parts stall.encode, the encode-ahead, and stall.batch, a batch task at
  the ordered retire), idle
  (the serve engine waiting for its tenants' families),
  degrade (a batch's unit run once more, failpoints bypassed, after its
  retries ran out) and spill_write (a sort run's write, on the background
  writer when host workers are on). Phases timed on pool workers sum
  their threads' seconds. A dotted name ('emit.pack', 'sort_write.merge')
  is a part of the phase before the dot.
* **the run ledger** — one JSONL stream per run, opened by a
  `run_manifest` line (git rev, backend, device count, config digest,
  env flags). Every line goes through ONE locked, line-flushed writer per
  sink, so worker threads interleave whole lines, never bytes, and a
  crash loses at most the line being written. `ledger_digest` is a
  SHA-256 over the bytes this process wrote to a sink. Lines carry the
  JAX package's event names and fields; utils.ledger_tools and
  utils.trace_tools (`observe summarize|diff|check|trace|top`) read them.
* **sub-sinks** — job-tagged lines (the serve engine's tenants) mirror to
  <BSSEQ_TPU_STATS_JOBS>/<job>.jsonl; a fleet replica
  (BSSEQ_TPU_REPLICA_ID) stamps 'replica' on every line and mirrors to
  BSSEQ_TPU_STATS_REPLICAS; a worker (BSSEQ_TPU_WORKER_ID) likewise to
  BSSEQ_TPU_STATS_WORKERS.
* **causal traces** — `mint_trace` creates {trace, span} at an admission
  point (router submit, serve admit); `bind_trace` installs it
  thread-locally so every `emit` in its extent carries the ids; `span`
  times a child span and emits one completed 'span' line. Contexts cross
  processes as the reserved `_trace` key of a serve request.
* **the span timeline** — off by default; armed (`timeline()`: by
  `maybe_trace`, or by a caller such as a benchmark's traced window),
  every span the timers close is also kept with its interval on
  time.time_ns() (torch.profiler's clock), thread, batch (`bind_batch`),
  parent and thread CPU time, and each batch gets one 'batch' record from
  its encode's submit to its retire's end. `maybe_trace` writes them into
  its Chrome trace, one lane per thread, and as 'span' lines under the
  process trace when a ledger is open. Off, a timer pays one check.
* **the host memory account** — always on: the layers that hold host
  memory register it by part (ingest buffers, batches in flight, pinned
  staging, the sort's buffer, the genome), and `mem_sample` reads the
  resident set and glibc's heap beside them at a stage's start, at each
  ordered retire and around its final sort. A stage keeps its
  highest-rss sample whole as `mem.<stage>.peak.<part>_bytes` counters
  (out of its ledger line); armed, the timeline keeps every sample, and
  `maybe_trace` writes them as counter tracks.
* **the flight recorder** — a bounded ring of the most recent records
  per process (BSSEQ_TPU_FLIGHT_RING, default 256), dumped as one
  'flight_record' line on SIGUSR1, on a failpoint `exit` and on an input
  error exit.

Activation is environment-driven, as in the JAX package:

  BSSEQ_TPU_STATS=-            ledger JSON lines to stderr
  BSSEQ_TPU_STATS=/path.jsonl  appended to a file
  BSSEQ_TPU_TRACE=/path/dir    wrap the molecular, duplex and fused
                               stages in a torch.profiler trace
                               (Chrome trace JSON; `maybe_trace`) with
                               the span timeline armed: the program's
                               spans beside the device's

`event` is the port's never-silent form of `emit`: the ledger line, and
one `<name> {json}` line on stderr.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import hashlib
import json
import os
import sys
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import NamedTuple

#: phases whose seconds are device occupancy or the transfer around it;
#: every other undotted phase is host work, except 'stall' (the dispatch
#: thread blocked on a pool's future — the pipeline's unhidden remainder)
DEVICE_PHASES = frozenset({"kernel", "device_wait", "fetch"})
STALL_PHASES = frozenset({"stall"})


#: the calling thread's open `Metrics.timed` spans over every Metrics,
#: outermost first (current_spans)
_SPANS_LOCAL = threading.local()


def _thread_spans() -> list:
    spans = getattr(_SPANS_LOCAL, "stack", None)
    if spans is None:
        spans = _SPANS_LOCAL.stack = []
    return spans


def current_spans() -> tuple:
    """The calling thread's open timed spans, outermost first, whichever
    stage's Metrics opened them: what a sync seen at run time is booked
    under (chip_smoke's host-sync audit)."""
    return tuple(_thread_spans())


@dataclass
class Metrics:
    """Named counters + nested, thread-aware span timers for one stage.

    Locked: the overlap and host pools' workers count and time into the
    stage's Metrics concurrently with the dispatch thread; a phase timed
    on several threads at once sums their seconds (worker-busy time, not
    wall). Each thread keeps its own span stack: nested `timed` calls
    record slash-joined paths in `spans` (`span_tree` rebuilds the
    hierarchy), and `owner_seconds` tracks the OUTERMOST spans on the
    thread that created the Metrics — what `phase_summary`'s closure
    (`unattributed_s`) sums against the stage wall. A dotted name
    ('emit.pack', 'sort_write.merge') is a part of the phase before the
    dot: it never enters the host/device/stall sums or `owner_seconds`.
    """

    counters: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)
    #: slash-joined span path -> [seconds, calls]
    spans: dict = field(default_factory=dict)
    #: outermost-span seconds on the owning thread only (closure checks)
    owner_seconds: dict = field(default_factory=dict)
    clock: object = field(default=time.monotonic, repr=False, compare=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)
    _owner: int = field(default_factory=threading.get_ident, repr=False, compare=False)
    _tls: threading.local = field(default_factory=threading.local, repr=False,
                                  compare=False)
    #: the stage these timers belong to, stamped on their timeline spans
    stage: str = field(default="", repr=False, compare=False)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def own_timeline(self) -> None:
        """Make the calling thread the owner: a Metrics made on one thread
        for a loop that runs on another (the serve engine's) closes the
        loop's timeline, not its maker's."""
        with self._lock:
            self._owner = threading.get_ident()

    @contextlib.contextmanager
    def timed(self, name: str):
        stack = self._stack()
        path = "/".join(stack + [name])
        outermost = not stack
        stack.append(name)
        spans = _thread_spans()
        spans.append(name)
        tl = _TIMELINE
        if tl is not None:
            mark = _open_span()
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            stack.pop()
            spans.pop()
            if tl is not None:
                _close_span(tl, mark, name, path, self.stage)
            self._accumulate(name, path, dt, outermost)

    def _accumulate(self, name: str, path: str, dt: float, outermost: bool,
                    calls: int = 1) -> None:
        """The one locked read-modify-write behind every timer entry point."""
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            rec = self.spans.get(path)
            if rec is None:
                self.spans[path] = [dt, calls]
            else:
                rec[0] += dt
                rec[1] += calls
            if outermost and threading.get_ident() == self._owner:
                self.owner_seconds[name] = self.owner_seconds.get(name, 0.0) + dt

    def add_seconds(self, name: str, dt: float) -> None:
        """Seconds measured elsewhere (a C call's own clock, a writer's
        post-stream share); a dotted name is booked as a sub-phase."""
        outermost = not self._stack() and "." not in name
        tl = _TIMELINE
        if tl is not None:
            _booked_span(tl, name, dt, self.stage)
        self._accumulate(name, name, dt, outermost)

    def add_sub_seconds(self, name: str, dt: float) -> None:
        """A share of time already booked under its parent phase; the name
        must be dotted (parent.child)."""
        if "." not in name:
            raise ValueError(f"sub-phase name must be dotted (parent.child), got {name!r}")
        tl = _TIMELINE
        if tl is not None:
            _booked_span(tl, name, dt, self.stage)
        self._accumulate(name, name, dt, outermost=False)

    def pulls(self, items, name: str) -> "Pulls":
        """`items` with each pull timed under `name` by bare clock reads
        and booked once per `Pulls.book()` (see Pulls)."""
        return Pulls(self, items, name)

    def rate(self, counter: str, timer: str) -> float:
        dt = self.seconds.get(timer, 0.0)
        return self.counters.get(counter, 0) / dt if dt else 0.0

    def span_tree(self) -> dict:
        """The span hierarchy: {name: {seconds, calls, children: {...}}},
        rebuilt from the slash-joined paths. Same-name spans from several
        threads merge into one node (their seconds sum)."""
        with self._lock:
            snapshot = dict(self.spans)
        tree: dict = {}
        for path, (secs, calls) in sorted(snapshot.items()):
            node_map = tree
            parts = path.split("/")
            for i, part in enumerate(parts):
                node = node_map.setdefault(part, {"seconds": 0.0, "calls": 0, "children": {}})
                if i == len(parts) - 1:
                    node["seconds"] = round(node["seconds"] + secs, 6)
                    node["calls"] += calls
                node_map = node["children"]
        return tree

    def phase_summary(self, wall: float) -> dict:
        """The stage report the ledger carries: host_s / device_s /
        stall_s, chip_busy (device seconds per wall second — above 1 with
        several batches in flight) and unattributed_s (the owner thread's
        timeline outside every outermost span; `observe check` bounds it)."""
        with self._lock:
            secs = dict(self.seconds)
            owner = dict(self.owner_seconds)
        device_s = sum(v for k, v in secs.items() if k in DEVICE_PHASES)
        stall_s = sum(v for k, v in secs.items() if k in STALL_PHASES)
        host_s = sum(v for k, v in secs.items()
                     if k not in DEVICE_PHASES and k not in STALL_PHASES and "." not in k)
        attributed = sum(owner.values())
        return {
            "host_s": round(host_s, 3),
            "device_s": round(device_s, 3),
            "stall_s": round(stall_s, 3),
            "chip_busy": round(device_s / wall, 4) if wall > 0 else 0.0,
            "unattributed_s": round(max(wall - attributed, 0.0), 3),
        }

    def as_dict(self) -> dict:
        """Counters and phase seconds for the stage's ledger line; the
        memory account's `mem.` and the vote plans' `vote.` counters stay
        out of it (read them from `counters`)."""
        with self._lock:
            out = {k: v for k, v in self.counters.items() if not k.startswith(UNLEDGERED)}
            out.update({f"{k}_seconds": round(v, 3) for k, v in self.seconds.items()})
        return out

    def mem_peak(self, sample: dict) -> bool:
        """Book one memory sample (mem_sample): count it, and where its
        rss is the stage's highest yet keep the whole sample as the
        stage's `mem.<stage>.peak.<part>_bytes` counters (a part that read
        None has none). Returns whether it became the peak; a sample
        whose rss alone shows it is not may carry nothing else."""
        prefix = f"{MEM_PREFIX}{self.stage or 'stage'}."
        with self._lock:
            key = prefix + "samples"
            self.counters[key] = self.counters.get(key, 0) + 1
            if sample["rss"] <= self.mem_peak_rss():
                return False
            for part in MEM_PARTS:
                v = sample.get(part)
                if v is None:
                    self.counters.pop(f"{prefix}peak.{part}_bytes", None)
                else:
                    self.counters[f"{prefix}peak.{part}_bytes"] = int(v)
            return True

    def mem_peak_rss(self) -> int:
        """The stage's highest sampled rss so far, or -1."""
        return self.counters.get(f"{MEM_PREFIX}{self.stage or 'stage'}.peak.rss_bytes", -1)


class Pulls:
    """An iterator's pulls timed as one phase at a fraction of `timed`'s
    cost: a bare clock read on each side of every `next()` (no context
    manager, no lock), the phase open on the thread's span stacks for the
    pull — a span timed inside it is a part of it, as under `timed` — and
    the seconds booked (one locked update, the pulls as its calls) at
    each `book()`: the stage's group stream, booked once per chunk. Armed,
    the timeline gets one span per book, from its first pull's start to
    its last pull's end (placed by one wall-clock read at the first pull;
    no CPU time: a thread CPU clock read a pull would cost more than the
    pull). A pull made inside another span of the same Metrics takes the
    full `timed` path."""

    def __init__(self, metrics: "Metrics", items, name: str):
        self._metrics = metrics
        self._items = iter(items)
        self._name = name
        self._s = 0.0
        self._calls = 0
        self._mark = None  # the booked span's (id, parent, first start ns, first start)
        self._t1 = 0.0  # the last pull's end, on the Metrics' clock

    def __iter__(self):
        return self

    def __next__(self):
        m = self._metrics
        stack = m._stack()
        if stack:
            with m.timed(self._name):
                return next(self._items)
        stack.append(self._name)
        spans = _thread_spans()
        spans.append(self._name)
        ids = None
        t0 = m.clock()
        if _TIMELINE is not None:
            ids = _thread_ids()
            if self._mark is None:
                self._mark = (_next_span_id(), _enclosing_span(ids), time.time_ns(), t0)
            ids.append(self._mark[0])
        try:
            return next(self._items)
        finally:
            self._t1 = m.clock()
            self._s += self._t1 - t0
            self._calls += 1
            stack.pop()
            spans.pop()
            if ids is not None:
                ids.pop()

    def book(self) -> None:
        """Book the pulls since the last book (none: nothing)."""
        if not self._calls:
            return
        dt, calls, mark = self._s, self._calls, self._mark
        self._s, self._calls, self._mark = 0.0, 0, None
        m = self._metrics
        tl = _TIMELINE
        if tl is not None and mark is not None:
            sid, parent, t0_ns, t0 = mark
            tl.add(TimelineSpan(self._name, self._name, m.stage, threading.current_thread().name,
                                getattr(_TL_LOCAL, "batch", None), sid, parent, t0_ns,
                                t0_ns + int((self._t1 - t0) * 1e9), int(dt * 1e9), None))
        m._accumulate(self._name, self._name, dt, outermost=True, calls=calls)


# ---------------------------------------------------------------------------
# The span timeline. While `timeline()` is armed, every span `Metrics.timed`
# closes, every span booked after the fact (`add_seconds`,
# `add_sub_seconds`: recorded as ending when booked) and every `Pulls.book`
# is also kept as a TimelineSpan, stamped on time.time_ns() — the clock
# torch.profiler stamps its events with (kineto's trace_start_ns() plus an
# event's time_range), so the host's spans lie beside the device's. Off, a
# timer pays one check of `_TIMELINE`: no clock read, no allocation.


class TimelineSpan(NamedTuple):
    name: str
    path: str  # slash-joined, as Metrics.spans keys it
    stage: str
    thread: str
    batch: int | None  # the batch index bound on the thread (bind_batch)
    span: str  # the id, in _next_span_id's shape
    parent: str | None  # the enclosing span on the thread, else the batch's record
    t0_ns: int
    t1_ns: int
    wall_ns: int  # the seconds booked: t1 - t0, except a Pulls span (its pulls only)
    cpu_ns: int | None  # the thread's CPU time over the span; None when booked after, or pulls


class Timeline:
    """The armed timeline's records, at most TIMELINE_CAP (later spans
    are counted in `dropped`, not kept)."""

    def __init__(self):
        self.records: list = []
        self.dropped = 0
        #: the memory account's samples (MemRecord), in time order
        self.mem: list = []
        #: the open 'batch' records by (stage, batch index) (batch_open)
        self.open_batches: dict = {}
        self._lock = threading.Lock()

    def add(self, rec: TimelineSpan) -> None:
        if len(self.records) < TIMELINE_CAP:
            self.records.append(rec)  # list.append: atomic across threads
            return
        with self._lock:
            self.dropped += 1


#: the armed Timeline, or None (off)
_TIMELINE: Timeline | None = None
#: records a timeline keeps at most (~0.4 KB each; a dup4 pass makes ~480)
TIMELINE_CAP = 1 << 18
#: per thread: `ids`, the open timeline spans' ids; `batch` and
#: `batch_span`, the bound batch index and its record's id (bind_batch)
_TL_LOCAL = threading.local()


@contextlib.contextmanager
def timeline():
    """Arm the span timeline for the block (process-wide, every thread);
    yields the Timeline, whose `records` fill as spans close. Restores
    the previous timeline (or none) on exit."""
    global _TIMELINE
    prev = _TIMELINE
    tl = _TIMELINE = Timeline()
    try:
        yield tl
    finally:
        _TIMELINE = prev


def _thread_ids() -> list:
    ids = getattr(_TL_LOCAL, "ids", None)
    if ids is None:
        ids = _TL_LOCAL.ids = []
    return ids


def _enclosing_span(ids: list) -> str | None:
    return ids[-1] if ids else getattr(_TL_LOCAL, "batch_span", None)


def _open_span() -> tuple:
    ids = _thread_ids()
    sid = _next_span_id()
    mark = (sid, _enclosing_span(ids), time.thread_time_ns(), time.time_ns())
    ids.append(sid)
    return mark


def _close_span(tl: Timeline, mark: tuple, name: str, path: str, stage: str) -> None:
    t1 = time.time_ns()
    c1 = time.thread_time_ns()
    sid, parent, c0, t0 = mark
    ids = _thread_ids()
    if ids and ids[-1] == sid:
        ids.pop()
    elif sid in ids:
        ids.remove(sid)
    tl.add(TimelineSpan(name, path, stage, threading.current_thread().name,
                        getattr(_TL_LOCAL, "batch", None), sid, parent, t0, t1, t1 - t0,
                        c1 - c0))


def _booked_span(tl: Timeline, name: str, dt: float, stage: str) -> None:
    t1 = time.time_ns()
    wall = int(dt * 1e9)
    tl.add(TimelineSpan(name, name, stage, threading.current_thread().name,
                        getattr(_TL_LOCAL, "batch", None), _next_span_id(),
                        _enclosing_span(_thread_ids()), t1 - wall, t1, wall, None))


class BatchMark:
    """One batch's timeline-only 'batch' record while it is open."""

    __slots__ = ("batch", "span", "stage", "t0_ns")

    def __init__(self, batch: int, stage: str):
        self.batch = batch
        self.span = _next_span_id()
        self.stage = stage
        self.t0_ns = time.time_ns()


def batch_open(batch: int, stage: str) -> None:
    """Open the record of `stage`'s batch `batch` (the submit of its
    encode) in the armed timeline; off, nothing."""
    tl = _TIMELINE
    if tl is not None:
        tl.open_batches[(stage, batch)] = BatchMark(batch, stage)


def batch_close(batch: int, stage: str) -> None:
    """Close the record of `stage`'s batch `batch` (the end of its
    retire): one 'batch' span on the calling thread, never booked in a
    Metrics. Off, or never opened in this timeline: nothing."""
    tl = _TIMELINE
    mark = tl.open_batches.pop((stage, batch), None) if tl is not None else None
    if mark is None:
        return
    t1 = time.time_ns()
    tl.add(TimelineSpan("batch", "batch", stage, threading.current_thread().name,
                        batch, mark.span, None, mark.t0_ns, t1, t1 - mark.t0_ns, None))


@contextlib.contextmanager
def bind_batch(batch: int, stage: str):
    """Bind `stage`'s batch `batch` on the calling thread for the block:
    its timeline spans carry the index, and an outermost one takes the
    batch's open record as its parent. A no-op when off."""
    tl = _TIMELINE
    if tl is None:
        yield
        return
    mark = tl.open_batches.get((stage, batch))
    prev = (getattr(_TL_LOCAL, "batch", None), getattr(_TL_LOCAL, "batch_span", None))
    _TL_LOCAL.batch, _TL_LOCAL.batch_span = batch, (mark.span if mark else None)
    try:
        yield
    finally:
        _TL_LOCAL.batch, _TL_LOCAL.batch_span = prev


# ---------------------------------------------------------------------------
# The host memory account. The layers that hold host memory register it
# here: a buffer is counted under its part from registration until the
# object that owns it is collected (mem_track: the ingest batches' arrays,
# a batch's encoded arrays, fetched wire and emitted records, the pinned
# staging, the genome), or as a gauge the holder sets (MemGauge: the
# sort's run buffer). mem_sample reads the process's resident set and
# glibc's heap beside those parts, on the calling thread, and books the
# sample on a stage's Metrics (Metrics.mem_peak): the stages take one at
# their start, at each ordered retire, and around the final sort and
# write. Armed, the timeline also keeps every sample (MemRecord).

#: the counters' prefix (Metrics.as_dict leaves them out of the ledger)
MEM_PREFIX = "mem."
#: the molecular vote plans' counters (pipeline.calling, ops.cuda_vote.plan_counts)
VOTE_PREFIX = "vote."
#: the prefixes of the counters kept out of the ledger line
UNLEDGERED = (MEM_PREFIX, VOTE_PREFIX)
#: a sample's parts, in bytes (None: not readable on this host)
MEM_PARTS = (
    "rss",  # resident set (/proc/self/statm)
    "rss_anon", "rss_file", "rss_shmem",  # its split (/proc/self/status; see _MemProbe)
    "malloc_in_use", "malloc_free",  # glibc mallinfo2: uordblks + hblkhd, fordblks
    "pinned",  # pinned host memory: the CUDA host allocator's, else the staging's
    "pinned_staging",  # the overlap workers' staging buffers (a part of `pinned`)
    "ingest_reserved", "ingest_written",  # live ColumnarBatch buffers: reserved, written
    "inflight",  # batches between encode and retire: encoded arrays, wires, records
    "sort_buffer",  # records the external sort holds in RAM
    "genome", "genome_shared",  # RefStore codes; the part handed in by the caller
)
#: the parts the program holds on purpose: host_live
MEM_LIVE_PARTS = ("ingest_written", "inflight", "pinned", "sort_buffer", "genome")
#: the parts the program registers (the rest are read from the process)
_MEM_HELD = ("pinned_staging", "ingest_reserved", "ingest_written", "inflight", "sort_buffer",
             "genome", "genome_shared")


class MemRecord(NamedTuple):
    """One memory sample in the armed timeline."""

    stage: str
    where: str  # 'start', 'retire', 'sort', 'sort_end'
    thread: str
    batch: int | None
    t_ns: int  # time.time_ns(), the spans' clock
    parts: dict  # MEM_PARTS -> bytes or None


class _MemLive:
    """Bytes the program holds, by part: each registered owner counts
    until it is collected (a weakref callback, on whichever thread drops
    it last); a gauge (MemGauge) moves its own under the same lock.
    Locked reentrantly: a collection inside a locked block may run a
    callback on the same thread."""

    def __init__(self):
        self._lock = threading.RLock()
        self.bytes = dict.fromkeys(_MEM_HELD, 0)
        self._refs: dict = {}  # id(owner) -> (weakref, {part: bytes})

    def track(self, owner, parts: dict) -> bool:
        key = id(owner)
        with self._lock:
            if key in self._refs:
                return False
            self._refs[key] = (weakref.ref(owner, lambda _r, k=key: self._release(k)), parts)
            for part, n in parts.items():
                self.bytes[part] += n
        return True

    def _release(self, key: int) -> None:
        with self._lock:
            entry = self._refs.pop(key, None)
            if entry is not None:
                for part, n in entry[1].items():
                    self.bytes[part] -= n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self.bytes)


class _MemProbe:
    """The process-side readings, opened once per process: /proc/self
    statm and status by pread on kept descriptors, glibc's mallinfo2 by
    ctypes, torch's pinned host allocator where CUDA is up. A host whose
    status has no Rss* lines (a sandboxed kernel) gives rss_anon and
    rss_shmem None, and rss_file the size of the file-backed mappings of
    /proc/self/maps (~2.6 ms to read on the card's host), read again
    only when the dynamic loader's load or unload count has moved: such
    a host was seen to count a mapped file whole once it is touched, and
    the program maps no file but its libraries."""

    def __init__(self):
        self.pid = os.getpid()
        self.page = os.sysconf("SC_PAGE_SIZE")
        self._statm = os.open("/proc/self/statm", os.O_RDONLY)
        self._status = os.open("/proc/self/status", os.O_RDONLY)
        self.split = b"RssFile:" in os.pread(self._status, 8192, 0)
        self.mapped_file = None
        self._mapped_at = None  # the loader's counts when mapped_file was read
        self._mallinfo2 = _mallinfo2()
        self._loads = _loader_counts()

    def close(self) -> None:
        os.close(self._statm)
        os.close(self._status)

    def rss(self) -> int:
        return int(os.pread(self._statm, 256, 0).split()[1]) * self.page

    def read(self, rss: int) -> dict:
        """The process-side parts, beside `rss` read just before."""
        out = {"rss": rss, "rss_anon": None, "rss_file": None, "rss_shmem": None}
        if self.split:
            for line in os.pread(self._status, 8192, 0).splitlines():
                if line.startswith(b"Rss"):
                    name, value = line.split(b":")
                    part = {b"RssAnon": "rss_anon", b"RssFile": "rss_file",
                            b"RssShmem": "rss_shmem"}.get(name)
                    if part is not None:
                        out[part] = int(value.split()[0]) * 1024
        else:
            loads = self._loads() if self._loads is not None else None
            if self.mapped_file is None or loads != self._mapped_at:
                self.mapped_file, self._mapped_at = _mapped_file_bytes(), loads
            out["rss_file"] = self.mapped_file
        out["malloc_in_use"] = out["malloc_free"] = None
        if self._mallinfo2 is not None:
            mi = self._mallinfo2()
            out["malloc_in_use"] = mi.uordblks + mi.hblkhd
            out["malloc_free"] = mi.fordblks
        return out


_LIBC = None


def _libc():
    """The process's C library (ctypes), loaded once."""
    global _LIBC
    if _LIBC is None:
        import ctypes

        _LIBC = ctypes.CDLL(None)
    return _LIBC


def _mallinfo2():
    """glibc's mallinfo2 (2.33+) with its struct, or None elsewhere."""
    import ctypes

    class Mallinfo2(ctypes.Structure):
        _fields_ = [(name, ctypes.c_size_t) for name in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks",
            "uordblks", "fordblks", "keepcost")]

    try:
        fn = _libc().mallinfo2
    except (OSError, AttributeError):
        return None
    fn.restype = Mallinfo2
    fn.argtypes = []
    return fn


def _loader_counts():
    """A function returning glibc's (objects loaded, unloaded) counts —
    dl_iterate_phdr's dlpi_adds / dlpi_subs, read from its first object —
    or None where the loader has no such counts."""
    import ctypes

    class DlPhdrInfo(ctypes.Structure):
        _fields_ = [("addr", ctypes.c_void_p), ("name", ctypes.c_char_p),
                    ("phdr", ctypes.c_void_p), ("phnum", ctypes.c_uint16),
                    ("adds", ctypes.c_ulonglong), ("subs", ctypes.c_ulonglong)]

    callback_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(DlPhdrInfo), ctypes.c_size_t,
                                  ctypes.c_void_p)
    seen: list = []

    def first(info, size, _data):
        if size >= ctypes.sizeof(DlPhdrInfo):
            seen.append((info.contents.adds, info.contents.subs))
        return 1  # stop after the first object

    try:
        iterate = _libc().dl_iterate_phdr
    except (OSError, AttributeError):
        return None
    iterate.restype = ctypes.c_int
    iterate.argtypes = [callback_t, ctypes.c_void_p]
    cb = callback_t(first)

    def counts():
        seen.clear()
        iterate(cb, None)
        return seen[0] if seen else None

    return counts if counts() is not None else None


def _mapped_file_bytes() -> int:
    """Bytes mapped from files (a path, not a device) in /proc/self/maps."""
    total = 0
    with open("/proc/self/maps", "rb") as fh:
        for line in fh:
            fields = line.split(maxsplit=5)
            path = fields[5] if len(fields) == 6 else b""
            if path.startswith(b"/") and not path.startswith(b"/dev/"):
                lo, hi = fields[0].split(b"-")
                total += int(hi, 16) - int(lo, 16)
    return total


def _pinned_bytes() -> int | None:
    """Bytes the CUDA caching host allocator holds (cached blocks stay
    pinned), or None where CUDA is not up in this process."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.host_memory_stats().get("allocated_bytes.current", 0))


_MEM_LIVE = _MemLive()
_MEM_PROBE: list = []  # [the process's _MemProbe], or [None] where /proc cannot be read
_MEM_PROBE_LOCK = threading.Lock()


def _mem_probe() -> _MemProbe | None:
    with _MEM_PROBE_LOCK:
        probe = _MEM_PROBE[0] if _MEM_PROBE else None
        if _MEM_PROBE and (probe is None or probe.pid == os.getpid()):
            return probe
        if probe is not None:  # a forked child: its own /proc/self
            probe.close()
        try:
            probe = _MemProbe()
        except OSError:
            probe = None
        _MEM_PROBE[:] = [probe]
        return probe


def array_owner(a):
    """The ndarray that owns `a`'s buffer (or wraps a foreign one)."""
    import numpy as np

    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


def mem_track(owner, **parts: int) -> bool:
    """Count `owner`'s bytes under `parts` until it is collected; an
    owner already counted is not counted again (returns False)."""
    return _MEM_LIVE.track(owner, parts)


def mem_track_arrays(part: str, *objs) -> None:
    """Count the numpy arrays among `objs` and among their attributes
    (one level of dataclasses below, e.g. a batch's packed rows) under
    `part`, each by the array that owns its buffer, until collected; a
    buffer already counted (an ingest batch's, under its own part) is
    not counted again."""
    import numpy as np

    def arrays(obj, depth):
        if isinstance(obj, np.ndarray):
            yield obj
        elif depth and hasattr(obj, "__dataclass_fields__"):
            for v in vars(obj).values():
                yield from arrays(v, depth - 1)

    for obj in objs:
        for a in arrays(obj, 2):
            owner = array_owner(a)
            _MEM_LIVE.track(owner, {part: owner.nbytes})


class MemGauge:
    """A part held as a running byte count its holder sets (the sort's
    run buffer); close() takes it back to 0."""

    __slots__ = ("part", "n")

    def __init__(self, part: str):
        self.part = part
        self.n = 0

    def set(self, n: int) -> None:
        with _MEM_LIVE._lock:
            _MEM_LIVE.bytes[self.part] += n - self.n
            self.n = n

    def close(self) -> None:
        self.set(0)


def mem_sample(metrics: "Metrics", where: str) -> dict | None:
    """One sample of the host memory account, booked on `metrics`
    (Metrics.mem_peak) and, armed, kept in the timeline; returns it
    (None where /proc/self cannot be read). Its rss comes first: a
    sample that cannot be the stage's peak, with the timeline off, reads
    nothing more (the heap walk and the allocator's stats are the
    costly parts) and returns {'rss': ...} alone."""
    probe = _mem_probe()
    if probe is None:
        return None
    rss = probe.rss()
    tl = _TIMELINE
    if tl is None and rss <= metrics.mem_peak_rss():
        sample = {"rss": rss}
        metrics.mem_peak(sample)
        return sample
    sample = probe.read(rss)
    sample.update(_MEM_LIVE.snapshot())
    pinned = _pinned_bytes()
    sample["pinned"] = sample["pinned_staging"] if pinned is None else pinned
    metrics.mem_peak(sample)
    if tl is not None and len(tl.mem) < TIMELINE_CAP:
        tl.mem.append(MemRecord(metrics.stage, where, threading.current_thread().name,
                                getattr(_TL_LOCAL, "batch", None), time.time_ns(), sample))
    return sample


def _emit_timeline(records) -> None:
    """The records as 'span' lines under the process trace (proc_trace),
    with path, stage, batch, thread and cpu_s as fields (t0/t1 in
    seconds on time.time, like every span line); a parent not among them
    becomes the trace's root. No ledger sink: nothing."""
    if not records or stats_sink() is None:
        return
    root = proc_trace()
    ids = {r.span for r in records}
    for r in records:
        emit("span", {
            "name": r.name, "trace": root["trace"], "span": r.span,
            "parent": r.parent if r.parent in ids else root["span"],
            "t0": round(r.t0_ns / 1e9, 6), "t1": round(r.t1_ns / 1e9, 6),
            "dur_s": round((r.t1_ns - r.t0_ns) / 1e9, 6), "path": r.path, "stage": r.stage,
            "batch": r.batch, "thread": r.thread,
            "cpu_s": None if r.cpu_ns is None else round(r.cpu_ns / 1e9, 6),
        })


def _chrome_events(records, base_ns: int) -> list:
    """The records as Chrome trace complete events ('X', microseconds
    from `base_ns`), one lane (tid) per thread, named 'spans <thread>'."""
    pid = os.getpid()
    lanes: dict = {}
    out: list = []
    for r in records:
        tid = lanes.get(r.thread)
        if tid is None:
            tid = lanes[r.thread] = 1_000_000 + len(lanes)
            out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                        "args": {"name": f"spans {r.thread}"}})
        out.append({"ph": "X", "name": r.name, "cat": "bsseq_span", "pid": pid, "tid": tid,
                    "ts": (r.t0_ns - base_ns) / 1e3, "dur": (r.t1_ns - r.t0_ns) / 1e3,
                    "args": {"path": r.path, "stage": r.stage, "batch": r.batch,
                             "span": r.span, "parent": r.parent,
                             "cpu_ms": None if r.cpu_ns is None else r.cpu_ns / 1e6}})
    return out


def _chrome_mem_events(samples, base_ns: int) -> list:
    """The memory samples as Chrome trace counter events ('C'), one
    counter per stage, its parts in MiB."""
    pid = os.getpid()
    return [{"ph": "C", "name": f"host memory {m.stage}", "pid": pid,
             "ts": (m.t_ns - base_ns) / 1e3,
             "args": {p: v / 2**20 for p, v in m.parts.items() if v is not None}}
            for m in samples]


def _add_to_chrome_trace(path: str, records, mem=()) -> None:
    """Append the records' events, and the memory samples' counters, to an
    exported Chrome trace (its `baseTimeNanoseconds` is the origin of its
    microsecond `ts`)."""
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"].extend(_chrome_events(records, base) + _chrome_mem_events(mem, base))
    with open(path, "w") as fh:
        json.dump(doc, fh)


def stderr_line(msg: str) -> None:
    """One operator-facing line on stderr."""
    print(msg, file=sys.stderr, flush=True)


def event(name: str, fields: dict, job: str | None = None) -> None:
    """An event the JAX package writes to its run ledger: the ledger line
    (`emit`), and one stderr line `<name> {json}` so that a checkpoint
    discard or a shard quarantine is never silent, ledger or not."""
    emit(name, fields, job=job)
    stderr_line(f"{name} {json.dumps(fields, sort_keys=True, default=str)}")


# ---------------------------------------------------------------------------
# Sinks.


def stats_sink() -> str | None:
    """Where ledger lines go: '-' (stderr), a path, or None (disabled)."""
    return os.environ.get("BSSEQ_TPU_STATS") or None


def job_sink_dir() -> str | None:
    """Directory of the per-job sub-sinks (BSSEQ_TPU_STATS_JOBS): every
    job-tagged line is mirrored to <dir>/<job>.jsonl."""
    return os.environ.get("BSSEQ_TPU_STATS_JOBS") or None


def replica_sink_dir() -> str | None:
    """Directory of the per-replica sub-sinks (BSSEQ_TPU_STATS_REPLICAS)."""
    return os.environ.get("BSSEQ_TPU_STATS_REPLICAS") or None


def worker_sink_dir() -> str | None:
    """Directory of the per-worker sub-sinks (BSSEQ_TPU_STATS_WORKERS):
    an elastic worker's lines are mirrored to <dir>/<worker>.jsonl."""
    return os.environ.get("BSSEQ_TPU_STATS_WORKERS") or None


def trace_dir() -> str | None:
    """Where `maybe_trace` writes (BSSEQ_TPU_TRACE), or None."""
    return os.environ.get("BSSEQ_TPU_TRACE") or None


def _sub_sink(directory: str | None, key: str) -> str | None:
    """<directory>/<key>.jsonl, or None when the sub-sink is off; the key
    is sanitized so a hostile tag cannot leave the directory."""
    if directory is None:
        return None
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in str(key)) or "_"
    return os.path.join(directory, f"{safe}.jsonl")


def job_sink(job: str) -> str | None:
    return _sub_sink(job_sink_dir(), job)


def replica_id() -> str | None:
    """This process's fleet replica identity (BSSEQ_TPU_REPLICA_ID, set by
    serve.fleet when it spawns a replica): stamped on every line."""
    return os.environ.get("BSSEQ_TPU_REPLICA_ID") or None


def replica_sink(replica: str) -> str | None:
    return _sub_sink(replica_sink_dir(), replica)


def worker_id() -> str | None:
    """This process's worker identity (BSSEQ_TPU_WORKER_ID): stamped on
    every line."""
    return os.environ.get("BSSEQ_TPU_WORKER_ID") or None


def worker_sink(worker: str) -> str | None:
    return _sub_sink(worker_sink_dir(), worker)


class LedgerWriter:
    """Whole JSONL lines to one sink ('-' = stderr, else a file opened
    once in append mode, lazily), each flushed; a running SHA-256 over
    the bytes this process wrote backs `ledger_digest`."""

    def __init__(self, sink: str):
        self.sink = sink
        self._lock = threading.Lock()
        self._fh = None
        self._sha = hashlib.sha256()
        self.lines = 0
        self.manifest_written = False

    def write_line(self, line: str) -> None:
        data = line + "\n"
        with self._lock:
            self._sha.update(data.encode())
            self.lines += 1
            if self.sink == "-":
                sys.stderr.write(data)
                sys.stderr.flush()
                return
            if self._fh is None:
                self._fh = open(self.sink, "a")
            self._fh.write(data)
            self._fh.flush()

    def digest(self) -> str:
        with self._lock:
            return self._sha.hexdigest()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_WRITERS: dict[str, LedgerWriter] = {}
_WRITERS_LOCK = threading.Lock()


def _writer(sink: str) -> LedgerWriter:
    with _WRITERS_LOCK:
        w = _WRITERS.get(sink)
        if w is None:
            w = _WRITERS[sink] = LedgerWriter(sink)
        return w


def flush_sinks() -> None:
    """Flush every open ledger (also registered atexit)."""
    with _WRITERS_LOCK:
        writers = list(_WRITERS.values())
    for w in writers:
        w.flush()


def close_sinks() -> None:
    """Close and forget every writer (a later emit to the same sink
    reopens it in append mode)."""
    with _WRITERS_LOCK:
        writers = list(_WRITERS.values())
        _WRITERS.clear()
    for w in writers:
        w.close()


atexit.register(flush_sinks)


def ledger_digest(sink: str | None = None) -> str | None:
    """SHA-256 (hex) over the ledger bytes this process wrote to `sink`,
    or None when no ledger is active or nothing was written."""
    sink = sink if sink is not None else stats_sink()
    if sink is None:
        return None
    with _WRITERS_LOCK:
        w = _WRITERS.get(sink)
    return w.digest() if w is not None and w.lines else None


def emit(event: str, payload: dict, sink: str | None = None,
         job: str | None = None) -> None:
    """Write one JSON line {ts, event, **payload} to the configured sink
    and the sub-sinks that apply. Lines from threads other than the main
    one carry 'thread'; `job` tags the line (and mirrors it to the job's
    sub-sink); a replica or worker process stamps its id; the bound trace
    context stamps 'trace' and 'span' unless the payload carries its own.
    No sink, no line: one environment read."""
    sink = sink if sink is not None else stats_sink()
    sub = job_sink(job) if job is not None else None
    replica = replica_id()
    rsub = replica_sink(replica) if replica is not None else None
    worker = worker_id()
    wsub = worker_sink(worker) if worker is not None else None
    if sink is None and sub is None and rsub is None and wsub is None:
        return
    record = {"ts": round(time.time(), 3), "event": event}
    cur = threading.current_thread()
    if cur is not threading.main_thread():
        record["thread"] = cur.name
    record.update(payload)
    if job is not None:
        record["job"] = job
    if replica is not None:
        record["replica"] = replica
    if worker is not None:
        record["worker"] = worker
    ctx = getattr(_TRACE_TLS, "ctx", None)
    if ctx is not None and "trace" not in record:
        record["trace"] = ctx["trace"]
        record.setdefault("span", ctx["span"])
    if event != "flight_record":
        with _FLIGHT_LOCK:
            _flight_ring().append(record)
    line = json.dumps(record, default=str)
    if sink is not None:
        _writer(sink).write_line(line)
    for mirror in (sub, rsub, wsub):
        if mirror is not None:
            os.makedirs(os.path.dirname(mirror), exist_ok=True)
            _writer(mirror).write_line(line)


# ---------------------------------------------------------------------------
# Causal trace contexts: {trace, span}. `trace` is "<kind>-<key>-<6 hex>"
# (kind job | slice | proc), `span` the current node. Span times are wall
# clock (time.time), comparable across processes.

#: trace-id kinds whose trees must reach a terminal event (job retired,
#: slice merged); `observe check` exempts the others (proc overhead roots)
TRACE_TERMINAL_KINDS = frozenset({"job", "slice"})

_TRACE_TLS = threading.local()
_SPAN_LOCK = threading.Lock()
_SPAN_SEQ = [0]
_FLIGHT_LOCK = threading.Lock()
_FLIGHT: collections.deque | None = None
_PROC_TRACE: dict | None = None


def _next_span_id() -> str:
    """'<pid hex>.<seq hex>': unique across processes and ordered within one."""
    with _SPAN_LOCK:
        _SPAN_SEQ[0] += 1
        n = _SPAN_SEQ[0]
    return f"{os.getpid():x}.{n:x}"


def mint_trace(kind: str, key: str, job: str | None = None, **fields) -> dict:
    """A new trace context at an admission point; emits its zero-length
    root span (no parent) and returns {trace, span}."""
    ctx = {"trace": f"{kind}-{key}-{os.urandom(3).hex()}", "span": _next_span_id()}
    now = round(time.time(), 3)
    emit("span", {"name": f"{kind}_admit", "trace": ctx["trace"], "span": ctx["span"],
                  "t0": now, "t1": now, "dur_s": 0.0, **fields}, job=job)
    return ctx


def trace_kind(trace_id: str) -> str:
    """The kind segment of a trace id ('job-j0001-a1b2c3' -> 'job')."""
    return str(trace_id).split("-", 1)[0]


def current_trace() -> dict | None:
    """The thread's bound trace context (a copy), or None."""
    ctx = getattr(_TRACE_TLS, "ctx", None)
    return dict(ctx) if ctx is not None else None


@contextlib.contextmanager
def bind_trace(ctx: dict | None):
    """Bind `ctx` as the thread's trace context for the block (a falsy or
    malformed ctx binds nothing and yields None); restores the previous
    binding on exit."""
    if not isinstance(ctx, dict) or "trace" not in ctx or "span" not in ctx:
        yield None
        return
    bound = {"trace": str(ctx["trace"]), "span": str(ctx["span"])}
    prev = getattr(_TRACE_TLS, "ctx", None)
    _TRACE_TLS.ctx = bound
    try:
        yield bound
    finally:
        _TRACE_TLS.ctx = prev


def _span_line(name, trace, sid, parent, t0, t1, job, fields) -> None:
    emit("span", {"name": name, "trace": trace, "span": sid, "parent": parent,
                  "t0": round(t0, 3), "t1": round(t1, 3), "dur_s": round(t1 - t0, 6),
                  **fields}, job=job)


@contextlib.contextmanager
def span(name: str, ctx: dict | None = None, job: str | None = None, **fields):
    """Time a child span of `ctx` (default: the bound context), bound for
    the body; one completed 'span' line on exit. No context in scope: a
    no-op yielding None."""
    parent = ctx if ctx is not None else getattr(_TRACE_TLS, "ctx", None)
    if not isinstance(parent, dict) or "trace" not in parent:
        yield None
        return
    child = {"trace": parent["trace"], "span": _next_span_id()}
    t0 = time.time()
    prev = getattr(_TRACE_TLS, "ctx", None)
    _TRACE_TLS.ctx = child
    try:
        yield child
    finally:
        _TRACE_TLS.ctx = prev
        _span_line(name, child["trace"], child["span"], parent["span"], t0, time.time(),
                   job, fields)


def emit_span(name: str, t0: float, t1: float, ctx: dict | None = None,
              job: str | None = None, **fields) -> str | None:
    """A completed span for a window measured outside (e.g. a replica's
    spawn to its first answered ping); its id, or None with no context."""
    parent = ctx if ctx is not None else getattr(_TRACE_TLS, "ctx", None)
    if not isinstance(parent, dict) or "trace" not in parent:
        return None
    sid = _next_span_id()
    _span_line(name, parent["trace"], sid, parent["span"], t0, t1, job, fields)
    return sid


def proc_trace() -> dict:
    """The per-process overhead trace ('proc-pid<N>-...'), minted once:
    the parent of spans no one job owns (replica spawn, chunk retire)."""
    global _PROC_TRACE
    with _SPAN_LOCK:
        ctx = _PROC_TRACE
    if ctx is None:
        ctx = mint_trace("proc", f"pid{os.getpid()}")
        with _SPAN_LOCK:
            if _PROC_TRACE is None:
                _PROC_TRACE = ctx
            else:
                ctx = _PROC_TRACE
    return dict(ctx)


def reset_proc_trace() -> None:
    """Forget the process's overhead trace: the next `proc_trace` mints a
    new one, so its root lands in whatever ledger is open then (a driver
    that opens one ledger per run, as a separate process would)."""
    global _PROC_TRACE
    with _SPAN_LOCK:
        _PROC_TRACE = None


# ---------------------------------------------------------------------------
# The flight recorder.


def _flight_ring() -> collections.deque:
    global _FLIGHT
    if _FLIGHT is None:
        try:
            cap = int(os.environ.get("BSSEQ_TPU_FLIGHT_RING", "256"))
        except ValueError:
            cap = 256
        _FLIGHT = collections.deque(maxlen=max(cap, 1))
    return _FLIGHT


def flight_dump(reason: str) -> int:
    """The ring as ONE 'flight_record' line {reason, count, events},
    flushed; returns the count (0 and no line when no sink is armed)."""
    with _FLIGHT_LOCK:
        recent = list(_flight_ring())
    emit("flight_record", {"reason": reason, "count": len(recent), "events": recent})
    flush_sinks()
    return len(recent)


def install_flight_signal() -> None:
    """SIGUSR1 -> flight_dump (long-lived serve and router processes);
    best-effort off the main thread."""
    try:
        import signal

        signal.signal(signal.SIGUSR1, lambda _sig, _frm: flight_dump("sigusr1"))
    except (ValueError, OSError, AttributeError):
        pass


# ---------------------------------------------------------------------------
# The run manifest: the line that opens every ledger.

_GIT_REV_CACHE: list[str] = []


def _git_rev() -> str:
    if not _GIT_REV_CACHE:
        rev = "unknown"
        try:
            import subprocess

            repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            cp = subprocess.run(["git", "-C", repo, "rev-parse", "--short", "HEAD"],
                                capture_output=True, text=True, timeout=5)
            if cp.returncode == 0 and cp.stdout.strip():
                rev = cp.stdout.strip()
        except Exception:  # noqa: BLE001 — the manifest never fails a run
            pass
        _GIT_REV_CACHE.append(rev)
    return _GIT_REV_CACHE[0]


def config_digest(obj) -> str:
    """Stable short digest of a config (a dataclass, or anything with a
    repr): two ledgers with the same digest ran the same configuration."""
    import dataclasses

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        text = json.dumps(dataclasses.asdict(obj), sort_keys=True, default=repr)
    else:
        text = repr(obj)
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def _env_flags() -> dict:
    keys = sorted(k for k in os.environ
                  if k.startswith("BSSEQ_TPU_") or k in ("CUDA_VISIBLE_DEVICES",))
    return {k: os.environ[k] for k in keys}


def run_manifest(config_digest: str | None = None, component: str = "",
                 query_devices: bool = True, extra: dict | None = None) -> dict:
    """The manifest payload. `backend` is 'cuda' when a card is visible
    (device_count cards), else 'cpu'; query_devices=False leaves both
    'unqueried'."""
    from bsseqconsensusreads_tpu_torch import __version__

    backend, device_count = "unqueried", 0
    if query_devices:
        try:
            import torch

            device_count = torch.cuda.device_count()
            backend = "cuda" if device_count else "cpu"
        except Exception:  # noqa: BLE001 — the manifest never fails a run
            backend, device_count = "unknown", 0
    payload = {
        "git_rev": _git_rev(),
        "version": __version__,
        "backend": backend,
        "device_count": device_count,
        "config_digest": config_digest or "",
        "component": component,
        "pid": os.getpid(),
        "argv": " ".join(sys.argv[:6]),
        "env": _env_flags(),
    }
    if worker_id() is not None:
        payload["worker_id"] = worker_id()
    coord = os.environ.get("BSSEQ_TPU_COORDINATOR_ADDR")
    if coord:
        payload["coordinator_addr"] = coord
    if extra:
        payload.update(extra)
    return payload


def open_ledger(sink: str | None = None, config_digest: str | None = None,
                component: str = "", query_devices: bool = True, **extra) -> bool:
    """Write the run-manifest line that opens a ledger, once per sink per
    process; returns whether a sink is active."""
    sink = sink if sink is not None else stats_sink()
    if sink is None:
        return False
    w = _writer(sink)
    with w._lock:
        if w.manifest_written:
            return True
        w.manifest_written = True
    emit("run_manifest", run_manifest(config_digest, component, query_devices, extra or None),
         sink=sink)
    return True


@contextlib.contextmanager
def maybe_trace(label: str, directory: str | None = None):
    """A torch.profiler trace of the block when BSSEQ_TPU_TRACE (or
    `directory`) is set, else a no-op — the stages call it
    unconditionally. CPU activity always, CUDA activity (the kernels by
    name) when a card is visible; the Chrome trace lands under
    <dir>/<label>/ as trace_<pid>_<n>.json."""
    directory = directory if directory is not None else trace_dir()
    if not directory:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(directory, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with _TRACE_SEQ_LOCK:
        _TRACE_SEQ[0] += 1
        n = _TRACE_SEQ[0]
    prof = profile(activities=activities)
    with timeline() as tl, prof:
        yield
    out = os.path.join(path, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(out)
    _add_to_chrome_trace(out, tl.records, tl.mem)
    _emit_timeline(tl.records)


_TRACE_SEQ_LOCK = threading.Lock()
_TRACE_SEQ = [0]


def emit_stage_stats(stage_stats: dict, sample: str | None = None,
                     job: str | None = None) -> None:
    """One 'stage_stats' line per stage (StageStats.as_dict)."""
    for stage, stats in stage_stats.items():
        payload = {"stage": stage, **stats.as_dict()}
        if sample:
            payload["sample"] = sample
        emit("stage_stats", payload, job=job)
