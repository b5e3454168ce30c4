"""Observability: per-stage metrics and the run ledger.

The port's counterpart of the JAX package's utils/observe.py.

* **Metrics** — named counters and nested, thread-aware phase timers for
  one stage, with the JAX package's `phase_summary` (host_s / device_s /
  stall_s / chip_busy / unattributed_s). Phases the stages time: ingest, encode, kernel
  (host-side dispatch: H2D copies and launches), device_wait (CUDA event
  sync — the device still owned the batch), fetch (D2H copy + unpack),
  host_vote (singleton host path), rawize (duplex raw units + strand
  calls), emit, sort_write (the output writer's sort, spill, merge and
  deflate), genome_load (the duplex wire's whole-genome read and upload,
  or the methyl accumulator's read, once per stage), methyl (the
  methylation planes peeled or computed on the host, and their tallies
  added), methyl_finalize (the tally merge and the bedMethyl / CX
  writes), stall (the dispatch thread blocked on a pool's future), idle
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
* **the flight recorder** — a bounded ring of the most recent records
  per process (BSSEQ_TPU_FLIGHT_RING, default 256), dumped as one
  'flight_record' line on SIGUSR1, on a failpoint `exit` and on an input
  error exit.

Activation is environment-driven, as in the JAX package:

  BSSEQ_TPU_STATS=-            ledger JSON lines to stderr
  BSSEQ_TPU_STATS=/path.jsonl  appended to a file
  BSSEQ_TPU_TRACE=/path/dir    wrap the molecular, duplex and fused
                               stages in a torch.profiler trace
                               (Chrome trace JSON; `maybe_trace`)

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
from dataclasses import dataclass, field

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
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            stack.pop()
            spans.pop()
            self._accumulate(name, path, dt, outermost)

    def _accumulate(self, name: str, path: str, dt: float, outermost: bool) -> None:
        """The one locked read-modify-write behind every timer entry point."""
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            rec = self.spans.get(path)
            if rec is None:
                self.spans[path] = [dt, 1]
            else:
                rec[0] += dt
                rec[1] += 1
            if outermost and threading.get_ident() == self._owner:
                self.owner_seconds[name] = self.owner_seconds.get(name, 0.0) + dt

    def add_seconds(self, name: str, dt: float) -> None:
        """Seconds measured elsewhere (a C call's own clock, a writer's
        post-stream share); a dotted name is booked as a sub-phase."""
        outermost = not self._stack() and "." not in name
        self._accumulate(name, name, dt, outermost)

    def add_sub_seconds(self, name: str, dt: float) -> None:
        """A share of time already booked under its parent phase; the name
        must be dotted (parent.child)."""
        if "." not in name:
            raise ValueError(f"sub-phase name must be dotted (parent.child), got {name!r}")
        self._accumulate(name, name, dt, outermost=False)

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
        with self._lock:
            out = dict(self.counters)
            out.update({f"{k}_seconds": round(v, 3) for k, v in self.seconds.items()})
        return out


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
    with prof:
        yield
    prof.export_chrome_trace(os.path.join(path, f"trace_{os.getpid()}_{n}.json"))


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
