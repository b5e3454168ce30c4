"""Observability: per-stage metrics and the run ledger.

The port's counterpart of the JAX package's utils/observe.py.

* **Metrics** — named counters and phase timers for one stage (the port's
  own, kept as it was). Phases the stages time: ingest, encode, kernel
  (host-side dispatch: H2D copies and launches), device_wait (CUDA event
  sync — the device still owned the batch), fetch (D2H copy + unpack),
  host_vote (singleton host path), rawize (duplex raw units + strand
  calls), emit, sort_write (the output writer's sort, spill, merge and
  deflate), genome_load (the duplex wire's whole-genome read and upload,
  or the methyl accumulator's read, once per stage), methyl (the
  methylation planes peeled or computed on the host, and their tallies
  added), methyl_finalize (the tally merge and the bedMethyl / CX
  writes), stall (the dispatch thread blocked on a pool's future),
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
  JAX package's event names and fields, so its utils/ledger_tools reads
  the port's ledgers.
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

#: phases whose seconds are device occupancy or the transfer around it
DEVICE_PHASES = frozenset({"kernel", "device_wait", "fetch"})


@dataclass
class Metrics:
    """Named counters + phase timers for one stage. Locked: the overlap
    and host pools' workers count and time into the stage's Metrics
    concurrently with the dispatch thread. Nested `timed` phases each
    record their own seconds; a phase timed on several threads at once
    sums their seconds (worker-busy time, not wall)."""

    counters: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_seconds(name, time.monotonic() - t0)

    def add_seconds(self, name: str, dt: float) -> None:
        """Seconds measured elsewhere (a C call's own clock): a dotted
        name ('sort_write.merge') marks a part of a phase timed whole."""
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + dt

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


def _sub_sink(env: str, key: str) -> str | None:
    """<$env>/<key>.jsonl, or None when the sub-sink is off; the key is
    sanitized so a hostile tag cannot leave the directory."""
    directory = os.environ.get(env) or None
    if directory is None:
        return None
    safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in str(key)) or "_"
    return os.path.join(directory, f"{safe}.jsonl")


def job_sink(job: str) -> str | None:
    return _sub_sink("BSSEQ_TPU_STATS_JOBS", job)


def replica_id() -> str | None:
    """This process's fleet replica identity (BSSEQ_TPU_REPLICA_ID, set by
    serve.fleet when it spawns a replica): stamped on every line."""
    return os.environ.get("BSSEQ_TPU_REPLICA_ID") or None


def replica_sink(replica: str) -> str | None:
    return _sub_sink("BSSEQ_TPU_STATS_REPLICAS", replica)


def worker_id() -> str | None:
    """This process's worker identity (BSSEQ_TPU_WORKER_ID): stamped on
    every line."""
    return os.environ.get("BSSEQ_TPU_WORKER_ID") or None


def worker_sink(worker: str) -> str | None:
    return _sub_sink("BSSEQ_TPU_STATS_WORKERS", worker)


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


def emit_stage_stats(stage_stats: dict, sample: str | None = None,
                     job: str | None = None) -> None:
    """One 'stage_stats' line per stage (StageStats.as_dict)."""
    for stage, stats in stage_stats.items():
        payload = {"stage": stage, **stats.as_dict()}
        if sample:
            payload["sample"] = sample
        emit("stage_stats", payload, job=job)
