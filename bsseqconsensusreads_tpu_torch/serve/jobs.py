"""Serve job queue: specs, guard admission, fingerprints.

The port's copy of the JAX package's serve/jobs.py (the same specs,
admission refusals, exception types, ledger lines and job ids).

A job is one BAM in → one consensus BAM out, exactly the unit a
standalone `cli molecular` run processes — the serve engine's identity
contract is stated per job. Submission is two-phase:

    admit    cheap, synchronous, in the submitter's thread: the spec is
             validated, the guard policy resolved, the input's header
             structurally probed (guard admission — a BAM whose
             header doesn't parse is refused with AdmissionError before
             it can occupy a scheduler slot), and the job fingerprinted
             like a checkpoint (input {path, bytes, mtime} + config
             digest) so a ledger line proves WHAT was served.
    run      asynchronous: the scheduler claims the job, streams its
             families through a per-tenant guard, and retires its
             output (serve/scheduler.py).

The pending queue is BOUNDED (maxsize) and every blocking wait carries
a timeout.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import guard as _guard
from bsseqconsensusreads_tpu_torch.utils import observe


class AdmissionError(ValueError):
    """Submission refused at the door: bad spec, unreadable input, or a
    header that fails the structural probe."""


class QueueClosed(RuntimeError):
    """Submission refused because the engine is draining or stopped."""


#: admission watermark: queue depth at or above which submit sheds
#: instead of blocking (default: the queue's own maxsize — shedding
#: engages exactly where the blocking put would have stalled)
ENV_ADMIT_WATERMARK = "BSSEQ_TPU_ADMIT_WATERMARK"


def admit_watermark(default: int) -> int:
    """Queue-depth shed threshold; 0 disables shedding (legacy
    blocking-put behavior)."""
    raw = os.environ.get(ENV_ADMIT_WATERMARK)
    if raw is None:
        return default
    try:
        return max(0, int(raw))
    except ValueError:
        return default


class OverloadedError(RuntimeError):
    """Submission shed at the admission watermark. Carries the
    `retry_after_s` hint the typed `overloaded` transport refusal
    forwards to the client — backlog-proportional, so a storm's
    retries spread out instead of re-synchronizing."""

    def __init__(self, message: str, retry_after_s: float = 0.25):
        super().__init__(message)
        self.retry_after_s = retry_after_s


#: Job lifecycle states (monotonic: queued → running → done|failed).
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


@dataclass
class JobSpec:
    """What a tenant asks for. Per-job knobs are the *ingest-side* ones
    (guard policy, grouping, ingest engine) — device-side parameters
    (ConsensusParams, batch size, kernels) are engine-wide, because
    families from different jobs share device batches and a batch has
    one parameter set. A tenant needing different params runs a
    standalone `cli molecular`."""

    input: str
    output: str
    #: guard policy for THIS job's ingest (None → engine default /
    #: BSSEQ_TPU_INPUT_POLICY). One tenant reading under quarantine
    #: never loosens another tenant's strict admission.
    policy: str | None = None
    #: MI-group streaming strategy (None → engine default).
    grouping: str | None = None
    #: record ingest engine. Default python: the serve scheduler tags
    #: each family's MI with job provenance (scheduler.JobMi), which
    #: requires the Python group shape end-to-end.
    ingest: str = "python"
    #: library chemistry, per job (None → engine default). The serve
    #: engine runs the MOLECULAR stage, which is chemistry-invariant
    #: (conversion engages at the duplex stage) — so mixed-chemistry
    #: tenants share device batches safely and the field is admission
    #: validation + provenance: it joins the job fingerprint and the
    #: retire stats, so a ledger line proves what chemistry each
    #: tenant's downstream duplex/methyl run should declare.
    chemistry: str | None = None

    def as_dict(self) -> dict:
        return {
            "input": self.input,
            "output": self.output,
            "policy": self.policy,
            "grouping": self.grouping,
            "ingest": self.ingest,
            "chemistry": self.chemistry,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        try:
            spec = cls(
                input=str(d["input"]),
                output=str(d["output"]),
                policy=d.get("policy") or None,
                grouping=d.get("grouping") or None,
                ingest=str(d.get("ingest") or "python"),
                chemistry=d.get("chemistry") or None,
            )
        except KeyError as exc:
            raise AdmissionError(f"job spec missing {exc.args[0]!r}") from None
        return spec


def input_fingerprint(path: str) -> dict:
    """{path, bytes, mtime} — the checkpoint manifest's input identity
    (faults.guard.InputChangedError uses the same shape)."""
    st = os.stat(path)
    return {
        "path": os.path.abspath(path),
        "bytes": st.st_size,
        "mtime": int(st.st_mtime),
    }


class Job:
    """One admitted job: spec + fingerprint + lifecycle + the per-tenant
    accounting the scheduler fills in. State transitions happen under
    the owning Scheduler's lock; readers (server status threads) see a
    consistent snapshot via status()."""

    def __init__(self, job_id: str, spec: JobSpec, fingerprint: dict):
        self.id = job_id
        self.spec = spec
        self.fingerprint = fingerprint
        self.state = QUEUED
        self.error: str | None = None
        self.submitted_s = time.monotonic()
        self.started_s: float | None = None
        self.finished_s: float | None = None
        #: wall latency submit → retire
        self.latency_s: float | None = None
        self.families = 0
        self.consensus_out = 0
        #: signalled on done/failed — ServeEngine.wait() blocks on it
        self.done = threading.Event()
        #: causal trace context {trace, span}: adopted from the wire
        #: (router-minted, via the bound `_trace`) or minted at admission
        self.trace: dict | None = None
        # -- scheduler-owned plumbing (set when the job goes RUNNING) --
        self.stats = None          # per-job StageStats
        self.q: queue.Queue | None = None  # bounded family queue
        self.header = None         # input BAM header (reader thread)
        self.exhausted = False     # EOS dequeued by the merged source
        self.last_chunk: int | None = None  # highest chunk index holding
        #                                     one of this job's families

    def status(self) -> dict:
        d = {
            "id": self.id,
            "state": self.state,
            "input": self.spec.input,
            "output": self.spec.output,
            "families": self.families,
            "consensus_out": self.consensus_out,
            "fingerprint": self.fingerprint,
        }
        if self.spec.chemistry is not None:
            d["chemistry"] = self.spec.chemistry
        if self.error is not None:
            d["error"] = self.error
        if self.latency_s is not None:
            d["latency_s"] = round(self.latency_s, 3)
        if self.trace is not None:
            d["trace"] = self.trace["trace"]
        return d


class JobQueue:
    """Bounded admission queue shared by submitters (server connection
    threads) and the scheduler (claims). Also the job registry — every
    job ever admitted stays resolvable by id for status/wait."""

    def __init__(self, max_pending: int = 64):
        self._pending: queue.Queue = queue.Queue(maxsize=max_pending)
        self._jobs: dict[str, Job] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._closed = False
        #: overload-shed accounting: every watermark refusal increments
        #: jobs_shed, and the `jobs_shed` ledger event count must
        #: reconcile against it (chaos drill overload_shed scenario)
        self.counters = {"jobs_shed": 0}

    # -- submission ------------------------------------------------------

    def submit(self, spec: JobSpec) -> Job:
        """Admit one job (or raise AdmissionError/QueueClosed). Runs in
        the submitter's thread: validation and the header probe cost the
        tenant who submitted, never the scheduler loop."""
        shed: tuple[int, int] | None = None
        with self._lock:
            if self._closed:
                raise QueueClosed("serve engine is draining; job refused")
            # overload watermark: shed ABOVE capacity instead of
            # blocking the submitter's connection thread against a full
            # queue — the typed refusal carries a backlog-proportional
            # retry hint, so a storm spreads out instead of stacking up
            depth = self._pending.qsize()
            watermark = admit_watermark(self._pending.maxsize)
            if watermark and depth >= watermark:
                self.counters["jobs_shed"] += 1
                shed = (depth, watermark)
            else:
                self._seq += 1
                job_id = f"j{self._seq:04d}"
        if shed is not None:
            depth, watermark = shed
            retry = round(min(5.0, max(0.05, 0.02 * depth)), 3)
            observe.emit(
                "jobs_shed",
                {"depth": depth, "watermark": watermark,
                 "retry_after_s": retry},
            )
            raise OverloadedError(
                f"admission queue at depth {depth} >= watermark "
                f"{watermark}; job shed", retry_after_s=retry,
            )
        _failpoints.fire("serve_submit", stage="serve", job=job_id)
        self._admit(spec)
        fp = {
            "input": input_fingerprint(spec.input),
            "config": observe.config_digest(spec.as_dict()),
        }
        job = Job(job_id, spec, fp)
        # trace admission: adopt the submitter's context (a router-minted
        # trace that rode the wire and was bound around dispatch) or mint
        # a fresh job trace — either way the job carries ONE causal tree
        # id for its whole life across processes
        trace_ctx = observe.current_trace()
        if trace_ctx is None:
            trace_ctx = observe.mint_trace("job", job_id, job=job_id)
        job.trace = trace_ctx
        with self._lock:
            if self._closed:
                raise QueueClosed("serve engine is draining; job refused")
            self._jobs[job_id] = job
        with observe.bind_trace(trace_ctx):
            observe.emit(
                "job_admitted",
                {
                    "input": spec.input,
                    "output": spec.output,
                    "policy": _guard.resolve_policy(spec.policy),
                    "fingerprint": fp,
                },
                job=job_id,
            )
        while True:
            try:
                self._pending.put(job, timeout=0.25)
                return job
            except queue.Full:
                with self._lock:
                    closed = self._closed
                if closed:
                    raise QueueClosed(
                        "serve engine is draining; job refused"
                    ) from None

    def _admit(self, spec: JobSpec) -> None:
        """guard admission: resolve the policy (typo'd policies are
        refused here, not deep in a reader thread) and structurally
        probe the input header. Mid-file corruption is NOT probed — that
        is the per-tenant guard's job during ingest, under the job's own
        policy (strict fails the job; quarantine sidecars and
        proceeds)."""
        try:
            _guard.resolve_policy(spec.policy)
        except ValueError as exc:
            raise AdmissionError(str(exc)) from None
        if spec.ingest not in ("auto", "native", "python"):
            raise AdmissionError(f"unknown ingest {spec.ingest!r}")
        if spec.chemistry not in (None, "bisulfite", "emseq", "none"):
            raise AdmissionError(f"unknown chemistry {spec.chemistry!r}")
        if spec.grouping not in (None, "gather", "adjacent", "coordinate"):
            raise AdmissionError(f"unknown grouping {spec.grouping!r}")
        if not spec.output:
            raise AdmissionError("job spec needs an output path")
        try:
            st = os.stat(spec.input)
        except OSError as exc:
            raise AdmissionError(f"input unreadable: {exc}") from None
        if st.st_size == 0:
            raise AdmissionError(f"input empty: {spec.input}")
        from bsseqconsensusreads_tpu_torch.io.bam import BamReader

        try:
            reader = BamReader(spec.input)
        except Exception as exc:  # any header parse failure is refusal
            raise AdmissionError(
                f"input header failed admission: {exc}"
            ) from None
        try:
            reader.close()
        # graftlint: disable=swallowed-exception -- the admission error above is what
        # the caller sees; closing a half-open reader adds nothing
        except Exception:
            pass

    # -- scheduler side --------------------------------------------------

    def claim(self) -> Job | None:
        """Pop the next queued job, or None (never blocks — the
        scheduler polls between batches)."""
        try:
            return self._pending.get_nowait()
        except queue.Empty:
            return None

    def close(self) -> None:
        """Stop admitting (drain). Already-queued jobs still run."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def pending_count(self) -> int:
        return self._pending.qsize()

    # -- registry --------------------------------------------------------

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())
