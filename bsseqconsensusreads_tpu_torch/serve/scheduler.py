"""Continuous-batching scheduler: many jobs, one resident engine.

The port's counterpart of the JAX package's serve/scheduler.py. One
`call_molecular_batches` generator stays alive for the life of the
server — on the card its vote kernels (seg_vote's packed molecular
route), the cached log-likelihood and qual tables, the overlap workers'
CUDA streams and pinned staging and the host pool are loaded and warmed
ONCE — and is fed by a multi-job GroupSource that packs MI families
*from different jobs* into the same device chunks:

    per-job reader threads          the merged source (engine thread)
    ───────────────────────         ──────────────────────────────────
    guarded ingest → families  ──►  bounded queue ─┐
    guarded ingest → families  ──►  bounded queue ─┼─► round-robin pull
    guarded ingest → families  ──►  bounded queue ─┘   → tag JobMi
                                                       → yield family

Provenance: each family's MI is wrapped in JobMi — a str subclass, so
every downstream byte (wire planes, emitted qname) is identical to a
standalone run — carrying `.job`, read back at retire to demultiplex
the batch's records into per-job writers.

Identity: per-job output is byte-identical to a standalone
`cli molecular --batching sequential` run because (a) composition is
pinned sequential, so each job's families dispatch in its own input
order; (b) consensus is a pure per-family function (no cross-family
state), so neighbours from other jobs cannot perturb a family's
records; (c) emission is pinned to the Python emitter, whose per-family
record building is order-local.

Completion: the scheduler mirrors the sequential batcher's chunk
arithmetic (cut at batch_families, cut at FLUSH_BATCH) into a chunk →
{job} log, so "job J is done" is provable as "J's reader hit EOS and
every chunk holding a J family has retired" — exactly-once, no
sentinel records on the wire.

Isolation: one tenant's corrupt input fails only its own reader thread
(per-job Guard, per-job policy); a stalled tenant (failpoint
serve_ingest=stall@job=…) leaves its queue empty and the round-robin
simply passes it by; a family bomb is capped by the tenant's own
guard. Idle periods cut partial chunks (FLUSH_BATCH) and then emit an
empty sync chunk so in-flight batches retire instead of waiting for
load — a lone job's latency is bounded by its own work.

Every queue here is bounded and every blocking wait carries a timeout.

One divergence from the JAX package: with host workers on, the engine's
encode prefetch (calling._hp_prefetch) does not pull past the source's
empty sync chunk, so the sync chunk retires what is in flight and the
engine drains. The JAX package's prefetch pulls one chunk past it; its
engine stays blocked there after a drain unless BSSEQ_TPU_HOST_WORKERS=0
(ROADMAP queue 3). Device-side knobs take `device` ('cuda' by default,
'cpu' for the plain PyTorch versions) where the JAX package takes
`vote_kernel`.
"""

from __future__ import annotations

import os
import queue
import threading
import time

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import guard as _guard
from bsseqconsensusreads_tpu_torch.pipeline import calling as _calling
from bsseqconsensusreads_tpu_torch.serve import jobs as _jobs
from bsseqconsensusreads_tpu_torch.utils import compilecache as _compilecache
from bsseqconsensusreads_tpu_torch.utils import observe


class JobMi(str):
    """An MI string tagged with the job that owns its family.

    str subclass: hashing, equality, slicing, and — decisively — the
    emitted consensus qname serialize identically to the plain MI, so
    provenance costs zero bytes on the wire and in the output BAM.
    ops.encode's Python path threads the object through FamilyMeta.mi
    into the emitted record's qname, where the retire demux reads
    `.job` back."""

    __slots__ = ("job",)


class _Shutdown(Exception):
    """Internal: a reader pump aborted because the engine is stopping."""


class Scheduler:
    """Owns the resident engine thread, the per-job reader pumps, and
    the chunk mirror that turns batch retirement into job completion.

    Device-side knobs (params, batch_families, max_window, kernels) are
    engine-wide; per-job knobs (guard policy, grouping, ingest) ride
    JobSpec. Composition is pinned `batching="sequential"` and emission
    `emit="python"` — the two pins the identity contract needs."""

    def __init__(
        self,
        job_queue: _jobs.JobQueue,
        params,
        *,
        mode: str = "unaligned",
        batch_families: int = 64,
        max_window: int = 4096,
        grouping: str = "coordinate",
        indel_policy: str = "drop",
        device=None,
        transport: str = "auto",
        mesh="auto",
        level: int = 6,
        max_active: int = 4,
        stride: int = 8,
        idle_wait_s: float = 0.02,
        family_queue_depth: int = 256,
    ):
        self.queue = job_queue
        self.params = params
        self.mode = mode
        self.batch_families = batch_families
        self.max_window = max_window
        self.grouping = grouping
        self.indel_policy = indel_policy
        self.device = device
        self.transport = transport
        self.mesh = mesh
        self.level = level
        self.max_active = max_active
        self.stride = max(1, stride)
        self.idle_wait_s = idle_wait_s
        self.family_queue_depth = family_queue_depth
        self.stats = _calling.StageStats(stage="serve")
        self._lock = threading.Lock()
        self._running: list[_jobs.Job] = []
        # chunk mirror: _chunks[i] = job ids whose families rode chunk i
        self._chunks: list[set] = []
        self._open_chunk: list[str] = []
        self._retired = 0
        self._drain = threading.Event()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self.engine_error: str | None = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            # the one resident engine thread: the batching state is
            # engine-thread-owned for its life
            # graftlint: owned-thread -- the one resident engine thread;
            # scheduler batching state is engine-thread-owned for its life
            self._thread = threading.Thread(
                target=self._run, name="serve-engine", daemon=True
            )
        self._thread.start()

    def drain(self, timeout: float | None = None) -> bool:
        """Stop admitting, run every already-admitted job to completion,
        stop the engine. Returns True when fully drained (False: the
        deadline passed with work still in flight — nothing is lost,
        the engine keeps running)."""
        self.queue.close()
        self._drain.set()
        self._wake.set()
        if self._thread is None:
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._thread.is_alive():
            self._thread.join(timeout=0.25)
            if deadline is not None and time.monotonic() >= deadline:
                return not self._thread.is_alive()
        return True

    def stop(self, timeout: float | None = 10.0) -> bool:
        """Drain, but also abort reader pumps blocked on full family
        queues (their jobs fail with 'engine shutdown')."""
        self._stop.set()
        return self.drain(timeout=timeout)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def counters(self) -> dict:
        return dict(self.stats.metrics.counters)

    # -- per-job reader pump --------------------------------------------

    def _start_job(self, job: _jobs.Job) -> None:
        with self._lock:
            job.state = _jobs.RUNNING
            job.started_s = time.monotonic()
        job.stats = _calling.StageStats(stage="molecular")
        job.q = queue.Queue(maxsize=self.family_queue_depth)
        job._eos = False
        job._writer = None
        job._spool = []
        job._tmp = job.spec.output + ".serve-tmp"
        job._dropped = 0
        self._running.append(job)
        # per-job reader pump: it owns this job's guard, reader and queue
        # alone and hands off through the bounded queue
        # graftlint: owned-thread -- per-job reader pump; it owns this
        # job's guard/reader/queue alone and hands off via the bounded q
        t = threading.Thread(
            target=self._pump, args=(job,),
            name=f"serve-ingest-{job.id}", daemon=True,
        )
        t.start()

    def _pump(self, job: _jobs.Job) -> None:
        """Reader thread: guarded ingest → tagged families → the job's
        bounded queue. Any failure is THIS tenant's failure: the error
        is recorded on the job and the engine never sees an exception,
        only an exhausted queue. The job's trace context is bound for
        the ingest so every line — and the 'ingest' span covering the
        guarded read — lands in the tenant's causal tree."""
        from bsseqconsensusreads_tpu_torch.pipeline.stages import (
            molecular_ingest_stream,
            open_guarded_reader,
        )

        guard = None
        reader = None
        err = None
        try:
            with observe.bind_trace(job.trace), \
                    observe.span("ingest", job=job.id):
                guard = _guard.Guard(
                    policy=job.spec.policy, stats=job.stats, job=job.id
                )
                reader = open_guarded_reader(job.spec.input, guard)
                job.header = reader.header
                grouping = job.spec.grouping or self.grouping
                records = molecular_ingest_stream(
                    job.spec.input, reader, job.stats,
                    ingest_choice=job.spec.ingest, grouping=grouping,
                    indel_policy=self.indel_policy, guard=guard,
                )
                groups = _guard.guard_groups(
                    _calling.stream_mi_groups(
                        records, grouping=grouping, stats=job.stats
                    ),
                    guard,
                )
                seq = 0
                for fam in groups:
                    if isinstance(fam, tuple):
                        mi, recs = fam
                    else:  # native FamilyRun: materialize the Python shape
                        mi, recs = fam.mi, list(fam.records)
                    seq += 1
                    _failpoints.fire(
                        "serve_ingest", stage="serve", job=job.id, batch=seq
                    )
                    tag = JobMi(mi)
                    tag.job = job.id
                    self._offer(job, (tag, recs))
        except _Shutdown:
            err = "engine shutdown"
        except BaseException as exc:  # tenant-scoped: never escapes
            err = f"{type(exc).__name__}: {exc}"
        finally:
            for closer in (guard, reader):
                try:
                    if closer is not None:
                        closer.close()
                except Exception:
                    pass
            if err is not None:
                with self._lock:
                    if job.error is None:
                        job.error = err
                with observe.bind_trace(job.trace):
                    observe.emit("job_failed", {"error": err}, job=job.id)
            job._eos = True
            self._wake.set()

    def _offer(self, job: _jobs.Job, item) -> None:
        while True:
            try:
                job.q.put(item, timeout=0.25)
                self._wake.set()
                return
            except queue.Full:
                if self._stop.is_set():
                    raise _Shutdown() from None

    # -- the merged multi-job source (engine thread) --------------------

    def _merged(self):
        """The GroupSource generator: round-robin over active jobs,
        `stride` families per job per pass, FLUSH_BATCH on idle. Runs in
        the engine thread — every mutation of the chunk mirror and job
        lifecycle it makes is single-threaded with the retire loop."""
        while True:
            self._admit()
            progressed = False
            for job in list(self._running):
                pulled = 0
                while pulled < self.stride:
                    try:
                        item = job.q.get_nowait()
                    except queue.Empty:
                        if job._eos and not job.exhausted:
                            job.exhausted = True
                            # pulled under the engine's 'ingest': a part of it
                            with self.stats.metrics.timed("ingest.sweep"):
                                self._sweep()
                        break
                    pulled += 1
                    progressed = True
                    self._track(job)
                    yield item
            if progressed:
                continue
            if self._open_chunk:
                # cut the partial chunk: families stop waiting for load
                self._cut()
                yield _calling.FLUSH_BATCH
                continue
            if self._retired < len(self._chunks):
                # in-flight batches and nothing new arriving: an empty
                # sync chunk drains the deferred-retire pipeline so
                # waiting tenants complete NOW
                self._chunks.append(set())
                yield _calling.FLUSH_BATCH
                continue
            if (
                self._drain.is_set()
                and not self._running
                and self.queue.pending_count() == 0
            ):
                return
            with self.stats.metrics.timed("ingest.idle"):
                self._wake.wait(self.idle_wait_s)
            self._wake.clear()

    def _admit(self) -> None:
        while len(self._running) < self.max_active:
            job = self.queue.claim()
            if job is None:
                return
            self._start_job(job)

    def _track(self, job: _jobs.Job) -> None:
        self._open_chunk.append(job.id)
        job.last_chunk = len(self._chunks)
        job.families += 1
        if len(self._open_chunk) >= self.batch_families:
            self._cut()

    def _cut(self) -> None:
        self._chunks.append(set(self._open_chunk))
        self._open_chunk = []

    # -- retire / demux (engine thread) ---------------------------------

    def _run(self) -> None:
        t0 = time.monotonic()
        # the engine thread's timeline is the one the 'serve' line closes
        self.stats.metrics.own_timeline()
        try:
            batches = _calling.call_molecular_batches(
                _calling.GroupSource(self._merged()),
                params=self.params,
                mode=self.mode,
                batch_families=self.batch_families,
                max_window=self.max_window,
                grouping=self.grouping,
                stats=self.stats,
                emit="python",      # identity pin: JobMi must survive emit
                batching="sequential",  # identity pin: per-job input order
                transport=self.transport,
                mesh=self.mesh,
                indel_policy=self.indel_policy,
                device=self.device,
                guard=None,         # guarding is per-tenant, in the pumps
            )
            for bi, recs in enumerate(batches):
                _failpoints.fire("serve_retire", stage="serve", batch=bi)
                # the fleet kill switch: exit:9@batch=N here is a
                # replica dying MID-JOB with retired batches unswept —
                # exactly the handoff the router must survive
                _failpoints.fire(
                    "fleet_replica_exit", stage="serve", batch=bi
                )
                with self.stats.metrics.timed("sort_write"):  # the tenants' writers
                    self._demux(bi, recs)
                    self._sweep()
        except BaseException as exc:
            with self._lock:
                self.engine_error = f"{type(exc).__name__}: {exc}"
        finally:
            self._finish_all()
            if not self.stats.wall_seconds:
                self.stats.wall_seconds = time.monotonic() - t0
            observe.emit_stage_stats({"serve": self.stats})
            observe.flush_sinks()

    def _demux(self, bi: int, recs: list) -> None:
        per_job: dict[str | None, list] = {}
        for rec in recs:
            per_job.setdefault(getattr(rec.qname, "job", None), []).append(rec)
        delivered = 0
        for jid, rl in per_job.items():
            job = self.queue.get(jid) if jid is not None else None
            if job is None or job.state != _jobs.RUNNING:
                # a failed tenant's in-flight families: records are
                # dropped, counted, never written
                self.stats.metrics.count("records_dropped", len(rl))
                continue
            self._write(job, rl)
            delivered += 1
        if delivered > 1:
            self.stats.metrics.count("batches_shared_jobs")
        if recs:
            self.stats.metrics.count("serve_batches")
            if observe.stats_sink() is not None:
                # link the shared device chunk into the span forest: a
                # point span under the process overhead trace naming the
                # tenants whose families rode it (the armed-sink guard
                # keeps the untraced hot path at one branch)
                now = time.time()
                observe.emit_span(
                    "chunk_retire", now, now, ctx=observe.proc_trace(),
                    batch=bi, jobs=sorted(
                        j for j in per_job if j is not None
                    ),
                )
        self._retired = bi + 1

    def _write(self, job: _jobs.Job, recs: list) -> None:
        if self.mode == "self":
            job._spool.extend(recs)
        else:
            if job._writer is None:
                from bsseqconsensusreads_tpu_torch.io.bam import BamWriter

                job._writer = BamWriter(
                    job._tmp, job.header, level=self.level
                )
            for rec in recs:
                job._writer.write(rec)
        job.consensus_out += len(recs)

    def _sweep(self) -> None:
        """Complete every job whose stream ended and whose last chunk
        retired (engine thread only). Failed jobs finalize immediately —
        their remaining in-flight records will be dropped at demux."""
        for job in list(self._running):
            if not job.exhausted:
                continue
            if job.error is not None:
                self._fail_job(job)
                continue
            if job.last_chunk is not None and job.last_chunk >= self._retired:
                continue  # families still in flight
            self._finish_job(job)

    def _finish_job(self, job: _jobs.Job) -> None:
        try:
            if self.mode == "self":
                from bsseqconsensusreads_tpu_torch.pipeline.extsort import (
                    write_batch_stream,
                )

                write_batch_stream(
                    iter([job._spool]), job.spec.output, job.header,
                    self.mode, level=self.level,
                )
                job._spool = []
            else:
                if job._writer is None:
                    from bsseqconsensusreads_tpu_torch.io.bam import BamWriter

                    job._writer = BamWriter(
                        job._tmp, job.header, level=self.level
                    )
                job._writer.close()
                job._writer = None
                os.replace(job._tmp, job.spec.output)
        except BaseException as exc:
            with self._lock:
                job.error = f"{type(exc).__name__}: {exc}"
            with observe.bind_trace(job.trace):
                observe.emit("job_failed", {"error": job.error}, job=job.id)
            self._fail_job(job)
            return
        self._running.remove(job)
        with self._lock:
            job.state = _jobs.DONE
            job.finished_s = time.monotonic()
            job.latency_s = job.finished_s - job.submitted_s
        with observe.bind_trace(job.trace):
            self._emit_job_stats(job)
            observe.emit(
                "job_complete",
                {
                    "output": job.spec.output,
                    "families": job.families,
                    "consensus_out": job.consensus_out,
                    "latency_s": round(job.latency_s, 3),
                },
                job=job.id,
            )
        job.done.set()

    def _fail_job(self, job: _jobs.Job) -> None:
        if job._writer is not None:
            try:
                job._writer.close()
            except Exception:
                pass
            job._writer = None
        try:
            if os.path.exists(job._tmp):
                os.remove(job._tmp)
        except OSError:
            pass
        job._spool = []
        if job in self._running:
            self._running.remove(job)
        with self._lock:
            job.state = _jobs.FAILED
            job.finished_s = time.monotonic()
            job.latency_s = job.finished_s - job.submitted_s
        self.stats.metrics.count("jobs_failed")
        with observe.bind_trace(job.trace):
            self._emit_job_stats(job)
        job.done.set()

    def _emit_job_stats(self, job: _jobs.Job) -> None:
        """One standalone-shaped 'stage_stats' ledger line per tenant,
        tagged job=<id> (mirrored to the BSSEQ_TPU_STATS_JOBS sub-sink).
        wall_seconds is the job's submit→done latency; phase seconds are
        deliberately absent — device time is shared engine property and
        lives on the stage='serve' line — so closure checks skip the
        unattributable split instead of failing it."""
        latency = job.latency_s or 0.0
        s = job.stats
        payload = {
            "stage": "molecular",
            "state": job.state,
            "records_in": s.records_in,
            **{k: s.counter(k) for k in (
                "records_seen", "records_quarantined", "records_repaired",
                "families_quarantined", "family_records_quarantined")},
            "families": job.families,
            "consensus_out": job.consensus_out,
            "wall_seconds": round(latency, 3),
            "families_per_second": (
                round(job.families / latency, 1) if latency else 0.0
            ),
            "queue_wait_s": round(
                (job.started_s or job.submitted_s) - job.submitted_s, 3
            ),
        }
        if job.spec.chemistry is not None:
            # provenance only: the molecular stage is chemistry-invariant
            # (conversion engages at the duplex stage), but the ledger
            # line records what each tenant's downstream run declared
            payload["chemistry"] = job.spec.chemistry
        observe.emit("stage_stats", payload, job=job.id)

    def _finish_all(self) -> None:
        """Engine end: on a clean drain every job already finalized; on
        an engine crash, fail whatever is left so no submitter blocks on
        a done-event that would never fire."""
        self._retired = len(self._chunks)
        self._sweep()
        err = self.engine_error or "serve engine stopped"
        for job in self.queue.jobs():
            if job.state in (_jobs.DONE, _jobs.FAILED):
                continue
            with self._lock:
                if job.error is None:
                    job.error = err
            with observe.bind_trace(job.trace):
                observe.emit("job_failed", {"error": job.error}, job=job.id)
            job.exhausted = True
            if job.state == _jobs.QUEUED:
                with self._lock:
                    job.state = _jobs.RUNNING  # so _fail_job books it
                job.stats = _calling.StageStats(stage="molecular")
                job._writer = None
                job._spool = []
                job._tmp = job.spec.output + ".serve-tmp"
            self._fail_job(job)
        _compilecache.publish(self.stats.metrics)
