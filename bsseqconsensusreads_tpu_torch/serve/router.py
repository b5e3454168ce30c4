"""The fleet's router tier: tenant routing over a replica fleet.

The port's copy of the JAX package's serve/router.py (the same placement,
shedding, forwarding, requeue, preemption, counters and ledger lines),
over the port's replicas (serve.fleet).

The router speaks the same serve protocol as a single replica — `cli
submit --socket tcp:host:port` cannot tell a fleet from one engine —
and owns three jobs a single process never had:

* **placement** — each submit is fingerprinted by its input identity
  (serve.jobs.input_fingerprint, the checkpoint's input digest). A repeat
  input is routed back to the replica that saw it last (`affinity_hits`
  — warm guard state, warm page cache, warm per-input compile shapes);
  a fresh input lands on the replica with the fewest outstanding jobs
  (`jobs_routed` counts every placement). Forwarding is retried under
  the `fleet_route` failpoint, so a transient route-path I/O error is a
  retry, not a refused tenant.
* **drain/handoff** — a monitor thread watches replica liveness. When
  a replica dies (crash, kill -9, the `fleet_replica_exit` failpoint), every
  job placed on it that the router has not yet seen retire is
  resubmitted to a survivor (`jobs_requeued`). Jobs are idempotent —
  a replica writes output via tmp+rename at job finish — so a requeued
  job's bytes are identical whether the dead replica had done none,
  half, or all of the work. Supervised replicas are respawned under
  the same id (`replica_restarts`) and rejoin placement warm via the
  shared compile cache.
* **reconciliation** — `stats` aggregates router counters with every
  live replica's own counters, and the fleet ledger carries
  `fleet_route`/`fleet_requeue` lines, so
  jobs_routed + jobs_requeued == sum of per-replica admissions is a
  checkable invariant, not a hope.

Client-visible job ids are router-scoped (`f0001`, ...); the mapping
to (replica, replica-local id) is router state and survives handoff —
a tenant's `wait` parked across a replica death completes against the
survivor without the tenant ever reconnecting.
"""

from __future__ import annotations

import hashlib
import subprocess
import threading
import time

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.serve import fleet as _fleet
from bsseqconsensusreads_tpu_torch.serve import jobs as _jobs
from bsseqconsensusreads_tpu_torch.serve import transport as _transport
from bsseqconsensusreads_tpu_torch.serve.server import ProtocolServer
from bsseqconsensusreads_tpu_torch.utils import observe

#: Terminal replica-side job states (serve.jobs.DONE / FAILED).
_TERMINAL = frozenset({"done", "failed"})


class RoutedJob:
    """Router-side view of one tenant job: the spec (kept verbatim for
    requeue), its affinity digest, and the current placement."""

    def __init__(self, rid: str, spec: dict, digest: str):
        self.rid = rid
        self.spec = spec
        self.digest = digest
        self.replica_id: str | None = None
        self.remote_id: str | None = None
        self.state = "routed"
        self.last: dict = {}
        self.requeues = 0
        self.submitted_s = time.monotonic()
        #: causal trace context minted at router admission; requeues and
        #: the replica-side job adopt it, so one tree spans every attempt
        self.trace: dict | None = None

    def snapshot(self) -> dict:
        out = dict(self.last)
        out.update(
            {
                "id": self.rid,
                "state": self.state if self.state in _TERMINAL
                else self.last.get("state", self.state),
                "replica": self.replica_id,
                "remote_id": self.remote_id,
                "requeues": self.requeues,
            }
        )
        if self.trace is not None:
            out["trace"] = self.trace["trace"]
        return out


class Router:
    """Placement + handoff over a fleet.ReplicaSet. Thread-safe: the
    server front dispatches from per-connection threads, the monitor
    runs on its own thread, all placement state sits under one lock."""

    def __init__(
        self,
        replicas: _fleet.ReplicaSet,
        *,
        affinity: bool = True,
        respawn: bool = True,
        forward_retries: int = 3,
        forward_timeout: float = 60.0,
        monitor_interval: float = 0.25,
    ):
        self.fleet = replicas
        self.affinity_enabled = affinity
        self.respawn = respawn
        self.forward_retries = forward_retries
        self.forward_timeout = forward_timeout
        self.monitor_interval = monitor_interval
        self._lock = threading.Lock()
        self._jobs: dict[str, RoutedJob] = {}
        self._affinity: dict[str, str] = {}  # digest -> replica id
        self._seq = 0
        self.counters = {
            "jobs_routed": 0,
            "jobs_requeued": 0,
            "affinity_hits": 0,
            "replica_restarts": 0,
            "jobs_shed": 0,
        }
        self._stop = threading.Event()
        self._monitor_thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------

    def launch(self, ready_timeout: float = 180.0) -> "Router":
        self.fleet.launch()
        self.fleet.wait_ready(timeout=ready_timeout)
        # the single liveness monitor: it owns requeue/respawn and takes
        # self._lock for every shared mutation
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="fleet-monitor", daemon=True
        )
        self._monitor_thread.start()
        return self

    def shutdown(self, drain_timeout: float = 120.0) -> None:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)
        self.fleet.stop(drain_timeout=drain_timeout)
        observe.emit("fleet_counters", dict(self.counters))
        observe.flush_sinks()

    # -- placement -------------------------------------------------------

    @staticmethod
    def _digest(spec: dict) -> str:
        """The affinity key: the input-fingerprint identity
        (path+bytes+mtime), digested. Unstat-able inputs still route
        (admission will refuse them at the replica, with the reason)."""
        try:
            fp = _jobs.input_fingerprint(str(spec.get("input", "")))
        except OSError:
            fp = {"path": str(spec.get("input", ""))}
        text = f"{fp.get('path')}|{fp.get('bytes')}|{fp.get('mtime')}"
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    def _outstanding(self, replica_id: str) -> int:
        return sum(
            1
            for j in self._jobs.values()
            if j.replica_id == replica_id and j.state not in _TERMINAL
        )

    def _place(self, digest: str) -> tuple[_fleet.Replica, bool]:
        """Choose a live replica under the lock: affinity first, else
        least outstanding. Raises FleetError with no survivors."""
        alive = self.fleet.alive()
        if not alive:
            raise _fleet.FleetError("no live replicas")
        if self.affinity_enabled:
            want = self._affinity.get(digest)
            if want is not None:
                for replica in alive:
                    if replica.rid == want:
                        return replica, True
        replica = min(
            alive, key=lambda r: (self._outstanding(r.rid), r.rid)
        )
        return replica, False

    def submit(self, spec: dict) -> dict:
        self._shed_check()
        digest = self._digest(spec)
        with self._lock:
            self._seq += 1
            job = RoutedJob(f"f{self._seq:04d}", dict(spec), digest)
            self._jobs[job.rid] = job
        # router admission is THE mint point for a fleet job's trace:
        # the context rides every forward (original and requeued) so the
        # replica-side job joins the same causal tree
        job.trace = observe.current_trace() or observe.mint_trace(
            "job", job.rid
        )
        resp = self._route(job, exclude=None)
        if not resp.get("ok"):
            with self._lock:
                job.state = "failed"
                job.last = {"error": resp.get("error")}
            return resp
        return {"ok": True, "job": job.snapshot()}

    def _shed_check(self) -> None:
        """Router-tier overload watermark (BSSEQ_TPU_ADMIT_WATERMARK,
        disabled when unset): at or above `watermark` open routed jobs,
        admission sheds with the typed `overloaded` refusal + a backlog-
        proportional retry hint instead of piling more forwards onto a
        fleet that is already behind."""
        watermark = _jobs.admit_watermark(0)
        if not watermark:
            return
        with self._lock:
            depth = sum(
                1 for j in self._jobs.values() if j.state not in _TERMINAL
            )
            if depth < watermark:
                return
            self.counters["jobs_shed"] += 1
        retry = round(min(5.0, max(0.05, 0.02 * depth)), 3)
        observe.emit(
            "jobs_shed",
            {"depth": depth, "watermark": watermark,
             "retry_after_s": retry},
        )
        err = _transport.TransportError(
            f"router at depth {depth} >= watermark {watermark}; job shed",
            reason="overloaded",
        )
        err.retry_after_s = retry
        raise err

    def _route(self, job: RoutedJob, exclude: str | None) -> dict:
        """Place + forward one job, retrying transient route errors and
        falling through to other replicas on hard ones."""
        last_error = "no live replicas"
        last_shed: dict | None = None
        tried: set[str] = set([exclude] if exclude else [])
        for _ in range(max(1, len(self.fleet.replicas)) * 2):
            with self._lock:
                try:
                    replica, was_affinity = self._place(job.digest)
                except _fleet.FleetError as exc:
                    return {"ok": False, "error": str(exc)}
                if replica.rid in tried:
                    # every untried survivor refused: give up with the
                    # last refusal (admission errors are the tenant's)
                    alive = {r.rid for r in self.fleet.alive()}
                    if alive <= tried:
                        if last_shed is not None:
                            return last_shed
                        return {"ok": False, "error": last_error}
                    # fall through the affinity pin to a fresh replica
                    fresh = [
                        r for r in self.fleet.alive() if r.rid not in tried
                    ]
                    replica = min(
                        fresh,
                        key=lambda r: (self._outstanding(r.rid), r.rid),
                    )
                    was_affinity = False
            resp = self._forward(job, replica)
            if resp.get("ok"):
                remote = resp["job"]
                with self._lock:
                    job.replica_id = replica.rid
                    job.remote_id = remote.get("id")
                    job.state = "placed"
                    job.last = remote
                    self.counters["jobs_routed"] += 1
                    if was_affinity:
                        self.counters["affinity_hits"] += 1
                    if self.affinity_enabled:
                        self._affinity[job.digest] = replica.rid
                with observe.bind_trace(job.trace):
                    observe.emit(
                        "fleet_route",
                        {
                            "rjob": job.rid,
                            "replica_id": replica.rid,
                            "remote_id": job.remote_id,
                            "affinity": was_affinity,
                        },
                    )
                return resp
            last_error = str(resp.get("error"))
            if resp.get("guard") == "overloaded":
                # keep the TYPED refusal: the client's backoff loop
                # keys on `guard`/`retry_after_s`, not the message
                last_shed = resp
            tried.add(replica.rid)
        if last_shed is not None:
            return last_shed
        return {"ok": False, "error": last_error}

    def _forward(self, job: RoutedJob, replica: _fleet.Replica) -> dict:
        """One bounded-retry submit against one replica. The
        `fleet_route` failpoint sits inside the retry loop: an injected
        transient I/O error exercises exactly the retry the grammar
        promises."""
        last: Exception | None = None
        shed_resp: dict | None = None
        with observe.bind_trace(job.trace) as trace_ctx:
            for _ in range(self.forward_retries):
                try:
                    _failpoints.fire(
                        "fleet_route", stage="fleet", job=job.rid
                    )
                    # trace_ctx bound above rides the wire as `_trace`
                    resp = _transport.request(
                        replica.address,
                        {"op": "submit", "spec": job.spec},
                        timeout=self.forward_timeout,
                    )
                except _transport.TransportError as exc:
                    return {"ok": False, "error": f"refused: {exc}"}
                except (OSError, ConnectionError) as exc:
                    last = exc
                    if not replica.alive():
                        break
                    time.sleep(0.05)
                    continue
                if (not resp.get("ok")
                        and resp.get("guard") == "overloaded"):
                    # typed shed: back off by the replica's own hint
                    # (bounded by the retry budget), then try again —
                    # exhaustion falls back to _route's re-placement
                    shed_resp = resp
                    time.sleep(
                        min(2.0, float(resp.get("retry_after_s") or 0.1))
                    )
                    continue
                return resp
        if shed_resp is not None:
            return shed_resp
        return {"ok": False, "error": f"forward to {replica.rid}: {last}"}

    # -- tenant-facing ops ----------------------------------------------

    def job_status(self, rid: str) -> dict | None:
        with self._lock:
            job = self._jobs.get(rid)
            if job is None:
                return None
            replica_id, remote_id = job.replica_id, job.remote_id
            if job.state in _TERMINAL:
                return job.snapshot()
        replica = self.fleet.lookup(replica_id) if replica_id else None
        if replica is not None and replica.alive() and remote_id:
            try:
                resp = _transport.request(
                    replica.address,
                    {"op": "status", "job": remote_id},
                    timeout=10.0,
                )
                if resp.get("ok"):
                    self._absorb(job, resp["job"])
            except (OSError, ConnectionError):
                pass  # monitor will requeue; report the router's view
        with self._lock:
            return job.snapshot()

    def _absorb(self, job: RoutedJob, remote_status: dict) -> None:
        with self._lock:
            job.last = remote_status
            if remote_status.get("state") in _TERMINAL:
                job.state = remote_status["state"]

    def wait_job(self, rid: str, timeout: float | None = None) -> dict | None:
        with self._lock:
            if rid not in self._jobs:
                return None
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            with self._lock:
                job = self._jobs[rid]
                state = job.state
                replica_id, remote_id = job.replica_id, job.remote_id
            if state in _TERMINAL:
                return self.job_status(rid)
            replica = (
                self.fleet.lookup(replica_id) if replica_id else None
            )
            if replica is not None and replica.alive() and remote_id:
                slice_s = 1.0
                if deadline is not None:
                    slice_s = min(
                        slice_s, max(deadline - time.monotonic(), 0.05)
                    )
                try:
                    resp = _transport.request(
                        replica.address,
                        {
                            "op": "wait", "job": remote_id,
                            "timeout": slice_s,
                        },
                        timeout=slice_s + 10.0,
                    )
                    if resp.get("job", None):
                        self._absorb(job, resp["job"])
                except (OSError, ConnectionError):
                    # replica died under our wait: the monitor requeues,
                    # we keep waiting against the new placement
                    self._stop.wait(0.1)
            else:
                self._stop.wait(0.1)
            if deadline is not None and time.monotonic() >= deadline:
                return self.job_status(rid)

    def fleet_stats(self) -> dict:
        with self._lock:
            jobs = [j.snapshot() for j in self._jobs.values()]
            counters = dict(self.counters)
            affinity_size = len(self._affinity)
        per_replica: dict[str, dict] = {}
        for replica in self.fleet.replicas:
            entry: dict = {
                "address": replica.address,
                "alive": replica.alive(),
                "generation": replica.generation,
            }
            if replica.alive() and replica.address:
                try:
                    resp = _transport.request(
                        replica.address, {"op": "stats"}, timeout=10.0
                    )
                    if resp.get("ok"):
                        stats = resp["stats"]
                        entry["jobs"] = len(stats.get("jobs", []))
                        entry["counters"] = stats.get("counters", {})
                except (OSError, ConnectionError):
                    pass
            per_replica[replica.rid] = entry
        return {
            "jobs": jobs,
            "counters": counters,
            "affinity_entries": affinity_size,
            "replicas": per_replica,
        }

    def metrics_dict(self) -> dict:
        """Live gauges/counters for the `metrics` protocol op: placement
        state the router already owns — no replica round-trips, so a
        poller can hit this at high frequency without perturbing the
        fleet."""
        with self._lock:
            jobs = list(self._jobs.values())
            counters = dict(self.counters)
            affinity_size = len(self._affinity)
            inflight = {
                r.rid: self._outstanding(r.rid)
                for r in self.fleet.replicas
            }
        states: dict[str, int] = {}
        for j in jobs:
            st = j.state if j.state in _TERMINAL else "open"
            states[st] = states.get(st, 0) + 1
        return {
            "component": "router",
            "jobs_total": len(jobs),
            "jobs_open": states.get("open", 0),
            "jobs_by_state": states,
            "per_replica_inflight": inflight,
            "replicas_alive": len(self.fleet.alive()),
            "replicas_total": len(self.fleet.replicas),
            "affinity_entries": affinity_size,
            "counters": counters,
        }

    def drain(self, timeout: float | None = None) -> bool:
        """Wait until every routed job is terminal (requeues included),
        then drain the replicas themselves."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            with self._lock:
                open_jobs = [
                    j for j in self._jobs.values()
                    if j.state not in _TERMINAL
                ]
            if not open_jobs:
                break
            for job in open_jobs:
                self.job_status(job.rid)
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._stop.wait(0.2)
        return True

    # -- the monitor: liveness -> requeue -> respawn ---------------------

    def _monitor(self) -> None:
        while not self._stop.is_set():
            for replica in list(self.fleet.replicas):
                if replica.alive() or not replica.supervised:
                    continue
                self._handle_death(replica)
            self._stop.wait(timeout=self.monitor_interval)

    def _handle_death(self, replica: _fleet.Replica) -> None:
        rc = replica.proc.returncode if replica.proc else None
        observe.emit(
            "fleet_replica_down",
            {"replica_id": replica.rid, "returncode": rc},
        )
        with self._lock:
            orphans = [
                j for j in self._jobs.values()
                if j.replica_id == replica.rid and j.state not in _TERMINAL
            ]
            for job in orphans:
                job.state = "requeued"
                job.remote_id = None
        # requeue BEFORE respawn: survivors take the work now, the
        # respawned replica rejoins placement for future jobs only
        for job in orphans:
            with self._lock:
                job.requeues += 1
                self.counters["jobs_requeued"] += 1
                from_replica = replica.rid
            resp = self._route(job, exclude=replica.rid)
            # same trace id across attempts: the killed attempt's trace
            # ends in THIS requeue line, and the survivor's spans are
            # children of the same tree — `observe check` requires it
            with observe.bind_trace(job.trace):
                observe.emit(
                    "fleet_requeue",
                    {
                        "rjob": job.rid,
                        "from_replica": from_replica,
                        "to_replica": job.replica_id,
                        "ok": bool(resp.get("ok")),
                    },
                )
            if not resp.get("ok"):
                with self._lock:
                    job.state = "failed"
                    job.last = {"error": resp.get("error")}
        if self.respawn and not self._stop.is_set():
            # counted at initiation, not completion: the counter must
            # already reconcile while the new process is still booting
            with self._lock:
                self.counters["replica_restarts"] += 1
            try:
                self.fleet.restart(replica)
            except _fleet.FleetError as exc:
                observe.emit(
                    "fleet_restart_failed",
                    {"replica_id": replica.rid, "error": str(exc)},
                )

    # -- voluntary replica preemption ------------------------------------

    def preempt_replica(self, replica_id: str,
                        grace_s: float = 30.0) -> dict:
        """Voluntary drain of one replica: take it out of placement,
        migrate its non-retired jobs to survivors (the SAME requeue
        machinery a death uses — but loudly, `worker_preempted`, and
        with no respawn), then terminate and reap the process. The
        monitor never books this exit as a death because the replica is
        detached from supervision before the process goes down."""
        replica = self.fleet.lookup(replica_id)
        if replica is None:
            return {"ok": False, "error": f"unknown replica {replica_id!r}"}
        if not replica.alive():
            return {"ok": False,
                    "error": f"replica {replica_id} is not alive"}
        # detach FIRST: supervised -> False and alive() -> False, so the
        # monitor skips it and placement stops choosing it — without
        # this, the kill below would race _handle_death into a double
        # requeue plus an unwanted respawn
        proc = replica.proc
        address = replica.address
        replica.proc = None
        replica.address = ""
        with self._lock:
            orphans = [
                j for j in self._jobs.values()
                if j.replica_id == replica_id and j.state not in _TERMINAL
            ]
            for job in orphans:
                job.state = "requeued"
                job.remote_id = None
            # affinity pins to a leaving replica would re-place repeat
            # inputs onto nothing
            self._affinity = {
                d: r for d, r in self._affinity.items() if r != replica_id
            }
        observe.emit(
            "worker_preempted",
            {"worker": replica_id, "reason": "drain",
             "jobs_migrated": len(orphans)},
        )
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        elif proc is None and address:
            # attached (unsupervised) replica: ask it to drain itself;
            # its own supervisor owns the process
            try:
                _transport.request(
                    address,
                    {"op": "drain", "timeout": grace_s,
                     "sent_s": time.time()},
                    timeout=grace_s + 10.0,
                )
            except (OSError, ConnectionError):
                pass
        for job in orphans:
            with self._lock:
                job.requeues += 1
                self.counters["jobs_requeued"] += 1
            resp = self._route(job, exclude=replica_id)
            with observe.bind_trace(job.trace):
                observe.emit(
                    "fleet_requeue",
                    {
                        "rjob": job.rid,
                        "from_replica": replica_id,
                        "to_replica": job.replica_id,
                        "ok": bool(resp.get("ok")),
                    },
                )
            if not resp.get("ok"):
                with self._lock:
                    job.state = "failed"
                    job.last = {"error": resp.get("error")}
        return {"ok": True, "replica": replica_id,
                "migrated": len(orphans)}


class RouterServer(ProtocolServer):
    """The router's socket front: same ops as a single replica, plus
    `fleet` (router counters + per-replica reconciliation view)."""

    def __init__(self, router: Router, socket_path=None, *,
                 addresses=None, ready_file: str | None = None):
        super().__init__(socket_path, addresses=addresses,
                         ready_file=ready_file)
        self.router = router

    def _on_drain(self) -> None:
        self.router.drain(timeout=None)
        self.router.shutdown()

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True, "router": True}
        if op == "submit":
            return self.router.submit(req.get("spec") or {})
        if op == "status":
            st = self.router.job_status(str(req.get("job")))
            if st is None:
                return {
                    "ok": False,
                    "error": f"unknown job {req.get('job')!r}",
                }
            return {"ok": True, "job": st}
        if op == "wait":
            timeout = req.get("timeout")
            st = self.router.wait_job(
                str(req.get("job")),
                timeout=float(timeout) if timeout is not None else None,
            )
            if st is None:
                return {
                    "ok": False,
                    "error": f"unknown job {req.get('job')!r}",
                }
            return {"ok": st.get("state") in _TERMINAL, "job": st}
        if op in ("stats", "fleet"):
            return {"ok": True, "stats": self.router.fleet_stats()}
        if op == "metrics":
            return {"ok": True, "metrics": self.router.metrics_dict()}
        if op == "preempt":
            return self.router.preempt_replica(
                str(req.get("replica") or "")
            )
        if op == "drain":
            return self._drain_op(req)
        return {"ok": False, "error": f"unknown op {op!r}"}
