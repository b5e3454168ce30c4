"""ServeEngine (in-process API) + ServeServer (socket protocol front).

The port's counterpart of the JAX package's serve/server.py: the same
engine API, protocol ops, replies and ledger lines; the engine runs on the
card unless it is given device='cpu'.

The engine is the embeddable form — tests and the tier-1 smoke drive
it directly: submit/wait/drain with no sockets. The server wraps it in
the serve protocol for `cli submit` / `cli serve-ctl`:

    one connection = one request = one JSON message each way

    {"op": "ping"}                          → {"ok": true, "pong": true}
    {"op": "submit", "spec": {...JobSpec}}  → {"ok": true, "job": {...}}
    {"op": "status", "job": "j0001"}        → {"ok": true, "job": {...}}
    {"op": "wait", "job": "j0001",
     "timeout": 600}                        → {"ok": true, "job": {...}}
    {"op": "stats"}                         → {"ok": true, "stats": {...}}
    {"op": "metrics"}                       → {"ok": true, "metrics": {...}}
                                              (live gauges/counters — the
                                              `observe top` poll surface)
    {"op": "drain", "timeout": 600}         → {"ok": true, "drained": b}
                                              (server exits afterwards)

Requests may carry a reserved ``_trace`` field (a {trace, span} context
injected by transport.request): the server binds it around dispatch so
every ledger line the op emits joins the sender's causal tree.

How the message crosses the wire is serve/transport.py's business: a
server listens on one or more addresses — ``unix:<path>`` (newline
JSONL) and/or ``tcp:host:port`` (length-framed,
optional TLS) — with identical semantics on every transport. Garbage
frames and oversized payloads are refused with typed GuardErrors and
ledgered (`serve_frame_refused`), never a crash.

Admission failures answer {"ok": false, "error": ...} — a refused job
is the submitter's problem, never the server's. SIGTERM/SIGINT request
a graceful drain: stop admitting, finish every admitted job, exit 0
(no admitted job is lost).

Each accept loop polls with a socket timeout and each connection rides
its own daemon thread, so a tenant parked on a long `wait` never
blocks another tenant's submit, and the loop itself waits only with
bounded timeouts.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import OrderedDict

from bsseqconsensusreads_tpu_torch.faults import netchaos
from bsseqconsensusreads_tpu_torch.serve import jobs as _jobs
from bsseqconsensusreads_tpu_torch.serve import scheduler as _scheduler
from bsseqconsensusreads_tpu_torch.serve import transport as _transport
from bsseqconsensusreads_tpu_torch.utils import compilecache as _compilecache
from bsseqconsensusreads_tpu_torch.utils import observe


class ServeEngine:
    """The resident engine: one JobQueue + one Scheduler, warm across
    jobs. Construct, `start()`, then submit/wait from any thread."""

    def __init__(
        self,
        params=None,
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
        max_pending: int = 64,
    ):
        if params is None:
            from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams

            params = ConsensusParams(min_reads=1)
        from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)  # the card unless 'cpu'; no fallback
        _compilecache.maybe_enable()
        self.queue = _jobs.JobQueue(max_pending=max_pending)
        self.scheduler = _scheduler.Scheduler(
            self.queue,
            params,
            mode=mode,
            batch_families=batch_families,
            max_window=max_window,
            grouping=grouping,
            indel_policy=indel_policy,
            device=device,
            transport=transport,
            mesh=mesh,
            level=level,
            max_active=max_active,
            stride=stride,
            idle_wait_s=idle_wait_s,
        )
        self._started = False
        self._started_monotonic: float | None = None
        self._start_lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "ServeEngine":
        with self._start_lock:
            if not self._started:
                self._started = True
                self._started_monotonic = time.monotonic()
                self.scheduler.start()
        return self

    def warmup(self) -> None:
        """Build and launch the engine's kernels on a synthetic family
        BEFORE the first tenant arrives: two families of two templates per
        strand through a separate one-shot engine call (on the card:
        seg_vote's packed molecular route, with the vote library loaded —
        built, or found in BSSEQ_TPU_COMPILE_CACHE_DIR — and the tables
        uploaded). The resident generator itself stays untouched. Its
        compile-cache counts are booked into the engine's counters."""
        import numpy as np

        from bsseqconsensusreads_tpu_torch.pipeline import calling as _calling
        from bsseqconsensusreads_tpu_torch.utils.testing import stream_duplex_families

        codes = np.random.default_rng(0).integers(0, 4, size=400).astype(np.uint8)
        records = stream_duplex_families(codes, 2, read_len=30, templates_for=lambda fam: 2)
        stats = _calling.StageStats(stage="warmup")
        for _ in _calling.call_molecular_batches(
            records,
            params=self.scheduler.params,
            mode="unaligned",
            batch_families=4,
            max_window=self.scheduler.max_window,
            grouping="gather",
            stats=stats,
            emit="python",
            batching="sequential",
            transport=self.scheduler.transport,
            indel_policy=self.scheduler.indel_policy,
            device=self.scheduler.device,
            mesh=self.scheduler.mesh,
        ):
            pass
        # the warm call booked the kernel loads' cache outcomes in its own
        # stats (calling publishes at stage end): they are the engine's
        for key in ("compile_cache_hit", "compile_cache_miss"):
            n = stats.metrics.counters.get(key)
            if n is not None:
                self.scheduler.stats.metrics.count(key, n)
        observe.emit(
            "serve_warmup",
            {"families": stats.families, "batches": stats.batches},
        )

    def drain(self, timeout: float | None = None) -> bool:
        return self.scheduler.drain(timeout=timeout)

    def stop(self, timeout: float | None = 10.0) -> bool:
        return self.scheduler.stop(timeout=timeout)

    # -- job API ---------------------------------------------------------

    def submit(self, spec) -> _jobs.Job:
        if isinstance(spec, dict):
            spec = _jobs.JobSpec.from_dict(spec)
        job = self.queue.submit(spec)
        self.scheduler._wake.set()
        return job

    def status(self, job_id: str) -> dict | None:
        job = self.queue.get(job_id)
        return None if job is None else job.status()

    def wait(self, job_id: str, timeout: float | None = None) -> dict | None:
        job = self.queue.get(job_id)
        if job is None:
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        while not job.done.is_set():
            job.done.wait(timeout=0.25)
            if deadline is not None and time.monotonic() >= deadline:
                break
        return job.status()

    def stats_dict(self) -> dict:
        jobs = self.queue.jobs()
        return {
            "jobs": [j.status() for j in jobs],
            "pending": self.queue.pending_count(),
            "counters": {**self.scheduler.counters(), **self.queue.counters},
            "engine_alive": self.scheduler.alive,
            "engine_error": self.scheduler.engine_error,
        }

    def metrics_dict(self) -> dict:
        """The live-metrics gauges/counters (protocol op `metrics`) — the
        sensor surface the future autoscaling scheduler polls. Gauges are
        instantaneous (queue depth, running jobs); counters are monotonic
        (the scheduler's Metrics counters, retries/degrades included);
        rates are derived against engine uptime so a poller needs no
        state."""
        jobs = self.queue.jobs()
        states: dict[str, int] = {}
        for j in jobs:
            states[j.state] = states.get(j.state, 0) + 1
        counters = self.scheduler.counters()
        with self.scheduler.stats.metrics._lock:
            secs = dict(self.scheduler.stats.metrics.seconds)
        device_s = sum(
            v for k, v in secs.items() if k in observe.DEVICE_PHASES
        )
        uptime = (
            time.monotonic() - self._started_monotonic
            if self._started_monotonic is not None else 0.0
        )
        return {
            "component": "serve",
            "uptime_s": round(uptime, 3),
            "queue_depth": self.queue.pending_count(),
            "jobs_total": len(jobs),
            "jobs_by_state": states,
            "engine_alive": self.scheduler.alive,
            "chip_busy": round(device_s / uptime, 4) if uptime else 0.0,
            "batches_shared_jobs_rate": (
                round(counters.get("batches_shared_jobs", 0) / uptime, 4)
                if uptime else 0.0
            ),
            "counters": counters,
        }


class ProtocolServer:
    """Accept/frame/refuse machinery for the serve protocol on one or
    more transport addresses. Subclasses supply `_dispatch` (the op
    table) and `_on_drain` (what "stop serving" means for their
    backend) — ServeServer fronts one engine, router.RouterServer
    fronts a replica fleet, same wire behavior. `serve_forever()` owns
    the calling thread until a drain request (socket op or
    request_drain(), e.g. from a SIGTERM handler) completes."""

    def __init__(self, socket_path=None, *, addresses=None,
                 ready_file: str | None = None):
        self.ready_file = ready_file
        addrs: list[str] = []
        if socket_path is not None:
            addrs.append(str(socket_path))
        if addresses:
            addrs.extend(str(a) for a in addresses)
        if not addrs:
            raise ValueError("server needs at least one address")
        self.addresses = addrs
        # back-compat attribute: the first unix path, if any
        self.socket_path = next(
            (
                _transport.parse_address(a)[1]
                for a in addrs
                if _transport.parse_address(a)[0] == "unix"
            ),
            addrs[0],
        )
        #: resolved listen addresses (port-0 binds get the real port)
        self.bound: list[str] = []
        self._drain_requested = threading.Event()
        self._drained = threading.Event()
        #: in-flight connection handlers; _idle is set while zero so
        #: shutdown can wait for the drain op's own response to flush
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        #: duplicate-delivery protection: `_rid` nonce -> the reply the
        #: first delivery earned. A re-delivered frame (netchaos `dup`,
        #: or any at-least-once retry that reuses its rid) answers from
        #: here with NO second dispatch — `frame_dup_ignored` — so
        #: lease/publish/heartbeat never double a state transition.
        self._rid_cache: OrderedDict[str, dict] = OrderedDict()
        self._rid_lock = threading.Lock()

    #: bounded reply cache — old rids age out; a duplicate arriving
    #: later than 1024 requests re-dispatches (the ledger-level
    #: duplicate-commit path still holds for publish)
    RID_CACHE_SIZE = 1024

    def request_drain(self) -> None:
        """Signal-handler safe: ask the accept loops to drain and exit."""
        self._drain_requested.set()

    def serve_forever(self) -> None:
        listeners = []
        try:
            for address in self.addresses:
                sock, kind, resolved = _transport.listen(address)
                listeners.append((sock, kind, resolved))
                self.bound.append(resolved)
                observe.emit("serve_listening", {"socket": resolved})
            if self.ready_file:
                # the fleet supervisor's ready protocol: bound addresses,
                # one per line, atomically visible (port 0 is resolved)
                tmp = self.ready_file + ".tmp"
                with open(tmp, "w") as fh:
                    fh.write("\n".join(self.bound) + "\n")
                os.replace(tmp, self.ready_file)
            threads = [
                # accept pump per listener: it only polls its own socket
                # and hands each conn to a per-connection handler; shared
                # state stays lock-guarded
                threading.Thread(
                    target=self._accept_loop, args=(sock, kind),
                    name=f"serve-accept-{i}", daemon=True,
                )
                for i, (sock, kind, _) in enumerate(listeners)
            ]
            for t in threads:
                t.start()
            while not self._drain_requested.is_set():
                self._drain_requested.wait(timeout=0.25)
        finally:
            self._drain_requested.set()
            for sock, kind, resolved in listeners:
                sock.close()
                if kind == "unix":
                    try:
                        os.unlink(_transport.parse_address(resolved)[1])
                    except OSError:
                        pass
        # graceful drain: every admitted job completes before we return
        self._on_drain()
        self._drained.set()
        # let in-flight handlers (the drain op itself included) write
        # their responses before the process goes away
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if self._idle.wait(timeout=0.1):
                break
        observe.emit("serve_drained", {"socket": self.bound or self.addresses})
        observe.flush_sinks()

    def _accept_loop(self, sock: socket.socket, kind: str) -> None:
        while not self._drain_requested.is_set():
            try:
                conn, addr = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            peer = f"{addr[0]}:{addr[1]}" if isinstance(addr, tuple) else ""
            # one connection = one request; the handler owns conn and
            # only calls the lock-guarded engine API
            threading.Thread(
                target=self._handle, args=(conn, kind, peer),
                name="serve-conn", daemon=True,
            ).start()

    # -- one connection = one request ------------------------------------

    def _handle(self, conn: socket.socket, kind: str, peer: str = "") -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()
        try:
            afault = netchaos.plan("net_accept", peer=peer)
            if afault.partition or afault.drop:
                return  # injected: connection reset at accept
            if afault.delay_s:
                time.sleep(afault.delay_s)
            if afault.half_open:
                # accept, then stall: never read, never answer — the
                # client's own timeout is its only way out
                time.sleep(afault.half_open_s)
                return
            conn.settimeout(10.0)
            try:
                conn = _transport.server_wrap(conn, kind)
            except OSError:
                return  # failed TLS handshake: refused client
            rfault = netchaos.plan("net_recv", peer=peer)
            if rfault.delay_s:
                time.sleep(rfault.delay_s)
            if rfault.drop:
                return  # injected: the request frame never arrives
            try:
                req = _transport.recv_message(conn, kind)
            except _transport.TransportError as exc:
                # hostile/garbage frame: typed refusal, ledgered, answered
                observe.emit(
                    "serve_frame_refused",
                    {"reason": exc.reason, "error": str(exc)},
                )
                self._answer(conn, kind, {
                    "ok": False, "error": f"refused: {exc}",
                    "guard": exc.reason,
                })
                return
            if req is None:
                return
            # trace carriage: the client's causal context (if any) rides
            # the reserved `_trace` key — bind it so every ledger line the
            # dispatch emits lands in the sender's trace tree
            trace_ctx = req.pop("_trace", None)
            rid = req.pop("_rid", None)
            cached = None
            if rid is not None:
                with self._rid_lock:
                    cached = self._rid_cache.get(rid)
            if cached is not None:
                # duplicate delivery: same reply, no second dispatch —
                # the idempotency contract for lease/publish/heartbeat
                with observe.bind_trace(trace_ctx):
                    observe.emit(
                        "frame_dup_ignored",
                        {"rid": rid, "op": str(req.get("op", ""))},
                    )
                resp = cached
            else:
                try:
                    with observe.bind_trace(trace_ctx):
                        resp = self._dispatch(req)
                except _transport.TransportError as exc:
                    # typed dispatch refusal (overload shed, drain
                    # lapse): same answer shape as a refused frame, so
                    # clients branch on `guard`, not on error strings
                    resp = {
                        "ok": False, "error": f"refused: {exc}",
                        "guard": exc.reason,
                    }
                    retry_after = getattr(exc, "retry_after_s", None)
                    if retry_after is not None:
                        resp["retry_after_s"] = retry_after
                    with observe.bind_trace(trace_ctx):
                        observe.emit(
                            "serve_frame_refused",
                            {"reason": exc.reason, "error": str(exc)},
                        )
                except Exception as exc:  # protocol errors answer, not crash
                    resp = {
                        "ok": False,
                        "error": f"{type(exc).__name__}: {exc}",
                    }
                # bulk replies (slice chunks) opt out via the reserved
                # `_nocache` key: re-dispatching a read-only fetch is
                # safe and keeps the cache memory-bounded
                nocache = bool(resp.pop("_nocache", False)) if isinstance(
                    resp, dict
                ) else False
                if rid is not None and not nocache:
                    with self._rid_lock:
                        self._rid_cache[rid] = resp
                        while len(self._rid_cache) > self.RID_CACHE_SIZE:
                            self._rid_cache.popitem(last=False)
            sfault = netchaos.plan("net_send", peer=peer)
            if sfault.delay_s:
                time.sleep(sfault.delay_s)
            if sfault.drop:
                return  # injected: the answer never leaves the host
            conn.settimeout(10.0)
            self._answer(conn, kind, resp, corrupt=sfault.corrupt)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._inflight_lock:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.set()

    @staticmethod
    def _answer(
        conn: socket.socket, kind: str, resp: dict, corrupt: bool = False
    ) -> None:
        try:
            _transport.send_message(conn, kind, resp, _corrupt=corrupt)
        except OSError:
            pass

    # -- subclass surface ------------------------------------------------

    def _drain_op(self, req: dict) -> dict:
        """The shared `drain` protocol op. The wait deadline accounts
        from the instant the client SENT the frame (`sent_s`, same-host
        wall clock) when the request carries it — wire and accept delay
        spend the caller's budget rather than extending it, the same
        send-time discipline the lease-renewal pump applies. A lapse is
        a TYPED `drain_timeout` refusal, never an ambiguous ok."""
        self._drain_requested.set()
        timeout = req.get("timeout")
        budget = None if timeout is None else float(timeout)
        sent_s = req.get("sent_s")
        if budget is not None and sent_s is not None:
            try:
                budget -= max(0.0, time.time() - float(sent_s))
            except (TypeError, ValueError):
                pass  # unparseable stamp: fall back to receipt-time
        deadline = None if budget is None else time.monotonic() + budget
        while not self._drained.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                raise _transport.TransportError(
                    f"drain incomplete after {timeout}s from frame send",
                    reason="drain_timeout",
                )
            self._drained.wait(timeout=0.25)
        return {"ok": True, "drained": True}

    def _dispatch(self, req: dict) -> dict:
        raise NotImplementedError

    def _on_drain(self) -> None:
        raise NotImplementedError


class ServeServer(ProtocolServer):
    """Socket front of one ServeEngine."""

    def __init__(self, engine: ServeEngine, socket_path=None, *,
                 addresses=None, ready_file: str | None = None):
        super().__init__(socket_path, addresses=addresses,
                         ready_file=ready_file)
        self.engine = engine

    def _on_drain(self) -> None:
        self.engine.drain(timeout=None)

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "submit":
            try:
                job = self.engine.submit(req.get("spec") or {})
            except _jobs.OverloadedError as exc:
                err = _transport.TransportError(
                    str(exc), reason="overloaded"
                )
                err.retry_after_s = exc.retry_after_s
                raise err from None
            except (_jobs.AdmissionError, _jobs.QueueClosed) as exc:
                return {"ok": False, "error": str(exc)}
            return {"ok": True, "job": job.status()}
        if op == "status":
            st = self.engine.status(str(req.get("job")))
            if st is None:
                return {"ok": False, "error": f"unknown job {req.get('job')!r}"}
            return {"ok": True, "job": st}
        if op == "wait":
            timeout = req.get("timeout")
            st = self.engine.wait(
                str(req.get("job")),
                timeout=float(timeout) if timeout is not None else None,
            )
            if st is None:
                return {"ok": False, "error": f"unknown job {req.get('job')!r}"}
            return {"ok": st["state"] in (_jobs.DONE, _jobs.FAILED), "job": st}
        if op == "stats":
            return {"ok": True, "stats": self.engine.stats_dict()}
        if op == "metrics":
            return {"ok": True, "metrics": self.engine.metrics_dict()}
        if op == "drain":
            return self._drain_op(req)
        return {"ok": False, "error": f"unknown op {op!r}"}


def request(socket_path: str, payload: dict, timeout: float = 600.0) -> dict:
    """One client request against a running ServeServer (or router).
    `socket_path` is any transport address — a bare unix path,
    ``unix:<path>``, or ``tcp:host:port``."""
    return _transport.request(socket_path, payload, timeout=timeout)
