"""The fleet's replica tier: spawn/supervise N serve processes.

The port's counterpart of the JAX package's serve/fleet.py. A fleet is N
`python -m bsseqconsensusreads_tpu_torch serve` replicas (never the JAX
CLI), each a full resident engine on its own TCP address (on the card
unless the serve arguments say `--device cpu`), plus the supervision the
router tier leans on:

* **spawn** — same-host replicas get kernel-assigned ports
  (``tcp:host:0`` → resolved at bind; the replica prints nothing, the
  supervisor learns the port from the replica's ready file). Every
  replica shares ``BSSEQ_TPU_COMPILE_CACHE_DIR`` (replica N+1 loads
  replica 1's kernel builds, utils.compilecache) and carries its identity in
  ``BSSEQ_TPU_REPLICA_ID``, which utils.observe stamps onto every
  ledger line the replica writes — one fleet ledger, per-replica
  sub-streams (`observe summarize --replica rN`).
* **attach** — multihost-ready addressing: `attach_addresses` skips
  spawning entirely and treats the given ``tcp:host:port`` list as
  already-running replicas (a fleet spread over a mesh looks identical
  to the router; only this module's spawn half is same-host).
* **restart** — a dead replica can be respawned under the same id
  (the router counts `replica_restarts`). A one-shot per-replica
  failpoint override (`fail_once`) arms BSSEQ_TPU_FAILPOINTS in ONE
  replica's environment for exactly its first life — how a drill kills r0 mid-job without the respawned r0 inheriting the same
  death sentence.

Ready protocol: a spawned replica writes its bound addresses to
``<rundir>/<rid>.addr`` (cli serve `--ready-file`) once listening;
`wait_ready` polls that plus a ping. No replica output is parsed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from bsseqconsensusreads_tpu_torch.serve import transport as _transport
from bsseqconsensusreads_tpu_torch.utils import observe

ENV_REPLICA_ID = "BSSEQ_TPU_REPLICA_ID"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class FleetError(RuntimeError):
    pass


class Replica:
    """One serve replica: identity + address + (when spawned here) the
    child process handle. Attached replicas have proc None and are
    never restarted by this supervisor."""

    def __init__(self, rid: str, address: str = "", proc=None):
        self.rid = rid
        self.address = address
        self.proc = proc
        self.generation = 0

    @property
    def supervised(self) -> bool:
        return self.proc is not None

    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return bool(self.address)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Replica({self.rid}, {self.address}, alive={self.alive()})"


class ReplicaSet:
    """The supervised set. Construct with either `n` (spawn that many
    same-host replicas) or `attach_addresses` (adopt running ones)."""

    def __init__(
        self,
        n: int = 2,
        *,
        host: str = "127.0.0.1",
        rundir: str | None = None,
        serve_args: list[str] | None = None,
        env: dict | None = None,
        attach_addresses: list[str] | None = None,
        compile_cache_dir: str | None = None,
        fail_once: dict | None = None,
    ):
        self.host = host
        self.rundir = rundir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), f"bsseq-fleet-{os.getpid()}"
        )
        self.serve_args = list(serve_args or [])
        self.base_env = dict(env) if env is not None else dict(os.environ)
        self.compile_cache_dir = compile_cache_dir
        if compile_cache_dir:
            self.base_env["BSSEQ_TPU_COMPILE_CACHE_DIR"] = compile_cache_dir
        #: rid -> failpoint schedule armed for that replica's FIRST life
        self._fail_once = dict(fail_once or {})
        #: readiness-poll pacing; an Event so a future supervisor can
        #: interrupt the wait (sanctioned shape vs. a bare sleep)
        self._poll = threading.Event()
        self.replicas: list[Replica] = []
        if attach_addresses:
            for i, addr in enumerate(attach_addresses):
                _transport.parse_address(addr)  # validate early
                self.replicas.append(Replica(f"r{i}", address=addr))
        else:
            self.replicas = [Replica(f"r{i}") for i in range(n)]

    # -- lifecycle -------------------------------------------------------

    def launch(self) -> "ReplicaSet":
        os.makedirs(self.rundir, exist_ok=True)
        for replica in self.replicas:
            if not replica.address and replica.proc is None:
                self._spawn(replica)
        return self

    def _spawn(self, replica: Replica) -> None:
        addr_file = os.path.join(
            self.rundir, f"{replica.rid}.g{replica.generation}.addr"
        )
        try:
            os.unlink(addr_file)
        # graftlint: disable=swallowed-exception -- best-effort unlink of a stale
        # address file; the replica writes a fresh one
        except OSError:
            pass
        env = dict(self.base_env)
        env[ENV_REPLICA_ID] = replica.rid
        # the replica imports this package from wherever it starts
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH", "")) if p)
        schedule = self._fail_once.pop(replica.rid, None)
        if schedule:
            env["BSSEQ_TPU_FAILPOINTS"] = schedule
        cmd = [
            sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "serve",
            "--address", f"tcp:{self.host}:0",
            "--ready-file", addr_file,
            *self.serve_args,
        ]
        replica.proc = subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        replica.address = ""
        replica._addr_file = addr_file
        replica._spawned_at = time.time()
        observe.emit(
            "fleet_replica_spawn",
            {"replica_id": replica.rid, "generation": replica.generation,
             "pid": replica.proc.pid},
        )

    def wait_ready(self, timeout: float = 120.0) -> None:
        """Block until every replica is listening and answers a ping."""
        deadline = time.monotonic() + timeout
        for replica in self.replicas:
            self._wait_one(replica, deadline)

    def _wait_one(self, replica: Replica, deadline: float) -> None:
        while time.monotonic() < deadline:
            if replica.proc is not None and replica.proc.poll() is not None:
                raise FleetError(
                    f"replica {replica.rid} exited rc="
                    f"{replica.proc.returncode} before becoming ready"
                )
            addr = replica.address or self._read_addr(replica)
            if addr:
                try:
                    resp = _transport.request(
                        addr, {"op": "ping"}, timeout=5.0
                    )
                    if resp.get("ok", False):
                        replica.address = addr
                        spawned = getattr(replica, "_spawned_at", None)
                        if spawned is not None and (
                            observe.stats_sink() is not None
                        ):
                            # the worker_spawn overhead bucket: spawn →
                            # first answered ping, booked on the proc
                            # trace (a per-process cost, not one job's)
                            observe.emit_span(
                                "worker_spawn", spawned, time.time(),
                                ctx=observe.proc_trace(),
                                replica_id=replica.rid,
                                generation=replica.generation,
                            )
                        return
                # graftlint: disable=swallowed-exception -- the replica is still
                # booting; the deadline bounds the poll
                except (OSError, ConnectionError):
                    pass  # still booting; the deadline bounds the poll
            self._poll.wait(0.05)
        raise FleetError(f"replica {replica.rid} not ready in time")

    def _read_addr(self, replica: Replica) -> str:
        addr_file = getattr(replica, "_addr_file", None)
        if not addr_file or not os.path.exists(addr_file):
            return ""
        try:
            text = open(addr_file).read().strip()
        except OSError:
            return ""
        for line in text.splitlines():
            if line.startswith("tcp:"):
                return line.strip()
        return ""

    # -- supervision -----------------------------------------------------

    def restart(self, replica: Replica, timeout: float = 120.0) -> None:
        """Respawn a dead supervised replica under the same id (shared
        compile cache makes the new process a warm start)."""
        if not replica.supervised:
            raise FleetError(
                f"replica {replica.rid} is attached, not supervised — "
                "cannot restart it from here"
            )
        replica.generation += 1
        self._spawn(replica)
        self._wait_one(replica, time.monotonic() + timeout)

    def alive(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive()]

    def lookup(self, rid: str) -> Replica | None:
        for r in self.replicas:
            if r.rid == rid:
                return r
        return None

    # -- teardown --------------------------------------------------------

    def stop(self, drain_timeout: float = 60.0) -> None:
        """Drain every live replica, then reap the processes."""
        for replica in self.replicas:
            if not replica.alive() or not replica.address:
                continue
            try:
                _transport.request(
                    replica.address,
                    # sent_s: the replica accounts its drain deadline
                    # from frame-send time, not receipt — a slow accept
                    # queue must not extend the budget
                    {"op": "drain", "timeout": drain_timeout,
                     "sent_s": time.time()},
                    timeout=drain_timeout + 10.0,
                )
            # graftlint: disable=swallowed-exception -- a replica that cannot take the
            # drain is down already; the wait below reaps it
            except (OSError, ConnectionError):
                pass
        for replica in self.replicas:
            if replica.proc is None:
                continue
            try:
                replica.proc.wait(timeout=drain_timeout)
            except subprocess.TimeoutExpired:
                replica.proc.kill()
                replica.proc.wait(timeout=10.0)
