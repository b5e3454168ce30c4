"""Failpoint registry: named, scheduled fault-injection sites.

The port's copy of the JAX package's faults/failpoints.py: the same
grammar, the same SITES, the same seeded per-failpoint RNG, so one
schedule string fires at the same hits in both packages. A failpoint is
a named site on the hot path (`SITES`) where a scheduled fault can be
provoked on demand — the mechanism every recovery claim is proven
against. Sites are armed with a schedule string, from
`BSSEQ_TPU_FAILPOINTS` or `--failpoints`:

    site=action[:arg][:k=v...][@pred=value...][;site=action...]

Actions
    raise[:ExcName]     raise the named exception (default RuntimeError)
    io_error            raise OSError("injected I/O error")
    stall[:<dur>s]      time.sleep(dur) (default 30s) — a wedged call
    exit[:code]         os._exit(code) (default 9) — a hard crash, no
                        cleanup, for kill-at-batch-N drills

Network actions (net_send / net_recv / net_accept sites ONLY — they do
not raise; the transport shim in faults/netchaos.py interprets them
via `evaluate()`, and serve/transport.py and serve/server.py enact them):
    delay[:<dur>s]      sleep before the wire op (default 0.2s)
    drop                close the connection without sending the frame
    dup                 deliver the same frame twice (a second identical
                        request on a fresh connection)
    corrupt             flip payload bytes after the length header — the
                        peer's framing must refuse, never parse, it
    half_open           accept, then stall and close without answering
    partition           refuse the connection outright (pairs with
                        @peer= for one-sided partitions)

Arguments (colon-separated `k=v` after the action)
    p=<float>           fire probability per eligible hit (default 1.0)
    seed=<int>          seed of the failpoint's own RNG — a p< 1
                        schedule is DETERMINISTIC given the seed and the
                        hit sequence
    times=<int>         stop firing after this many fires (default
                        unlimited)

Predicates (each `@k=v` must match the fire() call's context)
    @batch=<int>        only when the site reports that batch index
    @stage=<name>       only when the site reports that stage
    @job=<id>           only when the site reports that serve job id
                        (the serve_* sites — targets ONE tenant)
    @hit=<int>          only on the Nth predicate-matching hit
    @peer=<substr>      only when the site's peer address CONTAINS the
                        value (ports are dynamic, so exact match is
                        useless — `@peer=127.0.0.1` or a socket path
                        fragment)

Examples:
    wire_transfer-style transient:  dispatch_kernel=raise:RuntimeError@batch=7
    probabilistic spill errors:     extsort_spill=io_error:p=0.01:seed=42
    a wedged fetch:                 fetch_out=stall:30s@batch=3

Zero-cost when unarmed: `fire()` returns immediately on a module-level
flag, and per-block hot paths (io.bgzf) additionally guard on `ARMED`
before building the call. Every fired failpoint is counted
(`fired_counts`) and ledgered ('failpoint_fired', utils.observe).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from random import Random

from bsseqconsensusreads_tpu_torch.utils import observe


ENV_FLAG = "BSSEQ_TPU_FAILPOINTS"

#: Every registered injection site. arm() rejects unknown names so a
#: typo'd schedule fails loudly instead of silently injecting nothing.
SITES = frozenset(
    {
        # pipeline.calling — the batch loop
        "dispatch_kernel",
        "fetch_out",
        "retire_future",
        # parallel.hostpool — host-parallel encode/rawize/emit tasks
        "hostpool_task",
        # pipeline.extsort — spill runs + merge passes
        "extsort_spill",
        "extsort_merge",
        # pipeline.bucketemit — bucket run spills + per-bucket finalize
        # writes (the two durable windows of sort_engine=bucket)
        "bucket_spill",
        "bucket_finalize",
        # pipeline.checkpoint — durable state
        "ckpt_shard_write",
        "ckpt_manifest_rename",
        "ckpt_finalize",
        # io — codec + native loader
        "bgzf_inflate",
        "bgzf_write",
        "native_load",
        # parallel.multihost — liveness + collectives
        "multihost_heartbeat",
        "multihost_collective",
        # serve — resident engine: job admission, per-job ingest pump,
        # shared-batch retire/demux (predicate @job=<id> targets one
        # tenant, proving cross-tenant isolation in the chaos drill)
        "serve_submit",
        "serve_ingest",
        "serve_retire",
        # serve.router / fleet — the routed-submit forward path (armed
        # in the router process) and the replica retire loop (armed in
        # ONE replica's env via `cli route --replica-failpoints`, so a
        # chaos drill can kill a replica mid-job: exit:9@batch=N)
        "fleet_route",
        "fleet_replica_exit",
        # elastic — coordinator/worker sharded runs: the start of slice
        # processing in a worker (exit:9@hit=N kills a worker mid-run,
        # the slice_requeued drill), the publish edge (work durable but
        # unpublished), the coordinator's manifest commit (crash after
        # output verified but before durable commit — the
        # coordinator-restart drill window), and the final merge.
        "elastic_slice",
        "elastic_publish",
        "elastic_manifest_commit",
        "elastic_merge",
        # serve.transport / faults.netchaos — the wire itself: the send
        # edge (client or server answering), the recv edge, and the
        # server accept loop. These sites take the network actions
        # (delay/drop/dup/corrupt/half_open/partition) and are
        # interpreted by the transport shim via evaluate(), not fire().
        "net_send",
        "net_recv",
        "net_accept",
    }
)

#: Sites whose faults live on the wire — the only sites that accept the
#: network actions below.
NET_SITES = frozenset({"net_send", "net_recv", "net_accept"})

_ACTIONS = frozenset({"raise", "io_error", "stall", "exit"})

#: Actions interpreted by the transport shim (faults/netchaos.py)
#: rather than raised by _act(); valid only at NET_SITES.
NET_ACTIONS = frozenset(
    {"delay", "drop", "dup", "corrupt", "half_open", "partition"}
)

#: Exceptions an injected `raise` may name — a restricted table, not a
#: builtins lookup, so a schedule cannot conjure arbitrary types.
_EXCEPTIONS = {
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "ValueError": ValueError,
}


class FailpointError(ValueError):
    """Bad schedule grammar or an unknown site/action/exception name."""


@dataclass
class FailPoint:
    """One armed schedule term. Mutable hit/fire counters are guarded by
    the module lock — fire() is called from overlap-pool worker
    threads concurrently with the main thread."""

    site: str
    action: str
    exc_name: str = "RuntimeError"
    prob: float = 1.0
    seed: int = 0
    duration_s: float = 30.0
    exit_code: int = 9
    times: int | None = None
    batch: int | None = None
    stage: str | None = None
    job: str | None = None
    hit: int | None = None
    peer: str | None = None
    spec: str = ""
    _hits: int = 0
    _fires: int = 0
    _rng: Random = field(default_factory=lambda: Random(0))

    def __post_init__(self) -> None:
        self._rng = Random(self.seed)

    def matches(self, ctx: dict) -> bool:
        if self.batch is not None and ctx.get("batch") != self.batch:
            return False
        if self.stage is not None and ctx.get("stage") != self.stage:
            return False
        if self.job is not None and ctx.get("job") != self.job:
            return False
        if self.peer is not None and self.peer not in str(ctx.get("peer", "")):
            return False
        return True

    def should_fire(self, ctx: dict) -> bool:
        """Called under the module lock: advances the hit counter and
        the RNG deterministically, returns whether to fire."""
        if not self.matches(ctx):
            return False
        if self.times is not None and self._fires >= self.times:
            return False
        # graftlint: disable=thread-unsafe-mutation -- should_fire is only called under
        # fire()'s _LOCK
        self._hits += 1
        if self.hit is not None and self._hits != self.hit:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        # graftlint: disable=thread-unsafe-mutation -- under fire()'s _LOCK, as above
        self._fires += 1
        return True


#: Module-level armed flag — the one branch an unarmed hot path pays.
ARMED: bool = False
_SCHEDULE: list[FailPoint] = []
_FIRED: dict[str, int] = {}
_LOCK = threading.Lock()


def _parse_float(name: str, value: str, spec: str) -> float:
    try:
        return float(value)
    except ValueError:
        raise FailpointError(f"bad {name}={value!r} in {spec!r}") from None


def _parse_int(name: str, value: str, spec: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise FailpointError(f"bad {name}={value!r} in {spec!r}") from None


def _parse_duration(value: str, spec: str) -> float:
    return _parse_float("stall duration", value.rstrip("s"), spec)


def parse_schedule(spec: str) -> list[FailPoint]:
    """Parse a schedule string into FailPoints; raises FailpointError on
    any grammar problem (unknown site, action, exception, predicate)."""
    points: list[FailPoint] = []
    for raw in spec.replace(";", ",").split(","):
        term = raw.strip()
        if not term:
            continue
        chunks = term.split("@")
        head, preds = chunks[0], chunks[1:]
        site, sep, action_part = head.partition("=")
        site = site.strip()
        if not sep or not action_part:
            raise FailpointError(
                f"bad failpoint term {term!r} (want site=action[...])"
            )
        if site not in SITES:
            raise FailpointError(
                f"unknown failpoint site {site!r} (known: "
                f"{', '.join(sorted(SITES))})"
            )
        parts = action_part.split(":")
        action = parts[0].strip()
        if action not in _ACTIONS and action not in NET_ACTIONS:
            raise FailpointError(
                f"unknown failpoint action {action!r} in {term!r} "
                f"(want {'|'.join(sorted(_ACTIONS | NET_ACTIONS))})"
            )
        if action in NET_ACTIONS and site not in NET_SITES:
            raise FailpointError(
                f"network action {action!r} is only valid at net_* sites "
                f"({term!r})"
            )
        fp = FailPoint(site=site, action=action, spec=term)
        if action == "delay":
            fp.duration_s = 0.2
        for arg in parts[1:]:
            arg = arg.strip()
            if not arg:
                continue
            k, eq, v = arg.partition("=")
            if eq:
                if k == "p":
                    fp.prob = _parse_float("p", v, term)
                elif k == "seed":
                    fp.seed = _parse_int("seed", v, term)
                elif k == "times":
                    fp.times = _parse_int("times", v, term)
                else:
                    raise FailpointError(
                        f"unknown failpoint argument {k!r} in {term!r}"
                    )
                continue
            # positional argument: meaning depends on the action
            if action == "raise":
                if arg not in _EXCEPTIONS:
                    raise FailpointError(
                        f"unknown exception {arg!r} in {term!r} (known: "
                        f"{', '.join(sorted(_EXCEPTIONS))})"
                    )
                fp.exc_name = arg
            elif action in ("stall", "delay", "half_open"):
                fp.duration_s = _parse_duration(arg, term)
            elif action == "exit":
                fp.exit_code = _parse_int("exit code", arg, term)
            else:
                raise FailpointError(
                    f"action {action!r} takes no positional argument "
                    f"({arg!r} in {term!r})"
                )
        for pred in preds:
            k, eq, v = pred.partition("=")
            if not eq:
                raise FailpointError(f"bad predicate {pred!r} in {term!r}")
            if k == "batch":
                fp.batch = _parse_int("batch", v, term)
            elif k == "stage":
                fp.stage = v
            elif k == "job":
                fp.job = v
            elif k == "hit":
                fp.hit = _parse_int("hit", v, term)
            elif k == "peer":
                fp.peer = v
            else:
                raise FailpointError(
                    f"unknown predicate {k!r} in {term!r} "
                    "(want batch|stage|job|hit|peer)"
                )
        fp.__post_init__()  # re-seed after arg parse set .seed
        points.append(fp)
    return points


def arm(spec: str) -> None:
    """Arm the schedule (replacing any previous one). An empty spec
    disarms."""
    global ARMED, _SCHEDULE
    points = parse_schedule(spec or "")
    with _LOCK:
        _SCHEDULE = points
        _FIRED.clear()
        ARMED = bool(points)


def disarm() -> None:
    arm("")


def arm_from_env() -> None:
    """Arm from BSSEQ_TPU_FAILPOINTS (done once at import, so schedules
    set in the environment cover library use, the CLI, and every
    subprocess a drill spawns)."""
    spec = os.environ.get(ENV_FLAG, "")
    if spec:
        arm(spec)


def fired_counts() -> dict[str, int]:
    """{site: fires} so far (across the whole schedule)."""
    with _LOCK:
        return dict(_FIRED)


def fired_total() -> int:
    with _LOCK:
        return sum(_FIRED.values())


def evaluate(site: str, **ctx) -> list[FailPoint]:
    """Evaluate the armed schedule at one site WITHOUT acting: every
    matching failpoint is counted and ledgered ('failpoint_fired', with
    trace context via the ambient ledger binding), then returned for
    the caller to interpret. This is the shim API for the network
    actions, whose behaviours (drop/dup/corrupt/...) only the transport
    layer can enact. Returns [] when unarmed."""
    if not ARMED:
        return []
    to_run: list[FailPoint] = []
    with _LOCK:
        for fp in _SCHEDULE:
            if fp.site == site and fp.should_fire(ctx):
                _FIRED[site] = _FIRED.get(site, 0) + 1
                to_run.append(fp)
    for fp in to_run:
        observe.emit("failpoint_fired", {
            "site": site, "action": fp.action, "spec": fp.spec,
            **{k: v for k, v in ctx.items() if k in ("batch", "stage", "job", "peer")},
        })
    return to_run


def fire(site: str, **ctx) -> None:
    """Evaluate the armed schedule at one site. No-op (one branch) when
    unarmed. A firing failpoint is ledgered and counted BEFORE its
    action runs, so even an `exit` crash leaves evidence."""
    if not ARMED:
        return
    for fp in evaluate(site, **ctx):
        _act(fp, site)


def _act(fp: FailPoint, site: str) -> None:
    if fp.action == "raise":
        raise _EXCEPTIONS[fp.exc_name](
            f"failpoint {site!r} injected {fp.exc_name} ({fp.spec})"
        )
    if fp.action == "io_error":
        raise OSError(f"failpoint {site!r} injected I/O error ({fp.spec})")
    if fp.action == "stall":
        time.sleep(fp.duration_s)
        return
    if fp.action == "exit":
        # a hard crash: no cleanup, but the flight ring is dumped and
        # what was printed or ledgered stays
        observe.flight_dump(f"failpoint:{site}")
        sys.stdout.flush()
        # graftlint: disable=stderr-print -- a flush before os._exit writes nothing new;
        # it keeps what was already printed
        sys.stderr.flush()
        os._exit(fp.exit_code)


arm_from_env()
