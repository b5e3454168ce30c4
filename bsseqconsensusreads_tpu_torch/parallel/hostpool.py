"""Host-parallel batch engine: bounded workers, batch-ordered retirement.

The port's copy of the JAX package's parallel/hostpool.py. The card is
idle most of every stage (PERF.md §5): the wall is the host phases —
encode, the duplex rawize, the record emit — which otherwise run one
after another on the dispatch thread. This module is the executor those
phases run on instead:

* **Bounded workers** — `BSSEQ_TPU_HOST_WORKERS` (default
  `min(4, cores-1)`; 0 disables and restores the fully inline path).
* **Deterministic, batch-ordered retirement** — tasks are submitted in
  batch order and joined in batch order (pipeline.calling's `_pipelined`
  retires strictly in event order), so output bytes are IDENTICAL for
  any worker count. Emit math runs against per-task shadow stats whose
  integer fields merge into the stage stats at the ordered join
  (pipeline.calling._hp_stats_merge) — no counter ever races.
* **Attributed phases** — tasks time their phases on the stage's own
  locked `observe.Metrics`, so rawize / emit / encode seconds survive
  parallelism (as worker-busy seconds).
* **Fault semantics carry over** — every task body runs inside the
  bounded retry executor (`faults.retry.guarded`) with the
  `hostpool_task` failpoint INSIDE the retried unit, so an injected
  fault in host work is retried/recovered exactly like a device fault.

The GIL: the C sweeps (emit, encode, sort — ctypes calls) and zlib
release it; the Python parts of the rawize walk and the duplex meta
build do not, so what the pool buys is measured (chip_smoke.py Phase
7b), not assumed.

pipeline.extsort's double-buffered background spill writer gates on the
same `host_workers()` knob, keeping one story for "may the host use
extra threads".
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import retry as _faultretry
from bsseqconsensusreads_tpu_torch.utils import observe

ENV_WORKERS = "BSSEQ_TPU_HOST_WORKERS"

#: Failpoint site fired inside every host-pool task (registered in
#: faults.failpoints.SITES).
FAILPOINT_SITE = "hostpool_task"


def host_workers() -> int:
    """Worker count for the host-parallel engine.

    `BSSEQ_TPU_HOST_WORKERS` overrides (0 disables); the default is
    `min(4, cores-1)` — one core stays with the dispatch thread, and
    beyond ~4 workers the ordered retire queue (not compute) bounds the
    stage on every host measured so far. On a 1-core host the default
    is 0: threads would only add contention there."""
    env = os.environ.get(ENV_WORKERS)
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    cores = os.cpu_count() or 1
    return min(4, max(0, cores - 1))


class HostPool:
    """Bounded executor for the pure-host phases of the batch hot path.

    The pool itself imposes no ordering — determinism comes from the
    caller submitting in batch order and joining results in the same
    order (`pipeline.calling._pipelined`). `submit` wraps every task in
    the bounded retry executor with the `hostpool_task` failpoint inside
    the retried unit; tasks must therefore be idempotent (the calling
    layer re-derives per-task state — e.g. shadow stats — inside the
    task body)."""

    def __init__(self, workers: int, metrics=None, stage: str = ""):
        if workers < 1:
            raise ValueError(f"HostPool needs >=1 worker, got {workers}")
        self.workers = workers
        self.metrics = metrics
        self.stage = stage
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="bsseq-host"
        )

    def submit(self, fn, *args, batch=None, degrade=None):
        """Schedule fn(*args) under the retry executor; returns a Future.

        A RETRYABLE failure (including an armed `hostpool_task`
        failpoint) re-runs the whole task after backoff; exhaustion
        falls to `degrade()` when given, else the error surfaces at the
        caller's ordered join."""

        def unit():
            _failpoints.fire(FAILPOINT_SITE, stage=self.stage, batch=batch)
            return fn(*args)

        return self._pool.submit(
            _faultretry.guarded,
            unit,
            degrade=degrade,
            metrics=self.metrics,
            stage=self.stage or "hostpool",
            batch=batch,
        )

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


def make_pool(metrics=None, stage: str = "") -> HostPool | None:
    """A HostPool per `host_workers()`, or None when disabled (0
    workers). Either way the stage's `host_pool_workers` counter says
    how many workers its host phases had (0 when inline), and the ledger
    says so ('host_pool_enabled' with the count, or 'host_pool_disabled'
    with the reason)."""
    n = host_workers()
    if metrics is not None:
        metrics.count("host_pool_workers", n)
    if n <= 0:
        reason = (f"{ENV_WORKERS} explicit disable" if os.environ.get(ENV_WORKERS) is not None
                  else "single-core host: no idle core for host workers")
        observe.emit("host_pool_disabled", {"stage": stage, "reason": reason})
        return None
    observe.emit("host_pool_enabled", {"stage": stage, "workers": n})
    return HostPool(n, metrics, stage)
