"""Batch-level retry executor: bounded backoff + graceful degradation.

The port's copy of the JAX package's faults/retry.py. One recovery
policy for the whole hot path (pipeline.calling wraps each
dispatch+fetch unit; pipeline.extsort, pipeline.bucketemit,
pipeline.checkpoint and methyl.tally wrap their durable writes):

* transient failures (`RETRYABLE`: OSError — which covers BGZF/CRC
  integrity errors and transient host I/O — RuntimeError — which covers
  an injected fault — and TimeoutError) are retried with bounded
  exponential backoff;
* a unit that keeps failing degrades to the caller-provided fallback
  instead of killing the run, and every degraded batch is printed on
  stderr. The consensus stages' fallback is the batch's unit once more
  on the stage's own device with the failpoints bypassed: the card's
  kernels on a card run, the plain PyTorch version on a CPU run. Where
  the JAX package runs a CPU twin, the port never votes a card run's
  batch on the CPU; a fallback that fails too propagates;
* the port's other difference from the JAX package: `fatal` errors are
  never retried and never degraded — they propagate and the run fails.
  They are a CUDA error (torch.AcceleratorError, or a RuntimeError
  carrying CUDA's error text: a sticky error poisons the context, so a
  retry fails again), the card running out of memory
  (torch.OutOfMemoryError), a kernel that does not build or launch
  (ops.cuda_vote.KernelError), and a host library that does not build
  or load (io._nativelib.NativeLibraryError, an OSError);
* everything is counted ('batches_retried' / 'batches_recovered' /
  'batches_degraded' / 'retry_attempts' on the stage metrics), so a
  run that limped home says so.

Programming errors (ValueError, TypeError, KeyError, assertion
failures) are deliberately NOT retryable: retrying a deterministic bug
just burns the attempt budget before failing anyway.

Env knobs:
  BSSEQ_TPU_RETRY_MAX        total attempts per unit (default 3)
  BSSEQ_TPU_RETRY_BACKOFF_S  first backoff, doubling per retry
                             (default 0.05, capped at 2s)
  BSSEQ_TPU_STALL_TIMEOUT_S  overlap-pool stall watchdog: main-thread
                             seconds to wait on an in-flight future
                             before cancelling and re-dispatching
                             inline (default 0 = disabled)
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import torch

from bsseqconsensusreads_tpu_torch.utils import observe

#: Exception classes the executor treats as transient (less `fatal`).
RETRYABLE = (OSError, RuntimeError, TimeoutError)

#: CUDA's own error text, as torch raises it from a launch, a sync or
#: the caching allocator
_CUDA_TEXT = ("CUDA error", "CUDA driver error", "cudaError", "CUBLAS_STATUS",
              "CUDNN_STATUS", "device-side assert", "CUDA out of memory")

#: torch's own classes for a CUDA error and an exhausted card (the
#: names differ across torch versions; absent ones are skipped)
_CUDA_TYPES = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                                getattr(torch, "OutOfMemoryError", None),
                                getattr(torch.cuda, "OutOfMemoryError", None))
                    if isinstance(t, type))


def fatal(exc: BaseException) -> bool:
    """True for the errors the port never retries or degrades (see the
    module doc): a CUDA error, the card out of memory, a kernel build or
    launch error, a host library build or load error."""
    from bsseqconsensusreads_tpu_torch.io._nativelib import NativeLibraryError
    from bsseqconsensusreads_tpu_torch.ops.cuda_vote import KernelError

    if isinstance(exc, (NativeLibraryError, KernelError, *_CUDA_TYPES)):
        return True
    return isinstance(exc, RuntimeError) and any(t in str(exc) for t in _CUDA_TEXT)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def policy_from_env() -> RetryPolicy:
    return RetryPolicy(
        max_attempts=max(1, int(_env_float("BSSEQ_TPU_RETRY_MAX", 3))),
        backoff_s=max(0.0, _env_float("BSSEQ_TPU_RETRY_BACKOFF_S", 0.05)),
    )


def stall_timeout() -> float:
    """Watchdog timeout for overlap-pool futures; 0 disables."""
    return max(0.0, _env_float("BSSEQ_TPU_STALL_TIMEOUT_S", 0.0))


def _backoff(policy: RetryPolicy, attempt: int) -> float:
    return min(
        policy.backoff_s * (2 ** (attempt - 1)), policy.backoff_cap_s
    )


def _note_retry(exc, metrics, stage, batch, attempt: int) -> None:
    if metrics is not None:
        if attempt == 1:
            metrics.count("batches_retried")
        metrics.count("retry_attempts")
    observe.emit("batch_retry", {
        "stage": stage,
        "batch": batch,
        "attempt": attempt,
        "error": f"{type(exc).__name__}: {exc}",
    })


def _degrade_or_raise(exc, degrade, metrics, stage, batch, attempts: int):
    if degrade is None:
        raise exc
    if metrics is not None:
        metrics.count("batches_degraded")
    observe.event("batch_degraded", {  # never silent
        "stage": stage,
        "batch": batch,
        "attempts": attempts,
        "error": f"{type(exc).__name__}: {exc}",
    })
    return degrade()


def guarded(
    unit,
    *,
    degrade=None,
    metrics=None,
    stage: str = "",
    batch: int | None = None,
    policy: RetryPolicy | None = None,
    sleep=time.sleep,
    failed: BaseException | None = None,
):
    """Run `unit()` under the bounded retrier.

    RETRYABLE failures re-run the unit after exponential backoff; the
    policy's final failure degrades to `degrade()` (or re-raises when no
    fallback exists). `failed` seeds the loop with a failure that
    already happened elsewhere (the inline dispatch path catches the
    dispatch exception itself, then hands recovery here — that failure
    is attempt 1). `metrics` is an observe.Metrics (locked counters —
    this runs on overlap-pool worker threads). A `fatal` failure, in
    `failed` or raised by the unit, propagates at once.
    """
    pol = policy or policy_from_env()
    attempt = 0  # failed attempts so far
    if failed is not None and fatal(failed):
        raise failed
    if failed is not None:
        attempt = 1
        if attempt >= pol.max_attempts:
            _note_retry(failed, metrics, stage, batch, attempt)
            return _degrade_or_raise(
                failed, degrade, metrics, stage, batch, attempt
            )
        _note_retry(failed, metrics, stage, batch, attempt)
        sleep(_backoff(pol, attempt))
    while True:
        try:
            out = unit()
        except RETRYABLE as exc:
            if fatal(exc):
                raise
            attempt += 1
            if attempt >= pol.max_attempts:
                return _degrade_or_raise(
                    exc, degrade, metrics, stage, batch, attempt
                )
            _note_retry(exc, metrics, stage, batch, attempt)
            sleep(_backoff(pol, attempt))
        else:
            if attempt:
                if metrics is not None:
                    metrics.count("batches_recovered")
                observe.emit("batch_recovered",
                             {"stage": stage, "batch": batch, "attempts": attempt + 1})
            return out
