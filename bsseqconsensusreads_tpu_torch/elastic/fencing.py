"""Epoch fencing: the zombie-writer gate for elastic runs.

Lease expiry alone leaves a window open: a worker partitioned away
from the coordinator keeps computing a slice it no longer holds, and
when the partition heals it publishes — after the requeued twin already
committed. Two writers, one slice. Fencing closes the window with a
monotonically increasing **fence epoch**:

* the coordinator mints one epoch per lease grant (`EpochBook`),
  persisted in the rundir BEFORE the grant leaves — a restarted
  coordinator resumes strictly above every epoch it ever granted
  (epoch continuity across the coordinator-restart drill);
* every grant carries its `fence_epoch`; publish echoes it back, and a
  publish whose epoch is below the slice's current grant is refused
  with the typed reason ``fenced`` and a ``publish_fenced`` ledger
  event — even when its bytes happen to match (a zombie is a zombie);
* the worker **adopts** the fence while it holds the lease. When the
  renewal pump learns the lease is gone — a ``lease_expired`` renewal
  reply, or its own local deadline passing unrenewed behind a
  partition — it **revokes** the fence, and the next durable write
  (checkpoint shard / manifest rename / stage finalize, via the write
  gate installed into pipeline.checkpoint) raises `FencedError`
  instead of touching disk. The worker aborts the slice locally and
  leases fresh work; the requeued twin's files are never raced.

The write gate costs one ``is None`` branch per durable write outside
elastic workers; nothing here imports torch or the pipeline eagerly.
"""

from __future__ import annotations

import json
import os
import threading

from bsseqconsensusreads_tpu_torch.utils import observe

FENCE_DOC = "fence.json"


class FencedError(RuntimeError):
    """A durable write or publish attempted under a stale (revoked or
    superseded) fence epoch. Typed so holders abort locally instead of
    retrying their way into a second writer."""

    def __init__(self, message: str, epoch: int | None = None):
        super().__init__(message)
        self.epoch = epoch


# --------------------------------------------------------------- coordinator


class EpochBook:
    """Coordinator-side epoch mint. The counter is persisted (atomic
    tmp+rename+fsync) BEFORE a minted epoch is returned, so no grant
    can ever carry an epoch a restarted coordinator would re-mint."""

    def __init__(self, rundir: str):
        self.path = os.path.join(rundir, FENCE_DOC)
        self._lock = threading.Lock()
        self.current = 0
        try:
            with open(self.path) as fh:
                self.current = int(json.load(fh).get("epoch", 0))
        except (OSError, ValueError):
            pass

    def mint(self) -> int:
        with self._lock:
            self.current += 1
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"epoch": self.current}, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            return self.current


# -------------------------------------------------------------------- worker

#: The one adopted fence of this worker process (a worker holds at most
#: one lease at a time; hostpool threads inherit the same fence, which
#: is why this is module state, not thread-local).
_LOCK = threading.Lock()
_EPOCH: int | None = None
_LEASE_ID: str = ""
_REVOKED: bool = False
_REVOKE_REASON: str = ""


def adopt(epoch: int | None, lease_id: str = "") -> None:
    """Adopt the fence a lease grant carried. Installs the durable-write
    gate into pipeline.checkpoint on first use (lazy: non-elastic runs
    never import this module, let alone pay more than the gate's None
    branch)."""
    global _EPOCH, _LEASE_ID, _REVOKED, _REVOKE_REASON
    with _LOCK:
        _EPOCH = int(epoch) if epoch is not None else None
        _LEASE_ID = lease_id
        _REVOKED = False
        _REVOKE_REASON = ""
    from bsseqconsensusreads_tpu_torch.pipeline import checkpoint as _ckpt

    _ckpt.install_write_gate(check)


def release() -> None:
    """Drop the adopted fence (slice published or abandoned)."""
    global _EPOCH, _LEASE_ID, _REVOKED, _REVOKE_REASON
    with _LOCK:
        _EPOCH = None
        _LEASE_ID = ""
        _REVOKED = False
        _REVOKE_REASON = ""


def revoke(reason: str = "lease lost", lease_id: str | None = None) -> None:
    """Mark the adopted fence stale: every later durable write refuses
    with FencedError. Called by the renewal pump on a ``lease_expired``
    reply or when its local deadline lapses unrenewed. When `lease_id`
    is given, only the fence adopted FOR that lease is revoked — a
    renewal pump that outlived its slice (stuck in a timed-out request
    past the joiner's patience) must not fence the worker's next lease."""
    global _REVOKED, _REVOKE_REASON
    with _LOCK:
        if _EPOCH is None:
            return
        if lease_id is not None and lease_id != _LEASE_ID:
            return
        _REVOKED = True
        _REVOKE_REASON = reason


def current() -> int | None:
    with _LOCK:
        return _EPOCH


def is_revoked() -> bool:
    with _LOCK:
        return _REVOKED


def check(what: str = "durable write") -> None:
    """The durable-write gate: no-op under a live (or absent) fence,
    FencedError under a revoked one. pipeline.checkpoint calls this at
    its three durable seams via the installed gate."""
    with _LOCK:
        if not _REVOKED:
            return
        epoch, lease_id, reason = _EPOCH, _LEASE_ID, _REVOKE_REASON
    raise FencedError(
        f"{what} refused: fence epoch {epoch} (lease {lease_id!r}) "
        f"revoked — {reason}",
        epoch=epoch,
    )


def emit_publish_fenced(
    slice_: str, worker: str, epoch, current_epoch, trace=None
) -> None:
    """The coordinator-side refusal event — one helper so the field
    tuple has exactly one writer."""
    with observe.bind_trace(trace):
        observe.emit(
            "publish_fenced",
            {"slice": slice_, "worker": worker,
             "epoch": epoch, "current": current_epoch},
        )
