"""graftpreempt — first-class voluntary preemption for elastic workers.

Spot-style eviction is a *protocol event*, not a crash. Until this
module, the only way a worker gave up a slice was by dying: the
coordinator waited out ``lease_s`` expiry and the successor restarted
from whatever checkpoint prefix had survived. graftpreempt makes the
cheap path explicit:

* **latch** — SIGTERM (or a test's explicit :meth:`PreemptFlag.request`)
  sets a process-wide latch. Nothing is interrupted; the in-flight
  batch keeps running.
* **batch gate** — `pipeline.checkpoint.write_batches` consults an
  installed gate after every consumed batch. Once the latch is set the
  gate raises :class:`PreemptedError`; ``write_batches`` flushes the
  pending buffer *first*, so the interrupting batch is durable (shard +
  manifest + methyl watermark aligned) before control unwinds. Handoff
  latency is therefore bounded by ONE batch, not one lease.
* **handoff** — the worker writes a ``handoff.json`` manifest next to
  the slice checkpoints (durable prefix, ``batches_kept``, methyl
  watermark), sends a ``preempt`` op releasing its lease voluntarily,
  and exits 0. The coordinator requeues the slice immediately — no
  ``lease_s`` wait — and the next grant's fence epoch revokes the
  departed holder exactly like a crash would (fence precedence: a
  straggling publish under the old epoch is refused ``fenced`` before
  any lease bookkeeping runs).

The grace budget ``BSSEQ_TPU_PREEMPT_GRACE_S`` bounds how long the
handoff may take end-to-end; a worker that cannot finish its in-flight
batch inside the budget abandons the handoff op and exits anyway — the
durable prefix is already on disk, and lease expiry remains the
backstop, so grace lapse degrades to exactly the old crash path.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

from bsseqconsensusreads_tpu_torch.utils import observe

ENV_GRACE_S = "BSSEQ_TPU_PREEMPT_GRACE_S"
DEFAULT_GRACE_S = 30.0

HANDOFF_NAME = "handoff.json"


def grace_s() -> float:
    """The end-to-end handoff budget: latch → lease released."""
    try:
        return float(os.environ.get(ENV_GRACE_S, DEFAULT_GRACE_S))
    except ValueError:
        return DEFAULT_GRACE_S


class PreemptedError(RuntimeError):
    """Raised from the batch gate once a preemption is pending: the
    batch that was executing when the latch fired is durable, the
    remainder of the slice is abandoned to the successor."""

    def __init__(self, batches_kept: int = 0):
        super().__init__(
            f"preempted with {batches_kept} durable batch(es)"
        )
        self.batches_kept = batches_kept


class PreemptFlag:
    """Process-wide preemption latch.

    Sticky by design: a second SIGTERM while the handoff is in flight
    must not restart the clock (the grid sends them in salvos). Tests
    construct private flags; production uses the module-level FLAG the
    signal handler targets."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._t_request = 0.0

    def request(self) -> bool:
        """Latch a preemption. Returns True on the first request,
        False when one was already pending (salvo duplicate)."""
        with self._lock:
            if self._event.is_set():
                return False
            self._t_request = time.monotonic()
            self._event.set()
            return True

    def pending(self) -> bool:
        return self._event.is_set()

    def requested_at(self) -> float:
        """Monotonic timestamp of the first request (0.0 if none) —
        the start of the handoff-latency clock."""
        with self._lock:
            return self._t_request

    def deadline(self) -> float:
        """Monotonic deadline the grace budget imposes on the handoff."""
        with self._lock:
            return self._t_request + grace_s()

    def clear(self) -> None:
        """Re-arm (tests and the worker loop between slices)."""
        with self._lock:
            self._event.clear()
            self._t_request = 0.0


#: the process-wide latch the SIGTERM handler sets
FLAG = PreemptFlag()


def install_signal_handler(flag: PreemptFlag | None = None) -> bool:
    """Route SIGTERM to the latch. Returns False (and installs
    nothing) off the main thread — inline elastic runs process slices
    from worker threads where signal.signal raises ValueError; those
    runs preempt via the supervisor path instead."""
    target = FLAG if flag is None else flag

    def _handler(signum, frame):  # pragma: no cover - signal context
        target.request()

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        return False
    return True


def batch_gate(flag: PreemptFlag | None = None):
    """Build the gate `pipeline.checkpoint.install_batch_gate` accepts:
    called with the would-be durable batch count after every consumed
    batch, raises PreemptedError once the latch is set. The checkpoint
    layer flushes the pending buffer before letting the error unwind,
    so ``batches_kept`` on the raised error is a *durable* count."""
    target = FLAG if flag is None else flag

    def _gate(batches_done: int) -> None:
        if target.pending():
            raise PreemptedError(batches_kept=batches_done)

    return _gate


def write_handoff(slice_dir: str, *, slice_name: str, worker: str,
                  batches_kept: int) -> str:
    """Persist the handoff manifest next to the slice checkpoints.

    The successor does not *need* it to resume (the ``*.ckpt.json``
    manifests are the durable truth) — it exists so the requeue is
    attributable: ledger reconciliation can distinguish a voluntary
    handoff from a crash, and the drill asserts the watermark here
    matches what the coordinator granted the successor."""
    manifest = {
        "slice": slice_name,
        "worker": worker,
        "batches_kept": int(batches_kept),
        # methyl tallies flush inside BatchCheckpoint.on_flush BEFORE
        # the manifest advances, so the durable batch count IS the
        # methyl watermark — recorded separately anyway because the
        # alignment is an invariant worth asserting, not assuming
        "methyl_watermark": int(batches_kept),
        "written_at": time.time(),
    }
    os.makedirs(slice_dir, exist_ok=True)
    path = os.path.join(slice_dir, HANDOFF_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def read_handoff(slice_dir: str) -> dict | None:
    path = os.path.join(slice_dir, HANDOFF_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def emit_handoff_published(*, slice_name: str, worker: str,
                           batches_kept: int,
                           handoff_latency_s: float) -> None:
    observe.emit(
        "handoff_published",
        {"slice": slice_name, "worker": worker,
         "batches_kept": int(batches_kept),
         "handoff_latency_s": round(float(handoff_latency_s), 6)},
    )
