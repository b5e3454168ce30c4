"""graftlint fixture: blocking-scheduler-loop — one seeded violation.

fx_scheduler_spin parks its polling loop on time.sleep, which drain
and SIGTERM cannot preempt; the event-driven and bounded-queue
variants below must stay clean.
"""

import queue
import threading
import time

_stop = threading.Event()
_wake = threading.Event()


def fx_scheduler_spin(pending):
    while not _stop.is_set():
        if pending:
            pending.pop()
        time.sleep(0.05)  # seeded: blocking-scheduler-loop


def fx_scheduler_event_driven(pending):
    while not _stop.is_set():
        if pending:
            pending.pop()
        _wake.wait(timeout=0.05)
        _wake.clear()


def fx_retire_bounded_queue():
    q = queue.Queue(maxsize=8)
    drained = []
    while not _stop.is_set():
        if q.empty():
            break
        drained.append(q.get(timeout=0.25))
    return drained
