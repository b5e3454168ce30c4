"""graftlint fixture: swallowed-exception — one seeded violation.

fx_worker_quiet runs as a Thread target; the except-pass means a failing
job dies with no trace anywhere.
"""

import threading


def fx_worker_quiet(jobs):
    for j in jobs:
        try:
            j()
        except Exception:  # seeded: swallowed-exception
            pass


def fx_spawn(jobs):
    return threading.Thread(target=fx_worker_quiet, args=(jobs,))
