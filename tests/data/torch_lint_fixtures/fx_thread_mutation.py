"""graftlint fixture: thread-unsafe-mutation — one seeded violation.

fx_worker runs as a Thread target and bumps a shared counter without
taking the lock the class even owns.
"""

import threading


class FxCounter:
    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def fx_worker(self):
        self.n += 1  # seeded: thread-unsafe-mutation


def fx_start(c: "FxCounter"):
    t = threading.Thread(target=c.fx_worker)
    t.start()
    return t
