"""graftlint fixture: unbounded-retry — one seeded violation.

fx_read_forever spins on OSError with neither an attempt bound nor a
backoff; the bounded and backed-off variants below must stay clean.
"""

import time


def fx_read_forever(path):
    while True:
        try:
            with open(path) as fh:
                return fh.read()
        except OSError as exc:  # seeded: unbounded-retry
            last = exc
            del last


def fx_read_bounded(path):
    attempt = 0
    while True:
        try:
            with open(path) as fh:
                return fh.read()
        except OSError:
            attempt += 1
            if attempt >= 3:
                raise


def fx_read_backoff(path):
    while True:
        try:
            with open(path) as fh:
                return fh.read()
        except OSError:
            time.sleep(0.1)
