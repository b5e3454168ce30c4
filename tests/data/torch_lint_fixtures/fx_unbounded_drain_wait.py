"""graftlint fixture: unbounded-drain-wait — one seeded violation.

fx_drain_workers parks on a `.join()` with no timeout inside a drain
path: SIGKILL is the only way out if a worker wedges, which loses the
checkpoint flush the drain existed to protect. The bounded variant and
the identically-shaped wait OUTSIDE a drain-named function must stay
clean.
"""


def fx_drain_workers(threads):
    for t in threads:
        t.join()  # seeded: unbounded-drain-wait


def fx_drain_workers_bounded(threads, deadline):
    for t in threads:
        t.join(timeout=deadline)


def fx_feed_loop(queue):
    # an unbounded get on a worker feed path is NOT this rule's
    # business — blocking forever on new work is the design
    while True:
        item = queue.get()
        if item is None:
            return
