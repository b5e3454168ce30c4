"""batch_gap_ms_p95: the 95th percentile of the time from one batch a
stage yields to the next (both stages, every pass of the window), timed
by the harness around its own loop."""

import statistics


def read(w):
    if len(w.gaps_s) < 20:
        return None
    return 1e3 * statistics.quantiles(w.gaps_s, n=20)[18]
