"""emit_sort_us_per_read: the program's 'emit' and 'sort_write' spans
(the batch record emit, the external coordinate sort and the BAM write;
worker-busy seconds, both stages) per input read of the window, in
microseconds."""


def read(w):
    s = w.phase_s.get("emit", 0.0) + w.phase_s.get("sort_write", 0.0)
    return 1e6 * s / w.reads if s > 0 else None
