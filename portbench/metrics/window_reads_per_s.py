"""window_reads_per_s: input records of the grouped BAM carried through
both stages and written, over the window (whole passes, from the
window's start to the last pass's end): the chain's throughput, read
here per layer because the host's clock spreads it too widely between
runs to hold it to an end-to-end bound (PERF.md)."""


def read(w):
    return w.reads / w.seconds if w.reads > 0 and w.seconds > 0 else None
