"""host_live_gib: the program's own live host bytes at its stage's peak
resident set — the memory account's ingest written bytes, batches in
flight, pinned host memory, sort buffer and genome (the program's
'mem.<stage>.peak.<part>_bytes' counters) — as a mean over the window's
passes, in GiB. The stage read is the one whose mean per-pass peak rss
is higher. None where the program keeps no memory account."""

GIB = 2**30
LIVE = ("ingest_written", "inflight", "pinned", "sort_buffer", "genome")


def peak_stage(counters: dict):
    """'mem.<stage>.peak.' of the stage with the highest summed peak rss."""
    best = None
    for k, v in counters.items():
        if k.startswith("mem.") and k.endswith(".peak.rss_bytes"):
            if best is None or v > best[1]:
                best = (k[:-len("rss_bytes")], v)
    return None if best is None else best[0]


def read(w):
    pre = peak_stage(w.counters)
    if pre is None or not w.passes:
        return None
    return sum(w.counters.get(f"{pre}{p}_bytes", 0) for p in LIVE) / w.passes / GIB
