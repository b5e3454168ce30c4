"""rss_unattributed_pct: the share of the stage's peak resident set that
neither the program nor the allocator owns — 100 x (rss - live -
retained - rss_file) / rss, where live is host_live_gib's parts,
retained malloc_retained_gib's and rss_file the file-backed pages (the
program's 'mem.<stage>.peak.<part>_bytes' counters, summed over the
window's passes): the CUDA driver's anonymous maps, library data, Python
objects, heap in use outside the account. The stage read is the one
whose mean per-pass peak rss is higher. None where a part is absent."""

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
    if pre is None:
        return None
    c = w.counters
    rss, free, file_ = (c.get(f"{pre}{p}_bytes") for p in ("rss", "malloc_free", "rss_file"))
    if not rss or free is None or file_ is None:
        return None
    live = sum(c.get(f"{pre}{p}_bytes", 0) for p in LIVE)
    return 100.0 * (rss - live - free - file_) / rss
