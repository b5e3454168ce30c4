"""malloc_retained_gib: glibc's free heap bytes (mallinfo2 fordblks, the
program's 'mem.<stage>.peak.malloc_free_bytes') at the stage's peak
resident set — memory the program freed that the allocator kept from
the OS — as a mean over the window's passes, in GiB. The stage read is
the one whose mean per-pass peak rss is higher. None where the program
keeps no memory account or the host's C library has no mallinfo2."""

GIB = 2**30


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
    free = None if pre is None else w.counters.get(f"{pre}malloc_free_bytes")
    if free is None or not w.passes:
        return None
    return free / w.passes / GIB
