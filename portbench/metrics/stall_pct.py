"""stall_pct: the batch engine's dispatch-thread seconds blocked on a
pool task or a prefetched encode (the program's 'stall' span, both
stages), as a share of the window."""


def read(w):
    if "stall" not in w.phase_s:
        return None
    return 100.0 * w.phase_s["stall"] / w.seconds
