"""stall_encode_pct: the dispatch thread's seconds blocked on the
encode-ahead (the program's 'stall.encode', a part of 'stall', both
stages), as a share of the window; what is left of stall_pct is
'stall.batch', the ordered retire's join on a batch task. None where the
program does not split its stall."""


def read(w):
    if "stall.encode" not in w.phase_s:
        return None
    return 100.0 * w.phase_s["stall.encode"] / w.seconds
