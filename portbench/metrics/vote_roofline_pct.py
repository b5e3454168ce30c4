"""vote_roofline_pct: the vote kernels' share of the device's memory
roofline.

Work: the bytes the device-voted observations need, counted from real
cells whatever layout, padding, route or kernel carries them: each
observation cell the program issued to the device (its StageStats
'used_cells', both stages) reads one base and one quality byte once.
The consensus columns' outputs are left out: the program counts no
voted columns, so the count is a floor on the bytes moved. Time: the
profiler's device time of the kernels whose names carry 'seg_vote' or
'vote_finalize'. Bound: 3.35 TB/s, the H100 SXM's HBM rate (the card's
power limit is printed beside the run)."""

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("seg_vote", "vote_finalize")


def read(w):
    if w.device is None:
        return None
    t = sum(s for name, s in w.device["kernel_s"].items() if any(k in name for k in KERNELS))
    if t <= 0 or w.used_cells <= 0:
        return None
    return 100.0 * 2 * w.used_cells / HBM_BYTES_PER_S / t
