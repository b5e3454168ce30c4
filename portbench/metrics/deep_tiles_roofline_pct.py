"""deep_tiles_roofline_pct: seg_vote's deep tiles against their bound.

Work, from the program's counters over the window: the bytes the deep
tiles move — 3 B read per observation cell ('vote.deep_cells_in': base
and int16 qual) and 6 B written per output cell ('vote.deep_cells_out':
base, qual, depth, errors) — at 3.35 TB/s, the H100 SXM's HBM rate; and
the chain of in-order adds — each launch's deepest deep segment's rows
('vote.deep_chain_rows', summed over launches) at 4.08 cycles a
dependent float add and 1,980 MHz (the card's clocks.max.sm), as PERF.md's
table of kernels bounds them. The bound is the larger of the two. Time:
the profiler's device time of the kernels whose names carry
'seg_vote_deep'. A floor: bytes the tiles move beyond these cells (the
log-likelihood table, the offsets) are not counted, and each launch's
time holds at least its own chain. None untraced, without the counters
or without a deep kernel in the trace."""

HBM_BYTES_PER_S = 3.35e12
ADD_CYCLES = 4.08
SM_HZ = 1.98e9
KERNEL = "seg_vote_deep"


def bytes_bound_s(cells_in: int, cells_out: int) -> float:
    return (3 * cells_in + 6 * cells_out) / HBM_BYTES_PER_S


def chain_bound_s(chain_rows: int) -> float:
    return chain_rows * ADD_CYCLES / SM_HZ


def read(w):
    if w.device is None:
        return None
    c = w.counters
    keys = ("vote.deep_cells_in", "vote.deep_cells_out", "vote.deep_chain_rows")
    if any(k not in c for k in keys):
        return None
    t = sum(s for name, s in w.device["kernel_s"].items() if KERNEL in name)
    if t <= 0:
        return None
    bound = max(bytes_bound_s(c["vote.deep_cells_in"], c["vote.deep_cells_out"]),
                chain_bound_s(c["vote.deep_chain_rows"]))
    return 100.0 * bound / t
