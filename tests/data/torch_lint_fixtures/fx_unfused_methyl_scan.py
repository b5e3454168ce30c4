"""graftlint fixture: unfused-methyl-scan — one seeded violation.

`hot_` marks the batch-loop root; the function name carries the methyl
scope. The seeded loop re-derives per-site methylation evidence from
the consensus base planes one family at a time — the host-side scan
the fused kernel epilogue replaces. The vectorized twin below reduces
the same planes without a Python loop and must stay clean, as must an
identical loop outside methyl scope and a methyl-named helper off the
hot path.
"""

import numpy as np


def hot_methyl_scan_batch(planes, metas):
    meth = 0
    for i in range(len(metas)):
        row = planes[i]  # seeded: unfused-methyl-scan
        meth += int((row[1] & 0x0F).sum())
    return meth


def hot_methyl_reduce_batch(planes):
    """Clean twin: the same reduction vectorized over the family axis —
    no per-record Python interpretation of device-shaped data."""
    return int((planes[:, 1] & 0x0F).sum())


def hot_depth_histogram(planes, metas):
    """Same loop shape OUTSIDE methyl scope: a generic depth histogram
    over families is other rules' business."""
    depths = []
    for i in range(len(metas)):
        depths.append(int(planes[i, 0].sum()))
    return depths


def methyl_report_lines(planes, names):
    """Methyl-scoped but cold: a report helper off the batch loop may
    walk sites one at a time (the emit surface does)."""
    lines = []
    for i, name in enumerate(names):
        lines.append(f"{name}\t{int(planes[i, 1].sum())}")
    return lines
