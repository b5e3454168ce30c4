"""Duplex coordinate harmonization ("gap extension") on torch tensors.

The port of the JAX package's ops/extend.py — the equivalent of the
reference's tools/2.extend_gap.py: after B-strand conversion, the converted
reads (flags 163/83) start one base earlier (LA=1) and may end one base
earlier (RD=1) than their unconverted duplex partners (99/147). This op
copies the boundary bases across so both reads of each pair span identical
reference columns. Elementwise on the device.

Reference semantics reproduced (tools/2.extend_gap.py:58-110):
 * pair (99, 163): left read = 163 (the converted one), right = 99;
   pair (83, 147): left read = 83, right = 147 (:61-64);
 * LA(left)==1 -> right read gets left's first base+qual prepended (:70-80);
 * RD(left)==1 -> left read gets right's LAST base+qual appended (:92-101);
 * groups that don't have exactly 4 reads pass through unchanged (:114-115)
   — the `eligible` gate, computed by the encoder.

In window space both rules are one-hot column copies: LA copies column
first(left) from left into right; RD copies column last(right) from right
into left.
"""

from __future__ import annotations

import torch

from bsseqconsensusreads_tpu_torch.ops.convert import span

# Row layout of a duplex family tensor: (99, 163, 83, 147) — the output order
# the reference uses (tools/2.extend_gap.py:136).
ROW_99, ROW_163, ROW_83, ROW_147 = 0, 1, 2, 3
# (left=converted row, right=partner row) per pair:
PAIRS = ((ROW_163, ROW_99), (ROW_83, ROW_147))


def _copy_column(bases, quals, cover, src_row, dst_row, col, gate):
    """Copy (base, qual, cover) at `col` from src_row into dst_row when gate
    (in place on the caller's clones)."""
    w = bases.shape[-1]
    hot = (torch.arange(w, device=bases.device) == col[..., None]) & gate[..., None]
    src_b = torch.gather(bases[..., src_row, :], -1, col[..., None])
    src_q = torch.gather(quals[..., src_row, :], -1, col[..., None])
    bases[..., dst_row, :] = torch.where(hot, src_b, bases[..., dst_row, :])
    quals[..., dst_row, :] = torch.where(hot, src_q, quals[..., dst_row, :])
    cover[..., dst_row, :] = cover[..., dst_row, :] | hot


def extend_gap(bases, quals, cover, la, rd, eligible=None):
    """bases/quals/cover: [..., 4, W] rows ordered (99, 163, 83, 147);
    la/rd: int8 [..., 4] from convert_ag_to_ct (nonzero only on rows 163/83);
    eligible: optional bool [...] (None = all eligible).

    Returns updated (bases, quals, cover) as new tensors. Missing reads (no
    coverage) are left untouched."""
    bases, quals, cover = bases.clone(), quals.clone(), cover.clone()
    for left, right in PAIRS:
        both = cover[..., left, :].any(dim=-1) & cover[..., right, :].any(dim=-1)
        if eligible is not None:
            both = both & eligible
        first_l, _ = span(cover[..., left, :])
        _, last_r = span(cover[..., right, :])
        la_gate = both & (la[..., left] == 1)
        rd_gate = both & (rd[..., left] == 1)
        _copy_column(bases, quals, cover, left, right, first_l, la_gate)
        _copy_column(bases, quals, cover, right, left, last_r, rd_gate)
    return bases, quals, cover
