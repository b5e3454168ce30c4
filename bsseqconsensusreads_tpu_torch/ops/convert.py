"""B-strand AG->CT conversion as a window-space transform on torch tensors.

The port of the JAX package's ops/convert.py — the equivalent of the
reference's per-read Python loop (tools/1.convert_AG_to_CT.py:69-186):
rewrite aligned B-strand reads (flags 83/163/1) from A/G space into C/T
space using the reference genome, so the two duplex strands become
directly comparable. Elementwise on the device; the JAX package leaves it
to XLA too, outside any Pallas kernel.

Semantics reproduced exactly (reference line cites):
 * prepend one base whose value is the reference base there, quality 40
   ('I'), shifting pos one left (tools/1.convert_AG_to_CT.py:87-121,174-177);
   LA tag = 1 when prepended;
 * per-base rewrite (:122-150):
     read A over ref G -> G (bisulfite-converted signal; restore G)
     read C at a ref CpG with next read base A -> T (and the next base
       becomes G via the A-over-G rule)
     read C at a ref CpG otherwise -> stays C
     read C not in CpG context -> T (in-silico full conversion)
     everything else unchanged;
 * if the reference base just past the read end is G and the converted read
   now ends in C, trim that trailing C (methylation state unknowable);
   RD tag = 1 (:155-171).

A read mapped at reference position 0 cannot be prepended (no column to
its left): the prepend is skipped and LA=0, the JAX package's documented
default (pos0='shift' at the encode layer reproduces the reference's
register shift).
"""

from __future__ import annotations

import torch

from bsseqconsensusreads_tpu_torch.alphabet import A, C, G, NBASE, T

PREPEND_QUAL = 40  # 'I' (tools/1.convert_AG_to_CT.py:177)


def span(cover):
    """(first, last) covered column per read of a [..., W] bool mask, int64.

    An uncovered read reports first 0 and last W-1 — what argmax over the
    mask and its reverse give, the JAX package's convention."""
    w = cover.shape[-1]
    idx = torch.arange(w, device=cover.device)
    has = cover.any(dim=-1)
    first = torch.where(cover, idx, w).amin(dim=-1)
    last = torch.where(cover, idx, -1).amax(dim=-1)
    return torch.where(has, first, 0), torch.where(has, last, w - 1)


def convert_ag_to_ct(bases, quals, cover, ref, convert_mask):
    """Vectorized conversion over a family window.

    bases:  int8  [..., R, W]  base codes in genome-forward orientation
    quals:  int16 [..., R, W]  integer Phreds
    cover:  bool  [..., R, W]  contiguous covered span per read
    ref:    int8  [..., W+1]   reference codes for the window + 1 extra column
    convert_mask: bool [..., R]  True for B-strand reads (flags 83/163/1)

    Returns (bases, quals, cover, la, rd) with la/rd int8 [..., R].
    """
    w = bases.shape[-1]
    idx = torch.arange(w, device=bases.device)
    has = cover.any(dim=-1)
    first, last = span(cover)
    act = convert_mask & has

    # -- prepend: one column left of the read, value = reference base there.
    can_pre = act & (first > 0)
    pre_col = torch.clamp(first - 1, min=0)
    pre_hot = (idx == pre_col[..., None]) & can_pre[..., None]
    ref_w = ref[..., :w]
    bases = torch.where(pre_hot, ref_w[..., None, :], bases)
    quals = torch.where(pre_hot, PREPEND_QUAL, quals)
    cover = cover | pre_hot

    # -- per-column rewrite.
    ref_next = ref[..., 1 : w + 1]
    read_next = torch.cat([bases[..., 1:], torch.full_like(bases[..., :1], NBASE)], dim=-1)
    next_cov = torch.cat([cover[..., 1:], torch.zeros_like(cover[..., :1])], dim=-1)
    cpg_here = ((ref_w == C) & (ref_next == G))[..., None, :]
    a_rule = (bases == A) & (ref_w[..., None, :] == G)
    c_pair = (bases == C) & cpg_here & next_cov & (read_next == A)
    c_plain = (bases == C) & ~cpg_here
    out = torch.where(a_rule, G, bases)
    out = torch.where(c_pair | c_plain, T, out)
    bases = torch.where(act[..., None] & cover, out, bases)

    # -- trailing trim: ref base past the end is G and read now ends in C.
    last_base = torch.gather(bases, -1, last[..., None])[..., 0]
    ref_after = torch.gather(
        ref_next[..., None, :].expand(bases.shape), -1, last[..., None]
    )[..., 0]
    trim = act & (ref_after == G) & (last_base == C)
    last_hot = (idx == last[..., None]) & trim[..., None]
    cover = cover & ~last_hot
    bases = torch.where(last_hot, NBASE, bases)
    quals = torch.where(last_hot, 0, quals)

    return bases, quals, cover, can_pre.to(torch.int8), trim.to(torch.int8)
