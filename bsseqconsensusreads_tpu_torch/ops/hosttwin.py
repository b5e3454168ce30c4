"""Host (numpy) twins of the duplex window transforms.

The port's own copy of the JAX package's ops/hosttwin.py (pure numpy).

The duplex stage's raw-unit accounting (pipeline.calling._duplex_rawize)
needs two things the device does not ship back: the POST-transform strand
base per column (the per-strand consensus calls fgbio stows in its ac/bc
extension tags), and the per-column mapping raw base -> converted base
(to count, exactly, how many raw reads agree with the duplex call — the
molecular stage's cB histogram is in RAW space, the duplex call in
converted space).

Both are integer-only functions of tensors the host already holds
(batch bases/cover/convert_mask/eligible + the reference window), so they
are recomputed here rather than shipped: zero wire bytes, and exact —
every operation below is a comparison or select on int8 planes, mirroring
ops.convert.convert_ag_to_ct / ops.extend.extend_gap term for term
(reference semantics: tools/1.convert_AG_to_CT.py:87-171,
tools/2.extend_gap.py:58-110); the same precedent as
models.molecular._overlap_cocall_np / recompute_molecular_counts.

Quals are deliberately NOT mirrored: no rule below depends on them, and
the callers only consume bases/cover.
"""

from __future__ import annotations

import numpy as np

from bsseqconsensusreads_tpu_torch.alphabet import A, C, G, NBASE
from bsseqconsensusreads_tpu_torch.ops.extend import PAIRS

#: T's base code (ops.convert uses the literal for int8 select typing).
_T = 3


def _span_np(cover):
    """First/last covered column per read ([..., W] bool)."""
    w = cover.shape[-1]
    first = np.argmax(cover, axis=-1)
    last = w - 1 - np.argmax(cover[..., ::-1], axis=-1)
    return first, last


def convert_np(bases, cover, ref, convert_mask):
    """Base/cover half of ops.convert.convert_ag_to_ct, in numpy.

    bases: int8 [..., R, W]; cover: bool [..., R, W]; ref: int8 [..., W+1];
    convert_mask: bool [..., R]. Returns (bases, cover, la, rd) with la/rd
    int8 [..., R] — exactly the device op's outputs minus the qual plane.
    """
    bases = np.asarray(bases).copy()
    cover = np.asarray(cover).copy()
    ref = np.asarray(ref)
    w = bases.shape[-1]
    idx = np.arange(w)
    has = cover.any(axis=-1)
    first, _ = _span_np(cover)
    act = np.asarray(convert_mask, bool) & has

    # prepend: one column left of the read, value = reference base there
    can_pre = act & (first > 0)
    pre_col = np.maximum(first - 1, 0)
    pre_hot = (idx == pre_col[..., None]) & can_pre[..., None]
    ref_w = ref[..., :w]
    bases = np.where(pre_hot, np.broadcast_to(ref_w[..., None, :], bases.shape), bases)
    cover = cover | pre_hot

    # per-column rewrite (vectorized select over the original values)
    ref_next = ref[..., 1 : w + 1]
    read_next = np.concatenate(
        [bases[..., 1:], np.full_like(bases[..., :1], NBASE)], axis=-1
    )
    next_cov = np.concatenate(
        [cover[..., 1:], np.zeros_like(cover[..., :1])], axis=-1
    )
    is_cpg = (ref_w == C) & (ref_next == G)
    a_rule = (bases == A) & (ref_w[..., None, :] == G)
    cpg_here = is_cpg[..., None, :]
    c_pair = (bases == C) & cpg_here & next_cov & (read_next == A)
    c_plain = (bases == C) & ~cpg_here
    out = np.where(a_rule, G, bases)
    out = np.where(c_pair | c_plain, np.where(bases == C, _T, out), out)
    gate = act[..., None] & cover
    bases = np.where(gate, out, bases).astype(np.int8)

    # trailing trim: ref past the end is G and the read now ends in C
    _, last = _span_np(cover)
    last_base = np.take_along_axis(bases, last[..., None], axis=-1)[..., 0]
    ref_after = np.take_along_axis(
        np.broadcast_to(ref_next[..., None, :], bases.shape),
        last[..., None], axis=-1,
    )[..., 0]
    trim = act & (ref_after == G) & (last_base == C)
    last_hot = (idx == last[..., None]) & trim[..., None]
    cover = cover & ~last_hot
    bases = np.where(last_hot, NBASE, bases).astype(np.int8)
    return bases, cover, can_pre.astype(np.int8), trim.astype(np.int8)


def extend_np(bases, cover, la, rd, eligible=None):
    """Base/cover half of ops.extend.extend_gap, in numpy.

    One-hot boundary-column copies between the strand rows of each pair
    (left=converted row): LA copies left's first column into the partner,
    RD copies the partner's last column into the left row."""
    bases = np.asarray(bases).copy()
    cover = np.asarray(cover).copy()
    w = bases.shape[-1]
    idx = np.arange(w)
    for left, right in PAIRS:
        has_l = cover[..., left, :].any(axis=-1)
        has_r = cover[..., right, :].any(axis=-1)
        both = has_l & has_r
        if eligible is not None:
            both = both & np.asarray(eligible, bool)
        first_l = np.argmax(cover[..., left, :], axis=-1)
        last_r = w - 1 - np.argmax(cover[..., right, ::-1], axis=-1)
        for src, dst, col, gate in (
            (left, right, first_l, both & (np.asarray(la)[..., left] == 1)),
            (right, left, last_r, both & (np.asarray(rd)[..., left] == 1)),
        ):
            hot = (idx == col[..., None]) & gate[..., None]
            src_b = np.take_along_axis(
                bases[..., src, :], col[..., None], axis=-1
            )
            bases[..., dst, :] = np.where(hot, src_b, bases[..., dst, :])
            cover[..., dst, :] = cover[..., dst, :] | hot
    return bases.astype(np.int8), cover


def strand_call_planes(bases, cover, ref, convert_mask, eligible=None):
    """Post-transform strand rows: (bases int8 [..., R, W], cover bool).

    The per-strand consensus call the duplex merge actually voted with —
    NBASE where the transformed row has no coverage. This is the content
    of the fgbio-style ac/bc tags (duplex emitters) and the basis of
    FilterConsensusReads --require-single-strand-agreement."""
    b, c, la, rd = convert_np(bases, cover, ref, convert_mask)
    b, c = extend_np(b, c, la, rd, eligible)
    return np.where(c, b, NBASE).astype(np.int8), c


def convert_cell(x, act, refc, refn, nxt, nxtcov):
    """THE elementwise conversion rule, broadcastable over any shape:
    what base x becomes at a column with reference base refc, next
    reference base refn, the read's own raw next base nxt (coverage
    nxtcov), on a convert row (act). The duplex exact-ce dissent pass
    (pipeline.calling._exact_strand_errors) applies it, so the rule
    exists once."""
    m = np.where(act & (x == A) & (refc == G), G, x)
    conv_c = np.where(
        (refc == C) & (refn == G),
        np.where(nxtcov & (nxt == A), _T, C),
        _T,
    )
    return np.where(act & (x == C), conv_c, m).astype(np.int8)
