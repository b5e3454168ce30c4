"""Single-strand ("molecular") consensus on torch tensors.

The port of the JAX package's models/molecular.py — the equivalent of
`fgbio CallMolecularConsensusReads` as the reference invokes it
(main.snake.py:54): per MI family, a per-column quality-weighted
log-likelihood vote under the fgbio error model.

Model (documented fgbio semantics, as in the JAX package):
 1. Raw base error p = 10^(-q/10) is combined with the post-UMI error prior
    via the two-independent-trials rule (ops.phred.prob_error_two_trials);
    the per-observation log terms come from the pinned table
    (ops.phred.log_table), indexed by the integer qual.
 2. Optionally, overlapping R1/R2 bases of the same template are co-called
    first: agreement keeps the base with summed quality; disagreement keeps
    the higher-quality base with the quality difference (a tie masks both).
 3. Per window column, per candidate base b: LL(b) = sum over observations of
    log(1-p) if obs==b else log(p/3). Consensus base = argmax; its error
    probability is the posterior 1 - softmax(LL)[argmax].
 4. The consensus error is combined with the pre-UMI error prior (two-trials
    again), clamped to Phred [2, 93].

The vote itself runs in ops.cuda_vote.seg_vote (the hand-written kernel on
the card, its plain version here on the CPU). Quals are carried as int16:
every qual on the path is an integer, and the table covers 0..511.
"""

from __future__ import annotations

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import NBASE, NUM_BASES
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote, phred
from bsseqconsensusreads_tpu_torch.ops.phred import NO_CALL_QUAL
from bsseqconsensusreads_tpu_torch.ops.wire import (
    split_duplex_wire,
    split_molecular_rows_wire,
    unpack_duplex_inputs,
    unpack_rows_wire_inputs,
)

#: Absolute log-LL band treated as a vote tie (see vote_finalize): above
#: float32 one-ulp summation noise at working magnitudes, below the
#: 3e-6 likelihood-ratio margin the JAX package's golden suites treat as
#: distinct. csrc/vote.cu uses the same value.
ARGMAX_TIE_TOL = 2.5e-6


def overlap_cocall(bases, quals):
    """Co-call overlapping R1/R2 bases within each template.

    bases: int8 [..., 2, W]; quals: integer [..., 2, W] (int16 on the
    path). Returns updated (bases, quals). Columns covered by both roles:
      * agreement   -> both keep the base, quality = q1 + q2
      * disagreement-> both take the higher-quality base, quality = |q1 - q2|;
                       an exact tie masks the column on both roles (no winner).
    Exact for integer quals: comparisons, sums and absolute differences.
    Implements --consensus-call-overlapping-bases=true (main.snake.py:54,163).
    """
    b1, b2 = bases[..., 0, :], bases[..., 1, :]
    q1, q2 = quals[..., 0, :], quals[..., 1, :]
    both = (b1 != NBASE) & (b2 != NBASE)
    agree = both & (b1 == b2)
    disagree = both & (b1 != b2)
    qdiff = (q1 - q2).abs()
    winner = torch.where(q1 >= q2, b1, b2)
    tie = disagree & (qdiff == 0)
    new_b = torch.where(agree, b1, torch.where(disagree, winner, -1))
    new_q = torch.where(agree, q1 + q2, torch.where(disagree, qdiff, 0))
    new_b = torch.where(tie, NBASE, new_b).to(bases.dtype)
    new_q = new_q.to(quals.dtype)
    return (
        torch.stack(
            [torch.where(both, new_b, b1), torch.where(both, new_b, b2)], dim=-2
        ),
        torch.stack(
            [torch.where(both, new_q, q1), torch.where(both, new_q, q2)], dim=-2
        ),
    )


def vote_contrib(bases, quals, table, min_input_base_quality: int):
    """Per-observation vote contributions: (ll [..., W, 4], cnt [..., W, 4]).

    The JAX package's _vote_contrib term for term, with the log terms
    looked up in `table` (ops.phred.log_table): w * (onehot * log_ok +
    (1 - onehot) * log_err) and onehot * w. Unobserved cells (NBASE or
    below min input qual) contribute zeros in every channel."""
    observed = (bases != NBASE) & (quals >= min_input_base_quality)
    qi = quals.long().clamp(0, phred.TABLE_QUALS - 1)
    log_ok = table[qi, 0]
    log_err = table[qi, 1]
    cand = torch.arange(NUM_BASES, device=bases.device)
    onehot = (bases.long()[..., None] == cand).to(torch.float32)
    w_obs = observed.to(torch.float32)[..., None]
    ll = w_obs * (onehot * log_ok[..., None] + (1.0 - onehot) * log_err[..., None])
    return ll, onehot * w_obs


def vote_partials_segments(bases, quals, offsets, params: ConsensusParams):
    """Segmented vote sums, added IN ROW ORDER.

    bases int8 [N, P, W], quals integer [N, P, W], offsets int32 [S + 1]:
    segment s owns rows offsets[s]:offsets[s+1]. Returns (ll [S, P, W, 4]
    float32, cnt [S, P, W, 4] float32, depth [S, P, W] int32).

    Step k adds row k of every segment longer than k, so each segment's
    sum is ((0 + c0) + c1) + ... — the order in which the JAX package's
    sorted segment_sum adds, and the order csrc/vote.cu walks. Never
    index_add_/scatter_add_: on CUDA those have no fixed order."""
    dev = bases.device
    n_seg = offsets.numel() - 1
    _, p, w = bases.shape
    table = phred.log_table(params.error_rate_post_umi, dev)
    # graftlint: disable=padded-batch-flops -- the packed route's per-segment output: S
    # families x P strands x W columns, no template axis to pad
    ll = torch.zeros((n_seg, p, w, NUM_BASES), dtype=torch.float32, device=dev)
    cnt = torch.zeros_like(ll)
    offsets = offsets.long()
    lens = offsets[1:] - offsets[:-1]
    max_len = int(lens.max()) if n_seg else 0
    for k in range(max_len):
        sel = torch.nonzero(lens > k).squeeze(1)
        rows = offsets[sel] + k
        c_ll, c_cnt = vote_contrib(
            bases[rows], quals[rows], table, params.min_input_base_quality
        )
        ll[sel] = ll[sel] + c_ll
        cnt[sel] = cnt[sel] + c_cnt
    # per-base counts are exact small integers in float32
    depth = cnt.sum(dim=-1).to(torch.int32)
    return ll, cnt, depth


def vote_finalize(ll, depth, params: ConsensusParams):
    """Turn reduced vote sums into (base int8, qual uint8): the JAX
    package's vote_finalize op for op.

    Tied columns call the LOWEST base index within ARGMAX_TIE_TOL of the
    max. The posterior denominator sums the candidate exponentials in
    ascending order via a 5-comparator sorting network over ll - max
    BEFORE the exp; the largest term is exp(0) == 1.0 exactly, so only
    three exps are evaluated."""
    p2 = torch.tensor(
        phred.pre_umi_prob(params.error_rate_pre_umi), dtype=torch.float32,
        device=ll.device,
    )
    called = depth > 0
    m = ll.amax(dim=-1, keepdim=True)
    near = ll >= (m - ARGMAX_TIE_TOL)
    cand = torch.arange(NUM_BASES, device=ll.device)
    cons = torch.where(near, cand, NUM_BASES).amin(dim=-1)
    d = ll - m
    a, b = torch.minimum(d[..., 0], d[..., 1]), torch.maximum(d[..., 0], d[..., 1])
    c, e = torch.minimum(d[..., 2], d[..., 3]), torch.maximum(d[..., 2], d[..., 3])
    a, c = torch.minimum(a, c), torch.maximum(a, c)
    b = torch.minimum(b, e)
    b, c = torch.minimum(b, c), torch.maximum(b, c)
    denom = ((torch.exp(a) + torch.exp(b)) + torch.exp(c)) + 1.0
    p_cons = 1.0 - 1.0 / denom
    qual = phred.prob_to_phred(phred.prob_error_two_trials(p_cons, p2))
    keep = called & ~(qual < params.min_consensus_base_quality)
    cons = torch.where(keep, cons, NBASE).to(torch.int8)
    qual = torch.where(keep, qual, float(NO_CALL_QUAL))
    return cons, torch.round(qual).to(torch.uint8)


def errors_from_counts(cnt, depth, cons):
    """errors = depth - cnt[consensus] where called (0 where masked) — the
    count trick: every observation agrees with the call or is an error."""
    idx = cons.long().clamp(0, NUM_BASES - 1)[..., None]
    cnt_cons = torch.gather(cnt, -1, idx)[..., 0].to(torch.int32)
    return torch.where(cons != NBASE, depth - cnt_cons, 0).to(torch.int32)


def narrow_outputs(out: dict) -> dict:
    """Narrow count dtypes for the device->host hop: depths and errors fit
    int16, per-strand coverage fits int8 (the JAX package's dtypes)."""
    narrow = {"depth": torch.int16, "errors": torch.int16, "a_depth": torch.int8,
              "b_depth": torch.int8, "a_err": torch.int8, "b_err": torch.int8}
    return {k: (v.to(narrow[k]) if k in narrow else v) for k, v in out.items()}


def segment_offsets(seg, num_families: int):
    """int32 [num_families + 1] row offsets of ascending family ids `seg`
    (pad rows carry the sentinel id num_families and fall past the last
    offset)."""
    ids = torch.arange(num_families + 1, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg.contiguous(), ids).to(torch.int32)


def host_segment_offsets(seg, num_families: int) -> np.ndarray:
    """segment_offsets on the host: int32 [num_families + 1] row offsets of
    the ascending family ids `seg` (a numpy array) — what the device
    offsets hold, for seg_vote's deep plan."""
    ids = np.arange(num_families + 1, dtype=np.int64)
    return np.asarray(np.searchsorted(np.asarray(seg), ids, side="left"), dtype=np.int32)


def regular_offsets(segments: int, rows: int) -> np.ndarray:
    """int32 [segments + 1] host offsets k * rows (padded and 2-row
    segments), for seg_vote's deep plan."""
    return np.arange(0, segments * rows + 1, rows, dtype=np.int32)


def molecular_consensus_packed(bases, quals, seg, num_families: int,
                               params: ConsensusParams = ConsensusParams(),
                               host_offsets=None):
    """Segment-packed molecular consensus.

    bases int8 [N, 2, W] — every family's template rows concatenated on
    one dense axis (ops.encode.pack_molecular_rows); quals integer
    [N, 2, W]; seg int32 [N] ascending family ids, pad rows the sentinel
    `num_families`. Returns {base, qual, depth int16, errors int16} of
    [num_families, 2, W] on the input's device: the overlap co-call, then
    one seg_vote call (ragged offsets, 2 planes). On the card it takes
    host_offsets, host_segment_offsets of the host's seg."""
    quals = quals.to(torch.int16)
    if params.consensus_call_overlapping_bases:
        bases, quals = overlap_cocall(bases, quals)
    offsets = segment_offsets(seg, num_families)
    return cuda_vote.seg_vote(
        bases.contiguous(), quals.contiguous(), offsets, params,
        host_offsets=host_offsets,
    )


def molecular_consensus(bases, quals,
                        params: ConsensusParams = ConsensusParams()):
    """Padded molecular consensus: bases int8 [F, T, 2, W], quals integer
    [F, T, 2, W] -> the same dict of [F, 2, W] planes. Padding rows carry
    no observation, so the padded vote is seg_vote over offsets k * T."""
    f, t, _, w = bases.shape
    quals = quals.to(torch.int16)
    if params.consensus_call_overlapping_bases:
        bases, quals = overlap_cocall(bases, quals)
    offsets = torch.arange(
        0, f * t + 1, t, dtype=torch.int32, device=bases.device
    )
    return cuda_vote.seg_vote(
        bases.reshape(f * t, 2, w).contiguous(),
        quals.reshape(f * t, 2, w).contiguous(), offsets, params,
        host_offsets=regular_offsets(f, t),
    )


def pack_molecular_outputs(out: dict):
    """Pack the molecular output dict into one family-major planar byte
    wire: per family [12, W] u8 rows — 0-1 base, 2-3 qual, 4-5 depth lo,
    6-7 depth hi, 8-9 errors lo, 10-11 errors hi (role-major within each
    pair). Byte-identical to the JAX package's u32 wire read as bytes; one
    device->host copy per batch. Unpack with unpack_molecular_outputs."""
    f, _, w = out["base"].shape
    d8 = out["depth"].to(torch.int16).contiguous().view(torch.uint8).reshape(f, 2, w, 2)
    e8 = out["errors"].to(torch.int16).contiguous().view(torch.uint8).reshape(f, 2, w, 2)
    planes = torch.cat(
        [
            out["base"].view(torch.uint8), out["qual"],
            d8[..., 0], d8[..., 1], e8[..., 0], e8[..., 1],
        ],
        dim=-2,
    )  # [F, 12, W]
    return planes.reshape(-1)


def unpack_molecular_outputs(wire, f: int, w: int) -> dict:
    """numpy inverse of pack_molecular_outputs -> dict of [f, 2, w] arrays
    (host side)."""
    wire = np.asarray(wire)
    u8 = wire.view(np.uint8) if wire.dtype != np.uint8 else wire
    planes = u8[: f * 12 * w].reshape(f, 12, w)
    depth = (
        planes[:, 4:6].astype(np.uint16)
        | (planes[:, 6:8].astype(np.uint16) << 8)
    ).astype(np.int16)
    errors = (
        planes[:, 8:10].astype(np.uint16)
        | (planes[:, 10:12].astype(np.uint16) << 8)
    ).astype(np.int16)
    return {
        "base": planes[:, 0:2].astype(np.int8),
        "qual": planes[:, 2:4].copy(),
        "depth": depth,
        "errors": errors,
    }


def molecular_wire_kernel(words, f: int, t: int, w: int,
                          params: ConsensusParams = ConsensusParams(),
                          qual_mode: str = "q8") -> torch.Tensor:
    """The molecular stage on the v1 wire: `words` is
    ops.wire.pack_molecular_inputs' 2T-row wire as its bytes on the
    device, split and unpacked there, voted as the padded envelope
    (molecular_consensus, one seg_vote launch) and returned as the
    unpacked route's output wire (pack_molecular_outputs)."""
    r = t * 2
    nib, qual, meta, _starts, _limits = split_duplex_wire(words, f, w, r=r, qual_mode=qual_mode)
    bases, quals, _cover, _cm, _el = unpack_duplex_inputs(
        nib, qual, meta, f, w, r=r, qual_mode=qual_mode
    )
    out = molecular_consensus(bases.reshape(f, t, 2, w), quals.reshape(f, t, 2, w), params)
    return pack_molecular_outputs(out)


def molecular_wire_packed_kernel(words, n_rows: int, num_families: int, w: int,
                                 params: ConsensusParams = ConsensusParams(),
                                 qual_mode: str = "q8", host_offsets=None) -> torch.Tensor:
    """The molecular stage on the packed-rows wire (v2,
    ops.wire.pack_molecular_rows_wire) as its bytes on the device: the
    dense rows and their segment ids unpacked there, voted by
    molecular_consensus_packed (one seg_vote call, ragged offsets; on the
    card with host_offsets, the packed rows' host_segment_offsets) and
    returned as the same output wire as molecular_wire_kernel."""
    nib, qual, seg, _offsets = split_molecular_rows_wire(
        words, n_rows, num_families, w, qual_mode=qual_mode
    )
    bases, quals = unpack_rows_wire_inputs(nib, qual, n_rows, w, qual_mode=qual_mode)
    out = molecular_consensus_packed(bases, quals, seg.view(torch.int32), num_families, params,
                                     host_offsets=host_offsets)
    return pack_molecular_outputs(out)


def _overlap_cocall_np(bases, quals):
    """numpy twin of overlap_cocall for [..., 2, W] tensors (exact for
    integer-valued quals in any dtype; callers pass int16)."""
    b1, b2 = bases[..., 0, :], bases[..., 1, :]
    q1, q2 = quals[..., 0, :], quals[..., 1, :]
    both = (b1 != NBASE) & (b2 != NBASE)
    agree = both & (b1 == b2)
    disagree = both & (b1 != b2)
    qsum = q1 + q2
    qdiff = np.abs(q1 - q2)
    winner = np.where(q1 >= q2, b1, b2)
    tie = disagree & (qdiff == 0)
    new_b = np.where(agree, b1, np.where(disagree, winner, -1))
    zero = quals.dtype.type(0)
    new_q = np.where(agree, qsum, np.where(disagree, qdiff, zero))
    out_b1 = np.where(both, np.where(tie, NBASE, new_b), b1)
    out_b2 = np.where(both, np.where(tie, NBASE, new_b), b2)
    out_q1 = np.where(both, new_q, q1)
    out_q2 = np.where(both, new_q, q2)
    return (
        np.stack([out_b1, out_b2], axis=-2).astype(bases.dtype),
        np.stack([out_q1, out_q2], axis=-2),
    )


def singleton_consensus_host(bases, quals,
                             params: ConsensusParams = ConsensusParams(),
                             device=None,
                             with_histogram: bool = False) -> dict:
    """Host fast path for T == 1 batches: numerically identical to
    molecular_consensus on [F, 1, 2, W] with no device round trip.

    Singleton families are ~70% of real cfDNA families; their "vote" is
    the R1/R2 overlap co-call followed by a single-observation finalize —
    a pure function of the (possibly summed) qual, served from the
    kernel-built tables (ops.reconstruct.qual_tables on `device`, so the
    rounding of the device that votes the other batches is captured). The
    tables also carry the two non-obvious base verdicts: the masked call
    (N) and the low-qual ARGMAX FLIP — an observation with post-UMI error
    probability > 0.75 makes every other base likelier, so the call
    becomes the lowest-index other base with one counted error.
    """
    f, t, _, w = bases.shape
    if t != 1:
        raise ValueError(f"singleton path needs T == 1 batches, got T={t}")
    from bsseqconsensusreads_tpu_torch.ops.reconstruct import qual_tables

    t_single, _a, _d, t_masked, t_flip = qual_tables(params, device)
    b = np.asarray(bases)[:, 0]  # [F, 2, W]
    q = np.asarray(quals)[:, 0].astype(np.int16)
    if params.consensus_call_overlapping_bases:
        b, q = _overlap_cocall_np(b, q)
    observed = (b != NBASE) & (q >= params.min_input_base_quality)
    # co-called quals are sums of two Phreds <= 93 each: always < 256
    qi = np.clip(q, 0, 255).astype(np.uint8)
    masked = t_masked[qi]
    flip = t_flip[qi]
    # argmax ties across the three other bases resolve to the lowest index
    call = np.where(flip, np.where(b == 0, 1, 0), b)
    called = observed & ~masked
    out = {
        "base": np.where(called, call, NBASE).astype(np.int8),
        "qual": np.where(called, t_single[qi], NO_CALL_QUAL).astype(np.uint8),
        "depth": observed.astype(np.int16),
        "errors": (called & flip).astype(np.int16),
    }
    if with_histogram:
        # the cB tag payload from THIS pass's cocalled observations
        counts = np.empty(b.shape[:2] + (NUM_BASES, b.shape[-1]), np.uint16)
        for x in range(NUM_BASES):
            counts[:, :, x, :] = observed & (b == x)
        out["bcount"] = counts
    return out


def recompute_molecular_counts(out: dict, bases, quals,
                               params: ConsensusParams,
                               with_histogram: bool = False) -> dict:
    """Fill depth/errors from the host's own input tensors — exact integer
    tallies over the co-called observations (the JAX package's twin).

    with_histogram: also stash the cB raw base histogram in out['bcount']
    and derive depth/errors from it."""
    b = np.asarray(bases)  # [F, T, 2, W]
    q = np.asarray(quals).astype(np.int16)
    if params.consensus_call_overlapping_bases:
        b, q = _overlap_cocall_np(b, q)
    observed = (b != NBASE) & (q >= params.min_input_base_quality)
    cons = np.asarray(out["base"])  # [F, 2, W]
    out = dict(out)
    if with_histogram:
        counts = _base_histogram(b, observed)
        out["bcount"] = counts
        depth = counts.sum(axis=2, dtype=np.int32).astype(np.int16)
        cnt_cons = np.take_along_axis(
            counts, np.clip(cons, 0, 3)[:, :, None, :].astype(np.int64),
            axis=2,
        )[:, :, 0, :].astype(np.int16)
        out["depth"] = depth
        out["errors"] = np.where(cons != NBASE, depth - cnt_cons, 0).astype(
            np.int16
        )
        return out
    out["depth"] = observed.sum(axis=1).astype(np.int16)
    out["errors"] = (
        (observed & (cons[:, None] != NBASE) & (b != cons[:, None]))
        .sum(axis=1).astype(np.int16)
    )
    return out


def _base_histogram(b, observed):
    """uint16 [F, 2, 4, W] per-base counts over co-called observations."""
    f, _t, _r, w = b.shape
    counts = np.empty((f, 2, NUM_BASES, w), np.uint16)
    for x in range(NUM_BASES):
        counts[:, :, x, :] = (observed & (b == x)).sum(axis=1)
    return counts


def molecular_base_counts(bases, quals, params: ConsensusParams) -> np.ndarray:
    """Per-column raw base histogram: uint16 [F, 2, 4, W] under the SAME
    observation filter as the vote (post overlap-cocall, min input qual) —
    the payload of the molecular emitters' cB tag, which the duplex stage
    reads to count raw reads against the duplex call exactly."""
    b = np.asarray(bases)  # [F, T, 2, W]
    q = np.asarray(quals).astype(np.int16)
    if params.consensus_call_overlapping_bases:
        b, q = _overlap_cocall_np(b, q)
    observed = (b != NBASE) & (q >= params.min_input_base_quality)
    return _base_histogram(b, observed)


def sparsify_base_counts(counts, base) -> np.ndarray:
    """Zero the CONSENSUS-CALL plane of the cB histogram (new array): the
    call plane is derivable (cd - ce at called columns), so the stored tag
    is a sparse DISSENT histogram. Columns whose consensus is masked
    (NBASE) keep all four planes."""
    counts = np.asarray(counts).copy()  # [F, 2, 4, W]
    base = np.asarray(base)  # [F, 2, W]
    called = base != NBASE
    sel = np.clip(base, 0, 3)[:, :, None, :].astype(np.int64)
    plane = np.take_along_axis(counts, sel, axis=2)
    np.put_along_axis(
        counts, sel, np.where(called[:, :, None, :], 0, plane), axis=2
    )
    return counts
