"""Scalar-Python oracles: per-base transcriptions of the model semantics.

The port's copy of the JAX package's utils/oracle.py (the tests hold each
against the JAX package's). Deliberately naive per-base loops with stdlib
floats — an independent transcription of the documented model semantics.
oracle_convert_read is also the convert-stage treatment of the duplex
stage's passthrough records (pipeline.calling._passthrough_records).
"""

from __future__ import annotations

import math

NBASE = 4


def _perr(q: float) -> float:
    return 10.0 ** (-q / 10.0)


def _two_trials(p1: float, p2: float) -> float:
    return p1 * (1 - p2) + (1 - p1) * p2 + (2.0 / 3.0) * p1 * p2


def _to_phred(p: float) -> float:
    p = min(max(p, 1e-12), 1.0)
    return min(max(-10.0 * math.log10(p), 2.0), 93.0)


def oracle_overlap_cocall(bases, quals):
    """bases/quals: nested lists [T][2][W]. Returns updated copies."""
    T = len(bases)
    W = len(bases[0][0])
    out_b = [[list(bases[t][r]) for r in range(2)] for t in range(T)]
    out_q = [[list(quals[t][r]) for r in range(2)] for t in range(T)]
    for t in range(T):
        for w in range(W):
            b1, b2 = bases[t][0][w], bases[t][1][w]
            q1, q2 = float(quals[t][0][w]), float(quals[t][1][w])
            if b1 == NBASE or b2 == NBASE:
                continue
            if b1 == b2:
                for r in range(2):
                    out_q[t][r][w] = q1 + q2
            else:
                if q1 == q2:
                    for r in range(2):
                        out_b[t][r][w] = NBASE
                        out_q[t][r][w] = 0.0
                else:
                    win = b1 if q1 > q2 else b2
                    for r in range(2):
                        out_b[t][r][w] = win
                        out_q[t][r][w] = abs(q1 - q2)
    return out_b, out_q


def oracle_column_vote(
    column_bases,
    column_quals,
    error_rate_pre_umi=45.0,
    error_rate_post_umi=30.0,
    min_input_base_quality=0,
    min_consensus_base_quality=0,
):
    """One window column: lists of base codes / phred quals (one per read).

    Returns (base, qual, depth, errors) with base==4 when uncalled.
    """
    p_post = _perr(error_rate_post_umi)
    ll = [0.0, 0.0, 0.0, 0.0]
    obs = []
    for b, q in zip(column_bases, column_quals):
        if b == NBASE or q < min_input_base_quality:
            continue
        p = _two_trials(_perr(float(q)), p_post)
        p = min(max(p, 1e-12), 1.0 - 1e-7)
        obs.append(b)
        for cand in range(4):
            ll[cand] += math.log1p(-p) if cand == b else math.log(p / 3.0)
    depth = len(obs)
    if depth == 0:
        return NBASE, 2, 0, 0
    cons = max(range(4), key=lambda c: ll[c])
    m = max(ll)
    # canonical ascending-order denominator, matching the kernels'
    # permutation-invariant summation (models/molecular.vote_finalize)
    e = sorted(math.exp(v - m) for v in ll)
    denom = ((e[0] + e[1]) + e[2]) + e[3]
    p_cons = 1.0 - math.exp(ll[cons] - m) / denom
    p_final = _two_trials(p_cons, _perr(error_rate_pre_umi))
    qual = _to_phred(p_final)
    if qual < min_consensus_base_quality:
        return NBASE, 2, depth, 0
    errors = sum(1 for b in obs if b != cons)
    return cons, int(round(qual)), depth, errors


def oracle_convert_read(seq: str, quals, pos: int, genome: str,
                        pos0: str = "skip"):
    """Scalar oracle for the B-strand AG->CT conversion (SURVEY.md §3.2).

    seq is the softclip-trimmed read (genome-forward orientation), quals a
    list of Phred ints, pos its 0-based mapped position. Returns
    (seq, quals, pos, la, rd). Mirrors the reference loop exactly — mutable
    list, skip after a CpG pair rewrite — except at pos==0 under the
    default pos0='skip', where the framework deliberately skips the prepend
    (see ops/convert.py docstring) instead of shifting the read out of
    register; pos0='shift' reproduces the reference's
    prepend-and-clamp register shift (tools/1.convert_AG_to_CT.py:87-92).
    """
    prepend = pos > 0 or pos0 == "shift"
    if prepend:
        new_pos = max(pos - 1, 0)
        s = list("N" + seq)
        q = [40] + list(quals)
    else:
        new_pos = pos
        s = list(seq)
        q = list(quals)
    L = len(s)
    # the reference upper-cases its fetch (tools/1.convert_AG_to_CT.py:107)
    ref = genome[new_pos : new_pos + L + 1].upper()
    ref += "N" * (L + 1 - len(ref))
    if prepend:
        s[0] = ref[0]
    i = 0
    while i < L:
        b, r = s[i], ref[i]
        if b == "A":
            if r == "G":
                s[i] = "G"
        elif b == "C":
            if r == "C" and ref[i + 1] == "G":
                if i + 1 < L and s[i + 1] == "A":
                    s[i] = "T"
                    s[i + 1] = "G"
                    i += 1
            else:
                s[i] = "T"
        i += 1
    rd = 0
    if ref[L] == "G" and s and s[-1] == "C":
        s.pop()
        q.pop()
        rd = 1
    return "".join(s), q, new_pos, int(prepend), rd


def oracle_extend_group(reads: dict) -> dict:
    """Scalar oracle for gap extension (SURVEY.md §3.3).

    reads: {flag: {'seq': str, 'qual': list[int], 'pos': int,
                   'la': int, 'rd': int}} for flags among (99, 163, 83, 147).
    Returns the updated dict (copies). Pairs (99,163) and (83,147); the read
    with flag in {83,163} is the 'left' (converted) one. LA(left)==1 prepends
    left's first base to the right read (start-1); RD(left)==1 appends the
    right read's last base to the left read.
    """
    out = {f: dict(r) for f, r in reads.items()}
    for left_flag, right_flag in ((163, 99), (83, 147)):
        if left_flag not in out or right_flag not in out:
            continue
        left, right = out[left_flag], out[right_flag]
        if left["la"] == 1:
            right["seq"] = left["seq"][0] + right["seq"]
            right["qual"] = [left["qual"][0]] + list(right["qual"])
            right["pos"] -= 1
        if left["rd"] == 1:
            left["seq"] = left["seq"] + right["seq"][-1]
            left["qual"] = list(left["qual"]) + [right["qual"][-1]]
    return out


def oracle_molecular_family(bases, quals, params) -> dict:
    """Whole family [T][2][W] -> {'base','qual','depth','errors'}: [2][W]."""
    if params.consensus_call_overlapping_bases:
        bases, quals = oracle_overlap_cocall(bases, quals)
    T = len(bases)
    W = len(bases[0][0])
    out = {k: [[0] * W, [0] * W] for k in ("base", "qual", "depth", "errors")}
    for role in range(2):
        for w in range(W):
            col_b = [bases[t][role][w] for t in range(T)]
            col_q = [quals[t][role][w] for t in range(T)]
            b, q, d, e = oracle_column_vote(
                col_b,
                col_q,
                params.error_rate_pre_umi,
                params.error_rate_post_umi,
                params.min_input_base_quality,
                params.min_consensus_base_quality,
            )
            out["base"][role][w] = b
            out["qual"][role][w] = q
            out["depth"][role][w] = d
            out["errors"][role][w] = e
    return out
