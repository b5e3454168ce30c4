"""The molecular stage, written plainly: one MI family's reads in, its
consensus records out (fgbio CallMolecularConsensusReads as the upstream
runs it, with --consensus-call-overlapping-bases=true, records kept in
place on the genome: the pipeline's aligner `self`).

1. Each template's reads go into the family's window (from its leftmost
   read start to its rightmost read end) by role: R1, R2.
2. Where a template's R1 and R2 both have a base: agreeing bases keep
   the base with the summed quality; disagreeing ones take the base of
   the higher quality with the difference of the two; a tie leaves no
   base (quality 0).
3. Per role, every column is voted (reference.vote) over the templates.
4. Per role with any observation: a record over the columns from the
   first to the last observed one. Tags: MI, RX, cD/cM (the largest and
   smallest depth), cE (errors over depth), cd/ce (per-base depth and
   errors), cB (per base A, C, G, T the observations of that base, with
   the called base's counts set to 0 where a base was called).
"""

from __future__ import annotations

import numpy as np

from reference.vote import NBASE, vote

FPAIRED, FPROPER, FMUNMAP = 0x1, 0x2, 0x8
FREVERSE, FMREVERSE, FREAD1, FREAD2 = 0x10, 0x20, 0x40, 0x80
CODE_CHARS = np.frombuffer(b"ACGTN", np.uint8)


def seq_of(codes) -> str:
    return CODE_CHARS[np.asarray(codes, np.int64)].tobytes().decode()


def cocall(b1, q1, b2, q2):
    """The overlap co-call of one template's two roles, column by column."""
    both = (b1 != NBASE) & (b2 != NBASE)
    agree = both & (b1 == b2)
    differ = both & (b1 != b2)
    win = np.where(q1 >= q2, b1, b2)
    tie = differ & (q1 == q2)
    nb = np.where(agree, b1, np.where(tie, NBASE, win))
    nq = np.where(agree, q1 + q2, np.abs(q1 - q2))
    out_b1, out_b2 = np.where(both, nb, b1), np.where(both, nb, b2)
    out_q1, out_q2 = np.where(both, nq, q1), np.where(both, nq, q2)
    return out_b1, out_q1, out_b2, out_q2


def flag_of(role: int, reverse: bool, mate: bool, mate_reverse: bool) -> int:
    f = FPAIRED | (FREAD2 if role else FREAD1)
    f |= (FPROPER | (FMREVERSE if mate_reverse else 0)) if mate else FMUNMAP
    return f | (FREVERSE if reverse else 0)


def tlen_of(starts, ends, role) -> int:
    if starts[0] < 0 or starts[1] < 0:
        return 0
    lo, hi = min(starts), max(ends)
    return (hi - lo) if starts[role] == lo else -(hi - lo)


def molecular_family(mi: str, rx: str, ref_id: int, reads, params: dict, dtype) -> list[dict]:
    """reads: (flag, template index, pos, codes, quals) of one MI family,
    all `<len>M`. Returns its consensus records (decoded form)."""
    templates: dict = {}
    for flag, ti, pos, codes, quals in reads:
        templates.setdefault(ti, {})[1 if flag & FREAD2 else 0] = (
            np.asarray(codes, np.int64), np.asarray(quals, np.int64), pos, bool(flag & FREVERSE))
    lo = min(p for t in templates.values() for (_c, _q, p, _r) in t.values())
    hi = max(p + len(c) for t in templates.values() for (c, _q, p, _r) in t.values())
    w = hi - lo
    n = len(templates)
    b = np.full((n, 2, w), NBASE, np.int64)
    q = np.zeros((n, 2, w), np.int64)
    rev_votes = np.zeros((2, 2), np.int64)
    for i, ti in enumerate(sorted(templates)):
        for role, (codes, quals, pos, rev) in templates[ti].items():
            b[i, role, pos - lo:pos - lo + len(codes)] = codes
            q[i, role, pos - lo:pos - lo + len(codes)] = quals
            rev_votes[role, int(rev)] += 1
    if params["consensus_call_overlapping_bases"]:
        b1, q1, b2, q2 = cocall(b[:, 0], q[:, 0], b[:, 1], q[:, 1])
        b = np.stack([b1, b2], axis=1)
        q = np.stack([q1, q2], axis=1)
    role_rev = [bool(rev_votes[r, 1] > rev_votes[r, 0]) for r in range(2)]
    votes = [vote(b[:, r], q[:, r], params, dtype) for r in range(2)]
    spans = []
    for r in range(2):
        cov = np.nonzero(votes[r]["depth"] > 0)[0]
        spans.append((int(cov[0]), int(cov[-1]) + 1) if cov.size else None)
    starts = [lo + s[0] if s else -1 for s in spans]
    ends = [lo + s[1] if s else -1 for s in spans]
    out = []
    for r in range(2):
        if spans[r] is None:
            continue
        a, z = spans[r]
        v = {k: x[a:z] for k, x in votes[r].items()}
        obs = (b[:, r, a:z] != NBASE) & (q[:, r, a:z] >= params["min_input_base_quality"])
        counts = np.stack([(obs & (b[:, r, a:z] == x)).sum(axis=0) for x in range(4)])
        called = v["base"] != NBASE
        for x in range(4):
            counts[x, called & (v["base"] == x)] = 0
        depth_sum = int(v["depth"].sum())
        other = 1 - r
        mate = starts[other] >= 0
        out.append({
            "qname": mi, "flag": flag_of(r, role_rev[r], mate, role_rev[other]),
            "ref_id": ref_id, "pos": starts[r], "mapq": 60, "cigar": [(0, z - a)],
            "next_ref_id": ref_id if mate else -1, "next_pos": starts[other] if mate else -1,
            "tlen": tlen_of(starts, ends, r), "seq": seq_of(v["base"]),
            "qual": v["qual"].astype(np.uint8).tobytes(),
            "tags": {
                "MI": mi, "RX": rx, "cD": int(v["depth"].max()), "cM": int(v["depth"].min()),
                "cE": np.float32(int(v["errors"].sum()) / depth_sum if depth_sum else 0.0),
                "cd": v["depth"].astype(np.int64), "ce": v["errors"].astype(np.int64),
                "cB": counts.reshape(-1).astype(np.int64),
            },
        })
    return out
