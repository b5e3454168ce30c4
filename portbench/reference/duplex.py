"""The duplex stage, written plainly: one family's four molecular
consensus records in (A: R1 flag 99, R2 147; B: R1 83, R2 163), its two
duplex records out — the upstream's convert -> extend -> sort ->
CallDuplexConsensusReads chain (tools/1.convert_AG_to_CT.py,
tools/2.extend_gap.py, fgbio --min-reads=0
--consensus-call-overlapping-bases=true).

1. convert (B-strand reads, 163 and 83): prepend the genome's base one
   column left at quality 40 (LA); then read A over genome G -> G; read C
   at a genome CpG -> T when the read's next base is A (that A then turns
   G), else stays C; read C elsewhere -> T; if the genome base past the
   read's end is G and the read now ends in C, drop that C (RD).
2. extend (a group of exactly four reads), on genome columns: for the
   pairs (163 -> 99) and (83 -> 147), LA copies the converted read's
   first column (base and quality) into its partner at that column; RD
   copies the partner's last column into the converted read. Where the
   two reads start (end) at the same column this is the upstream's
   prepend (append); where a molecular record lost an edge column to a
   co-call tie it is not (PERF.md, Open questions).
3. vote: duplex R1 over (99, 163), duplex R2 over (83, 147), each column
   by reference.vote.
4. per-strand tags (A: 99 / 147, B: 163 / 83): ac/bc, the strand's base
   where it observed one; ad/bd, the molecular record's per-base depth
   (cd) at that column — the read's nearest column where the column lies
   past the molecular record (a prepended or appended base); ae/be, its
   per-base errors (ce) likewise; aD/bD, aM/bM, aE/bE their largest,
   smallest and errors over depth. cd is ad + bd. ce counts, per strand
   where the duplex called a base, the strand's raw reads whose base —
   converted as in 1 — differs from the duplex call: all of them agree
   where the strand's own call agrees, less its ce; each dissenting raw
   base (the molecular record's cB) is checked on its own. Where the
   duplex called no base, ce is the strand's ce.
"""

from __future__ import annotations

import numpy as np

from reference.molecular import flag_of, seq_of, tlen_of
from reference.vote import NBASE, vote

A, C, G, T = 0, 1, 2, 3
PREPEND_QUAL = 40
ROWS = (99, 163, 83, 147)
CONVERT = (163, 83)
#: ASCII byte -> base code (anything but A C G T is N)
CODE_OF_CHAR = np.full(256, NBASE, np.int64)
CODE_OF_CHAR[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
#: per duplex role: (A-strand flag, B-strand flag)
ROLE_STRANDS = ((99, 163), (147, 83))


def convert_read(codes, quals, pos: int, genome: np.ndarray):
    """Step 1 on one read: (codes, quals, pos, la, rd)."""
    s = list(int(x) for x in codes)
    q = list(int(x) for x in quals)
    la = 1 if pos > 0 else 0
    if la:
        pos -= 1
        s = [int(genome[pos])] + s
        q = [PREPEND_QUAL] + q
    n = len(s)
    ref = [int(x) for x in genome[pos:pos + n + 1]]
    ref += [NBASE] * (n + 1 - len(ref))
    i = 0
    while i < n:
        if s[i] == A and ref[i] == G:
            s[i] = G
        elif s[i] == C:
            if ref[i] == C and ref[i + 1] == G:
                if i + 1 < n and s[i + 1] == A:
                    s[i], s[i + 1] = T, G
                    i += 1
            else:
                s[i] = T
        i += 1
    rd = 0
    if ref[n] == G and s and s[-1] == C:
        s.pop()
        q.pop()
        rd = 1
    return np.array(s, np.int64), np.array(q, np.int64), pos, la, rd


def convert_base(x: int, ref_here: int, ref_next: int, next_read: int) -> int:
    """What raw base x becomes on a B-strand read at a column (step 1's
    rule for one base)."""
    if x == A and ref_here == G:
        return G
    if x == C:
        if ref_here == C and ref_next == G:
            return T if next_read == A else C
        return T
    return x


def extend_columns(b: dict, q: dict, cov: dict, la_rd: dict) -> None:
    """Step 2 on one family's rows (flag -> bases, quals, cover over the
    family's genome columns), in place; la_rd: converted flag -> (la, rd)."""
    for left, right in ((163, 99), (83, 147)):
        la, rd = la_rd[left]
        if not (cov[left].any() and cov[right].any()):
            continue
        first_l = int(np.nonzero(cov[left])[0][0])
        last_r = int(np.nonzero(cov[right])[0][-1])
        for gate, src, dst, c in ((la, left, right, first_l), (rd, right, left, last_r)):
            if gate:
                b[dst][c], q[dst][c], cov[dst][c] = b[src][c], q[src][c], True


def duplex_family(mi: str, rx: str, ref_id: int, mol: dict, genome: np.ndarray,
                  params: dict, dtype) -> list[dict]:
    """mol: flag -> that strand's molecular record (decoded form);
    genome: the contig's codes."""
    raw = {}
    for f in ROWS:
        r = mol[f]
        codes = CODE_OF_CHAR[np.frombuffer(r["seq"].encode(), np.uint8)]
        raw[f] = (codes, np.frombuffer(r["qual"], np.uint8).astype(np.int64), r["pos"])
    reads = {}
    for f in ROWS:
        codes, quals, pos = raw[f]
        if f in CONVERT:
            reads[f] = list(convert_read(codes, quals, pos, genome))
        else:
            reads[f] = [codes, quals, pos, 0, 0]
    lo = min(r[2] for r in reads.values())
    hi = max(r[2] + len(r[0]) for r in reads.values())
    w = hi - lo
    b = {f: np.full(w, NBASE, np.int64) for f in ROWS}
    q = {f: np.zeros(w, np.int64) for f in ROWS}
    cov = {f: np.zeros(w, bool) for f in ROWS}
    for f, (codes, quals, pos, _la, _rd) in reads.items():
        b[f][pos - lo:pos - lo + len(codes)] = codes
        q[f][pos - lo:pos - lo + len(codes)] = quals
        cov[f][pos - lo:pos - lo + len(codes)] = True
    if len(mol) == 4:
        extend_columns(b, q, cov, {f: (reads[f][3], reads[f][4]) for f in CONVERT})
    for f in ROWS:
        b[f] = np.where(cov[f], b[f], NBASE)
    cols = np.arange(w)
    role_out = []
    for role, (fa, fb) in enumerate(ROLE_STRANDS):
        rows = (99, 163) if role == 0 else (83, 147)
        v = vote(np.stack([b[r] for r in rows]), np.stack([q[r] for r in rows]), params, dtype)
        cons = v["base"]
        per = {}
        for key, f in (("a", fa), ("b", fb)):
            pres = b[f] != NBASE
            m = mol[f]
            cd, ce = np.asarray(m["tags"]["cd"], np.int64), np.asarray(m["tags"]["ce"], np.int64)
            j = np.clip(lo + cols - m["pos"], 0, len(cd) - 1)
            d = np.where(pres, cd[j], 0)
            e = np.where(pres, ce[j], 0)
            err = e.copy()
            cb = np.asarray(m["tags"]["cB"], np.int64).reshape(4, len(cd))
            rc, _rq, rp = raw[f]
            for c in np.nonzero(pres & (cons != NBASE))[0]:
                agree = d[c] - e[c] if b[f][c] == cons[c] else 0
                jj = lo + c - rp
                if 0 <= jj < len(rc):
                    g = lo + c
                    for x in range(4):
                        if cb[x, jj]:
                            y = x
                            if f in CONVERT:
                                nxt = int(rc[jj + 1]) if jj + 1 < len(rc) else NBASE
                                y = convert_base(x, int(genome[g]), int(genome[g + 1])
                                                 if g + 1 < genome.size else NBASE, nxt)
                            if y == cons[c]:
                                agree += cb[x, jj]
                err[c] = max(d[c] - agree, 0)
            per[key] = {"call": np.where(pres, b[f], NBASE), "depth": d, "ss_err": e, "err": err}
        depth = per["a"]["depth"] + per["b"]["depth"]
        errors = per["a"]["err"] + per["b"]["err"]
        role_out.append((v, per, depth, errors))
    spans = []
    for v, per, depth, errors in role_out:
        cov = np.nonzero(depth > 0)[0]
        spans.append((int(cov[0]), int(cov[-1]) + 1) if cov.size else None)
    starts = [lo + s[0] if s else -1 for s in spans]
    ends = [lo + s[1] if s else -1 for s in spans]
    out = []
    for role, (v, per, depth, errors) in enumerate(role_out):
        if spans[role] is None:
            continue
        a, z = spans[role]
        d, e = depth[a:z], errors[a:z]
        tags = {"MI": mi, "RX": rx, "cD": int(d.max()), "cM": int(d.min()),
                "cE": np.float32(int(e.sum()) / int(d.sum()) if d.sum() else 0.0),
                "cd": d, "ce": e}
        for key in ("a", "b"):
            sd = per[key]["depth"][a:z]
            se = per[key]["ss_err"][a:z]
            tags[f"{key}D"] = int(sd.max())
            tags[f"{key}M"] = int(sd.min())
            tags[f"{key}E"] = np.float32(int(se.sum()) / int(sd.sum()) if sd.sum() else 0.0)
            tags[f"{key}d"] = sd
            tags[f"{key}e"] = se
            tags[f"{key}c"] = seq_of(per[key]["call"][a:z])
        other = 1 - role
        mate = starts[other] >= 0
        out.append({
            "qname": mi, "flag": flag_of(role, bool(role), mate, not bool(role)),
            "ref_id": ref_id, "pos": starts[role], "mapq": 60, "cigar": [(0, z - a)],
            "next_ref_id": ref_id if mate else -1, "next_pos": starts[other] if mate else -1,
            "tlen": tlen_of(starts, ends, role), "seq": seq_of(v["base"][a:z]),
            "qual": v["qual"][a:z].astype(np.uint8).tobytes(), "tags": tags,
        })
    return out
