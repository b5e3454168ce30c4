"""The general traffic generator: one pass's grouped duplex BAM, made
from a configuration (read layout, chemistry, error model, where reads
fall) and a traffic mix (families per pass, templates per strand), both
plain data, and the seed.

Every seed gets the same multiset of family sizes (drawn by stratified
inverse CDF from the mix's distribution, then shuffled by the seed), so
seeds change where families fall and what they read, never how much
work a pass holds.

Records follow the upstream's `GroupReadsByUmi -s Paired` output on a
paired bisulfite library: per family two strands (MI `<id>/A`, `<id>/B`),
per template a read pair — A: flag 99 at the fragment start and 147 at
its end; B: 163 at the start and 83 at the end — all `<read_len>M`,
coordinate-sorted.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from harness import bamio

A, C, G, T = 0, 1, 2, 3
#: (flag, strand, offset in fragment: 0 = start, 1 = end)
READS = ((99, 0, 0), (147, 0, 1), (163, 1, 0), (83, 1, 1))
NAME_DIGITS, TI_DIGITS = 8, 4


def template_counts(dist: dict, n: int) -> np.ndarray:
    """n template counts whose histogram follows `dist` (stratified
    inverse CDF; the same multiset for every seed). Kinds: zt_poisson
    (mean, max: a zero-truncated Poisson renormalised over 1..max),
    uniform (lo, hi inclusive), choice (values, weights)."""
    kind = dist["kind"]
    if kind == "zt_poisson":
        k = np.arange(1, int(dist["max"]) + 1)
        lam = float(dist["mean"])
        logp = k * np.log(lam) - lam - np.cumsum(np.log(k))
        values, p = k, np.exp(logp)
    elif kind == "uniform":
        values = np.arange(int(dist["lo"]), int(dist["hi"]) + 1)
        p = np.ones(values.size)
    elif kind == "choice":
        values = np.asarray(dist["values"], np.int64)
        p = np.asarray(dist["weights"], np.float64)
    else:
        raise ValueError(f"unknown template distribution {kind!r}")
    cdf = np.cumsum(p / p.sum())
    u = (np.arange(n) + 0.5) / n
    return values[np.minimum(np.searchsorted(cdf, u), values.size - 1)].astype(np.int64)


@dataclasses.dataclass
class Pass:
    """One pass's input: the BAM's path and what the reference needs."""

    path: str
    families: int
    reads: int
    templates: np.ndarray  # int64 [F, 2]: templates of strand A, B
    ref_id: np.ndarray  # int64 [F]
    start: np.ndarray  # int64 [F], contig coordinate of the fragment start
    rx: list  # str [F]
    #: reads of the sampled families: fam -> list of (flag, ti, pos, codes, quals)
    sample_reads: dict
    header: bytes


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((values[:, None] // p) % 10 + 48).astype(np.uint8)


def family_positions(cfg: dict, genome, n: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """(ref_id, start) of n fragments, sorted: anywhere on the genome
    ('genome'), or within the configuration's targets ('targets')."""
    frag = int(cfg["fragment_len"])
    lengths = genome.lengths
    usable = np.maximum(lengths - frag - 20, 0)
    place = cfg["placement"]
    if place["kind"] == "genome":
        rid = rng.choice(lengths.size, size=n, p=usable / usable.sum())
        start = 10 + (rng.random(n) * usable[rid]).astype(np.int64)
    elif place["kind"] == "targets":
        nt, width = int(place["targets"]), int(place["target_width"])
        trid = rng.choice(lengths.size, size=nt, p=usable / usable.sum())
        tstart = 10 + frag + (rng.random(nt) * np.maximum(usable[trid] - width - 2 * frag, 1)
                              ).astype(np.int64)
        pick = rng.integers(0, nt, size=n)
        rid = trid[pick]
        start = tstart[pick] + rng.integers(-(frag // 2), width - frag // 2, size=n)
    else:
        raise ValueError(f"unknown placement {place['kind']!r}")
    order = np.lexsort((start, rid))
    return rid[order].astype(np.int64), start[order].astype(np.int64)


def converted_fragments(cfg: dict, genome, rid, start, rng) -> np.ndarray:
    """int8 [F, 2, frag]: each family's fragment as strand A and strand B
    read it on the top strand after conversion. Unmethylated C -> T on
    A; the bottom strand's unmethylated C reads as G -> A on B. Each CpG
    of each molecule is methylated with the configuration's probability,
    the same on both strands."""
    frag = int(cfg["fragment_len"])
    glob = genome.offsets[rid] + start
    idx = glob[:, None] - 1 + np.arange(frag + 2)
    win = genome.codes[idx]  # one base either side
    core = win[:, 1:-1]
    meth = rng.random(win.shape) < float(cfg["cpg_methylation"])
    cpg_c = (win[:, :-1] == C) & (win[:, 1:] == G)  # C at j, G at j + 1
    keep_c = cpg_c[:, 1:] & meth[:, 1:-1]  # core C whose next base is G, methylated
    keep_g = cpg_c[:, :-1] & meth[:, :-2]  # core G whose previous base is a methylated C
    a = np.where((core == C) & ~keep_c, T, core)
    b = np.where((core == G) & ~keep_g, A, core)
    return np.stack([a, b], axis=1).astype(np.int8)


def make_pass(cfg: dict, mix: dict, genome, seed: int, path: str, sample: int = 0,
              threads: int = 4) -> Pass:
    """Write one pass's grouped BAM to `path`; keep the reads of `sample`
    families drawn from the seed (with the deepest family among them)."""
    rng = np.random.default_rng([seed, 0x5EED])
    n = int(mix["families_per_pass"])
    L, frag = int(cfg["read_len"]), int(cfg["fragment_len"])
    tdist = mix["templates"]
    if mix.get("per", "strand") == "strand":
        counts = template_counts(tdist, 2 * n)
        templates = rng.permutation(counts).reshape(n, 2)
    else:
        counts = rng.permutation(template_counts(tdist, n))
        templates = np.stack([counts, counts], axis=1)
    rid, start = family_positions(cfg, genome, n, rng)
    conv = converted_fragments(cfg, genome, rid, start, rng)
    umis = rng.integers(0, 4, size=(n, 16))
    rx_bytes = np.concatenate([np.frombuffer(b"ACGT", np.uint8)[umis[:, :8]],
                               np.full((n, 1), ord("-"), np.uint8),
                               np.frombuffer(b"ACGT", np.uint8)[umis[:, 8:]]], axis=1)
    rx = [bytes(r).decode() for r in rx_bytes]

    # one row per read: family, strand, template index, read kind
    fam_s = np.repeat(np.arange(n), 2)
    strand_s = np.tile([0, 1], n)
    t_s = templates.reshape(-1)
    fam_t = np.repeat(fam_s, t_s)
    strand_t = np.repeat(strand_s, t_s)
    first = np.cumsum(t_s) - t_s
    ti_t = np.arange(t_s.sum()) - np.repeat(first, t_s)
    n_t = fam_t.size
    fam = np.repeat(fam_t, 2)
    strand = np.repeat(strand_t, 2)
    ti = np.repeat(ti_t, 2)
    end_read = np.tile([0, 1], n_t)  # 0: at the fragment start, 1: at its end
    flag = np.where(strand == 0, np.where(end_read == 0, 99, 147),
                    np.where(end_read == 0, 163, 83)).astype(np.int64)
    r2 = frag - L
    pos = start[fam] + end_read * r2
    mate = start[fam] + (1 - end_read) * r2
    tlen = np.where(end_read == 0, frag, -frag)
    order = np.lexsort((flag, ti, strand, fam, pos, rid[fam]))
    fam, strand, ti, end_read, flag = fam[order], strand[order], ti[order], end_read[order], flag[order]
    pos, mate, tlen = pos[order], mate[order], tlen[order]
    nreads = fam.size

    bins = np.asarray(cfg["qual_bins"], np.uint8)
    qp = np.asarray(cfg["qual_weights"], np.float64)
    qcdf = np.cumsum(qp / qp.sum())
    sub = float(cfg["substitution_rate"])
    names = np.concatenate([_digits(fam, NAME_DIGITS),
                            np.where(strand == 0, ord("A"), ord("B")).astype(np.uint8)[:, None],
                            _digits(ti, TI_DIGITS)], axis=1)
    mi = np.concatenate([_digits(fam, NAME_DIGITS), np.full((nreads, 1), ord("/"), np.uint8),
                         np.where(strand == 0, ord("A"), ord("B")).astype(np.uint8)[:, None]],
                        axis=1)
    head_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{int(ln)}\n" for nm, ln in zip(genome.names, genome.lengths))
    header = bamio.header_bytes(head_text, list(zip(genome.names, genome.lengths.tolist())))

    pick = set()
    if sample:
        deepest = int(np.argmax(templates.sum(axis=1)))
        pick = set(rng.choice(n, size=min(sample, n), replace=False).tolist()) | {deepest}
    sample_reads: dict = {f: [] for f in sorted(pick)}
    chunks = []
    step = 1 << 16
    cols = np.arange(L)
    for lo in range(0, nreads, step):
        hi = min(lo + step, nreads)
        k = hi - lo
        f, s, e = fam[lo:hi], strand[lo:hi], end_read[lo:hi]
        codes = conv[f[:, None], s[:, None], e[:, None] * r2 + cols]
        err = rng.random((k, L), np.float32) < sub
        shift = rng.integers(1, 4, size=(k, L), dtype=np.int8)
        codes = np.where(err, (codes + shift) % 4, codes).astype(np.int8)
        quals = bins[np.searchsorted(qcdf, rng.random((k, L), np.float32))]
        chunks.append(bamio.build_records(
            names=names[lo:hi], flag=flag[lo:hi], ref_id=rid[f], pos=pos[lo:hi],
            mate_ref=rid[f], mate_pos=mate[lo:hi], tlen=tlen[lo:hi], codes=codes,
            quals=quals, tags=[("RX", rx_bytes[f]), ("MI", mi[lo:hi])]))
        if pick:
            for j in np.nonzero(np.isin(f, list(pick)))[0]:
                sample_reads[int(f[j])].append(
                    (int(flag[lo + j]), int(ti[lo + j]), int(pos[lo + j]), codes[j].copy(),
                     quals[j].copy()))
    bamio.write_bam(path, header, np.concatenate(chunks), level=1, threads=threads)
    return Pass(path, n, nreads, templates, rid, start, rx, sample_reads, header)
