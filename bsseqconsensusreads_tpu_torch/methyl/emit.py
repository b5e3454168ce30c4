"""Methylation output formats: bedMethyl and the CX cytosine report.

The port of the JAX package's methyl/emit.py, on the port's
ops.refstore.RefStore. Both render the merged global-offset tallies
(methyl.tally) back into contig coordinates through the store's offset
table. Sites arrive sorted by global offset, which is contig-major, so
the output is in (contig, pos) order without a sort. Both cover OBSERVED
sites only (coverage >= 1): unlike bismark's CX report, which lists every
genomic cytosine, the output scales with the data, not the genome (the
JAX package's scoping, PARITY.md).

bedMethyl (ENCODE-style 11 columns):
  chrom  start0  end  context  score(min(1000, cov))  strand
  thickStart  thickEnd  0,0,0  coverage  methyl% (integer floor)

CX report (bismark-style columns, covered sites only):
  chrom  pos1  strand  count_meth  count_unmeth  context  trinucleotide

The per-site Python loop is the cold finalize path, run once per run
after every batch; the batch loop ships dense planes.
"""

from __future__ import annotations

import numpy as np

from bsseqconsensusreads_tpu_torch.methyl.context import CTX_NAMES

_CODE_CHAR = "ACGTN"
_COMP_CHAR = "TGCAN"


def _site_coords(refstore, sites):
    """(contig index, local pos) arrays for sorted global offsets."""
    rid = (
        np.searchsorted(refstore.offsets, sites, side="right") - 1
        if sites.size
        else np.zeros(0, np.int64)
    )
    pos = sites - refstore.offsets[rid] if sites.size else sites
    return rid, pos


def _trinucleotide(refstore, rid: int, pos: int, minus: bool) -> str:
    """The reference trinucleotide 5'->3' on the site's own strand; N
    where the contig ends inside it."""
    length = int(refstore.lengths[rid])
    off = int(refstore.offsets[rid])
    out = []
    for k in range(3):
        p = pos - k if minus else pos + k
        if 0 <= p < length:
            code = int(refstore.codes[off + p])
            out.append(_COMP_CHAR[code] if minus else _CODE_CHAR[code])
        else:
            out.append("N")
    return "".join(out)


def write_bedmethyl(path: str, refstore, sites, ctx, meth, unmeth) -> None:
    rid, pos = _site_coords(refstore, sites)
    with open(path, "wb") as fh:
        for i in range(sites.size):
            name, strand = CTX_NAMES[int(ctx[i])]
            m, u = int(meth[i]), int(unmeth[i])
            cov = m + u
            p = int(pos[i])
            chrom = refstore.names[int(rid[i])]
            fh.write(
                (
                    f"{chrom}\t{p}\t{p + 1}\t{name}\t{min(1000, cov)}\t"
                    f"{strand}\t{p}\t{p + 1}\t0,0,0\t{cov}\t"
                    f"{(100 * m) // cov}\n"
                ).encode()
            )


def write_cx_report(path: str, refstore, sites, ctx, meth, unmeth) -> None:
    rid, pos = _site_coords(refstore, sites)
    with open(path, "wb") as fh:
        for i in range(sites.size):
            name, strand = CTX_NAMES[int(ctx[i])]
            r = int(rid[i])
            p = int(pos[i])
            tri = _trinucleotide(refstore, r, p, strand == "-")
            fh.write(
                (
                    f"{refstore.names[r]}\t{p + 1}\t{strand}\t"
                    f"{int(meth[i])}\t{int(unmeth[i])}\t{name}\t{tri}\n"
                ).encode()
            )
