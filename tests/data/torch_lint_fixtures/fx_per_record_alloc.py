"""graftlint fixture: per-record-alloc — one seeded violation.

`hot_` marks the function as a batch-loop root; 'emit' in its name makes
it an emit/sort root. The `.tolist()` inside the per-record loop is the
seeded per-record allocation (the r05 emit-wall shape). The columnar
twin below is the sanctioned batch-level shape and must stay clean.
"""


def hot_emit_batch(batch, depths):
    out = []
    for fi in range(len(batch)):
        cd = depths[fi].tolist()  # seeded: per-record-alloc
        out.append((fi, cd))
    return out


def hot_emit_batch_columnar(batch, depths):
    """Clean twin: tag arrays stay numpy, scalars precompute at batch
    level — what io.bam._encode_tags and _span_stats make possible."""
    totals = depths.sum(axis=-1)
    out = []
    for fi in range(len(batch)):
        out.append((fi, depths[fi], int(totals[fi])))
    return out
