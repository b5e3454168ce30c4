"""graftlint fixture: padded-batch-flops — one seeded violation.

`hot_` marks the batch-loop root. The seeded allocation densifies three
ragged dims (families x templates x window) to their batch maxima — the
[F, T, 2, W] envelope whose FLOPs scale with the worst family. The
packed twin below builds one dense row axis + segment ids (two ragged
dims at most per allocation) and must stay clean, as must the same
envelope in a non-hot report helper.
"""

import numpy as np


def hot_encode_batch(families, t_max, w_max):
    f = len(families)
    bases = np.full((f, t_max, 2, w_max), 5, np.int8)  # seeded: padded-batch-flops
    for fi, fam in enumerate(families):
        for ti, (codes, off) in enumerate(fam):
            bases[fi, ti, 0, off : off + len(codes)] = codes
    return bases


def hot_encode_batch_packed(families, w_max):
    """Clean twin: reads concatenate on one dense row axis; only the
    row bucket pads, and the window dim is shared — two ragged dims."""
    n_rows = sum(len(fam) for fam in families)
    rows = np.full((n_rows, 2, w_max), 5, np.int8)
    seg = np.repeat(
        np.arange(len(families), dtype=np.int32),
        [len(fam) for fam in families],
    )
    return rows, seg


def debug_envelope_report(families, t_max, w_max):
    """Same envelope shape off the hot path: a diagnostics helper may
    materialize it, the batch loop may not."""
    f = len(families)
    return np.zeros((f, t_max, 2, w_max), np.uint8)
