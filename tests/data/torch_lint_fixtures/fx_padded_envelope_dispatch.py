"""graftlint fixture: padded-envelope-dispatch — one seeded violation.

`hot_` marks the batch-loop root. The seeded call hands the dense
[F, T, 2, W] envelope tensors to a sharded dispatcher even though the
batch's segment-packed plan is sitting right there — the route the
packed layout was built to kill. The clean twins dispatch the plan
itself (packed-aware callee), hand the envelope over where no plan
exists, or do it all off the hot path.
"""


def hot_dispatch_batch(batch, mesh, params):
    pk = batch.packed  # the segment-packed plan is available...
    if pk is None:
        return None
    return sharded_consensus(mesh, batch.bases, batch.quals, params)  # seeded: padded-envelope-dispatch


def hot_dispatch_batch_packed(batch, mesh, params):
    """Clean twin: the packed plan rides a packed-aware dispatcher."""
    pk = batch.packed
    return sharded_consensus_rows(mesh, pk.bases, pk.quals, pk.seg, params)


def hot_dispatch_legacy(batch, params):
    """Clean: no packed plan in scope — a stage that never built one may
    still ship the envelope (the padded layout's sanctioned route)."""
    return pack_wire_inputs(batch.bases, batch.quals, params)


def debug_replay_batch(batch, mesh, params):
    """Clean: same shape off the hot path — diagnostics may replay the
    envelope, the batch loop may not."""
    pk = batch.packed
    return sharded_consensus(mesh, batch.bases, batch.quals, params)
