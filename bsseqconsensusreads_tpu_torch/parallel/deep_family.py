"""Deep-family consensus: the template axis split across a mesh.

The port of the JAX package's parallel/deep_family.py. One deep family's
[T, 2, W] tensor can hold one device while the rest idle; here the
template axis is split over the mesh's 'reads' axis (and the family axis
over 'data'). The vote decomposes exactly: log-likelihoods, per-base
counts and depth are sums over reads. So each reads shard computes its
partial planes — on the card seg_vote's partials mode
(ops.cuda_vote.seg_vote_partials), on the CPU its plain twin — the
partials are brought to the data row's first slot and ADDED IN RANK ORDER
(((p0 + p1) + p2) + ...: the JAX package's psum), and vote_finalize
(the kernel on the card) and the count trick (errors_from_counts) run on
the sums.

The float sums of a split add the same terms in another order than one
device does, so a qual may differ by one from the single-device route
(the JAX package documents and tests the same relaxation); base, depth
and errors are equal.
"""

from __future__ import annotations

import torch

from bsseqconsensusreads_tpu_torch.models.molecular import (
    errors_from_counts,
    narrow_outputs,
    overlap_cocall,
    regular_offsets,
)
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote
from bsseqconsensusreads_tpu_torch.parallel.mesh import Mesh
from bsseqconsensusreads_tpu_torch.parallel.sharding import ShardOutputs, place


def _partials(bases, quals, params: ConsensusParams):
    """One reads shard's partial planes: the co-call (within a template:
    local to the shard), then the segmented sums over the shard's
    [F, T_local] rows, one segment per family."""
    f, t, _, w = bases.shape
    quals = quals.to(torch.int16)
    if params.consensus_call_overlapping_bases:
        bases, quals = overlap_cocall(bases, quals)
    offsets = torch.arange(0, f * t + 1, t, dtype=torch.int32, device=bases.device)
    return cuda_vote.seg_vote_partials(
        bases.reshape(f * t, 2, w).contiguous(), quals.reshape(f * t, 2, w).contiguous(),
        offsets, params, host_offsets=regular_offsets(f, t),
    )


def _bring(part, event, device: torch.device):
    """A shard's partial planes readable on `device`'s current stream:
    that stream waits for the shard's event, then the planes copy over
    (or, on the same device, are only marked as read there)."""
    cur = torch.cuda.current_stream(device) if device.type == "cuda" else None
    if cur is not None and event is not None:
        cur.wait_event(event)
    out = []
    for t in part:
        if cur is not None and t.device.type == "cuda":
            t.record_stream(cur)
        out.append(t.to(device))
    return out


class DeepFamilyFn:
    """The deep route over a (data, reads) mesh: call it with bases int8 /
    quals integer [F, T, 2, W] (F divisible by the data size, T by the
    reads size); returns the molecular output dict of [F, 2, W] planes
    (base, qual, depth int16, errors int16) on the mesh's first device."""

    def __init__(self, mesh: Mesh, params: ConsensusParams):
        self.mesh = mesh
        self.params = params

    def __call__(self, bases, quals) -> dict:
        mesh, params = self.mesh, self.params
        data = mesh.local_data()
        n_reads = mesh.shape["reads"]
        f, t = bases.shape[:2]
        if f % len(data) or t % n_reads:
            raise ValueError(
                f"[{f}, {t}] families x templates do not split over "
                f"{len(data)} x {n_reads} shards; pad first"
            )
        fs, ts = f // len(data), t // n_reads
        rows = []
        for k, d in enumerate(data):
            parts = []
            for r in range(n_reads):
                dev = mesh.device(d, r)
                sl = (slice(k * fs, (k + 1) * fs), slice(r * ts, (r + 1) * ts))
                with mesh.on(d, r) as stream:
                    part = _partials(place(bases[sl], dev), place(quals[sl], dev), params)
                    event = None
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                parts.append((part, event))
            dev0 = mesh.device(d, 0)
            with mesh.on(d, 0) as stream:
                ll, cnt, depth = _bring(*parts[0], dev0)
                for part, event in parts[1:]:  # rank order: ((p0 + p1) + p2) + ...
                    pll, pcnt, pdepth = _bring(part, event, dev0)
                    ll, cnt, depth = ll + pll, cnt + pcnt, depth + pdepth
                base, qual = cuda_vote.vote_finalize(ll, depth, params)
                out = narrow_outputs({
                    "base": base, "qual": qual, "depth": depth,
                    "errors": errors_from_counts(cnt, depth, base),
                })
            rows.append((out, stream, dev0))
        return ShardOutputs(rows).gather(mesh.first_device)


def deep_family_consensus(mesh: Mesh, params: ConsensusParams = ConsensusParams()):
    """Molecular consensus with families over 'data' AND templates over
    'reads' (DeepFamilyFn): each reads shard votes its [F, T_local]
    template slab as segment-packed rows (one seg_vote partials launch),
    the partials are added in rank order and finalized (one vote_finalize
    launch per data shard), the errors from the summed counts. The JAX
    package has two entry points, deep_family_consensus (its padded route
    votes each family's templates in a vmap) and
    deep_family_consensus_rows; here both layouts vote the envelope's rows
    (template-pad rows carry no observation and add exact zeros), so one
    entry point serves both."""
    return DeepFamilyFn(mesh, params)
