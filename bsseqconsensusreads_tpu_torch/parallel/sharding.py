"""The family axis across the mesh's data axis.

The port of the JAX package's parallel/sharding.py (its shard_map
wrappers). Families are independent — no operator couples them — so these
routes hold no collective: each data shard takes an equal, contiguous
share of the batch's families, runs the stock single-device route on its
own device and stream (Mesh.on: seg_vote on the card, the plain version
on the CPU), and the shard outputs concatenated family-major are the
single-device output, byte for byte.

Each factory returns a ShardedFn: calling it gathers the outputs onto the
mesh's first device (the JAX package returns a global array);
ShardedFn.launch returns the per-shard outputs (ShardOutputs), which the
batch callers fetch to the host shard by shard. On a multi-process mesh
(parallel.multihost) the leading axis is this process's rows, split over
its own data shards.
"""

from __future__ import annotations

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.models.duplex import (
    duplex_call_pipeline,
    duplex_call_pipeline_packed,
    duplex_call_pipeline_packed_methyl,
)
from bsseqconsensusreads_tpu_torch.models.molecular import (
    molecular_consensus,
    molecular_consensus_packed,
    pack_molecular_outputs,
)
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.parallel.mesh import Mesh


class HostArray:
    """A host array that ShardedFn slices by family like the others and
    hands to the shard's function as it is, never uploaded (the host
    offsets of seg_vote's deep plan)."""

    def __init__(self, array: np.ndarray):
        self.array = array

    def __getitem__(self, index) -> "HostArray":
        return HostArray(self.array[index])

    @property
    def shape(self) -> tuple:
        return self.array.shape


def place(a, device: torch.device):
    """A numpy array or tensor on `device` (on the current stream); a
    HostArray stays on the host, as its numpy array."""
    if isinstance(a, HostArray):
        return a.array
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _map(fn, out):
    """fn over the tensors of one shard output (a tensor, tuple or dict)."""
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(fn(v) for v in out)
    return fn(out)


def _cat(parts: list, cat):
    """Concatenate shard outputs of one structure along the family axis."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: cat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return tuple(cat([p[i] for p in parts]) for i in range(len(first)))
    return cat(parts)


class ShardOutputs:
    """The outputs of one sharded launch, in family order: one entry per
    data shard — (output, its stream, its device) — and an event recorded
    on each stream after the shard's last launch (none on the CPU)."""

    def __init__(self, parts: list):
        self.parts = parts
        self.events = []
        for _out, stream, _dev in parts:
            ev = None
            if stream is not None:
                ev = torch.cuda.Event()
                ev.record(stream)
            self.events.append(ev)

    def synchronize(self) -> None:
        """Wait until every shard's work is done (the batch callers' device_wait)."""
        for ev in self.events:
            if ev is not None:
                # graftlint: disable=host-sync -- called only from _Inflight.fetch under
                # its device_wait span
                ev.synchronize()

    def host(self):
        """Every shard's output copied to the host (each copy on its own
        stream, after its launches), concatenated family-major."""
        parts = []
        for out, stream, _dev in self.parts:
            if stream is None:
                parts.append(_map(lambda t: t.numpy(), out))
                continue
            with torch.cuda.stream(stream):
                parts.append(_map(lambda t: t.cpu().numpy(), out))
        return _cat(parts, np.concatenate)

    def gather(self, device: torch.device):
        """The outputs concatenated family-major on `device`: the
        current stream there waits for each shard's event first."""
        parts = []
        cur = torch.cuda.current_stream(device) if device.type == "cuda" else None
        for (out, stream, _dev), ev in zip(self.parts, self.events):
            if cur is not None and ev is not None:
                cur.wait_event(ev)

            def bring(t):
                if cur is not None and t.device.type == "cuda":
                    t.record_stream(cur)  # read on `cur` after this shard freed it
                return t.to(device)

            parts.append(_map(bring, out))
        return _cat(parts, torch.cat)


def family_sharding(mesh: Mesh):
    """How [F, ...] batch arrays split over the mesh's data axis (the JAX
    package's NamedSharding(mesh, P('data'))): a function of F giving
    (d, first row, end row) for each of this process's data shards, equal
    contiguous shares; F must split evenly (pad first)."""
    slots = mesh.local_data()

    def split(n: int) -> list[tuple[int, int, int]]:
        if n % len(slots):
            raise ValueError(
                f"{n} families do not split evenly over {len(slots)} data shards; "
                "pad first (parallel.mesh.pad_families)"
            )
        per = n // len(slots)
        return [(d, k * per, (k + 1) * per) for k, d in enumerate(slots)]

    return split


class ShardedFn:
    """`fn` over the family axis of a mesh: launch(*arrays) runs
    fn(*shard_arrays) on each data shard (reads slot 0) and returns
    ShardOutputs; calling it gathers them onto the mesh's first device."""

    def __init__(self, mesh: Mesh, fn):
        self.mesh = mesh
        self.fn = fn

    def launch(self, *arrays) -> ShardOutputs:
        parts = []
        for d, lo, hi in family_sharding(self.mesh)(arrays[0].shape[0]):
            dev = self.mesh.device(d)
            with self.mesh.on(d) as stream:
                parts.append((self.fn(*(place(a[lo:hi], dev) for a in arrays)), stream, dev))
        return ShardOutputs(parts)

    def __call__(self, *arrays):
        return self.launch(*arrays).gather(self.mesh.first_device)


def sharded_molecular_consensus(mesh: Mesh, params: ConsensusParams = ConsensusParams()):
    """molecular_consensus over the family axis: (bases, quals) [F, T, 2, W]
    with F divisible by the data size (parallel.mesh.pad_families) -> the
    output dict of [F, 2, W] planes."""
    return ShardedFn(mesh, lambda b, q: molecular_consensus(b, q, params))


def sharded_molecular_outwire(mesh: Mesh, params: ConsensusParams = ConsensusParams()):
    """sharded_molecular_consensus with the packed planar output wire
    (models.molecular.pack_molecular_outputs) per shard: the family-major
    layout makes the concatenation identical to a single-device pack."""
    return ShardedFn(mesh, lambda b, q: pack_molecular_outputs(molecular_consensus(b, q, params)))


def sharded_molecular_rows(mesh: Mesh, fams_per_shard: int,
                           params: ConsensusParams = ConsensusParams()):
    """Segment-packed molecular consensus over a family-sharded row plan
    (ops.encode.shard_packed_rows): bases int8 [S, R, 2, W], quals [S, R,
    2, W], seg int32 [S, R] of LOCAL family ids, S = the data size. Every
    shard owns whole families, so each runs the single-device segment vote
    (one seg_vote launch) on its slice, bit-identical to the unsharded
    pack. Returns the 12-plane output wire [S * fams_per_shard * 12 * W]
    family-major — what unpack_molecular_outputs reads. On the card a
    fourth array gives each shard's host offsets: a HostArray of [S,
    fams_per_shard + 1] (models.molecular.host_segment_offsets of the
    shard's seg)."""
    return ShardedFn(mesh, lambda b, q, s, h=None: pack_molecular_outputs(
        molecular_consensus_packed(b[0], q[0], s[0], fams_per_shard, params,
                                   host_offsets=None if h is None else h[0])))


def sharded_duplex_outwire(mesh: Mesh, params: ConsensusParams = ConsensusParams(min_reads=0)):
    """duplex_call_pipeline_packed (the fused duplex stage with packed
    outputs) over the family axis — what pipeline.calling.call_duplex_batches
    dispatches on a mesh. Takes the DuplexBatch planes (bases, quals,
    cover, ref, convert_mask, extend_eligible) and returns (packed, la,
    rd), each concatenated family-major."""
    return ShardedFn(mesh, lambda *a: duplex_call_pipeline_packed(*a, params=params))


def sharded_duplex_outwire_methyl(mesh: Mesh,
                                  params: ConsensusParams = ConsensusParams(min_reads=0)):
    """sharded_duplex_outwire with the methyl epilogue on each shard's
    device (duplex_call_pipeline_packed_methyl): takes the six DuplexBatch
    planes and the [F, W+4] extension windows and returns (packed, planes
    u8 [F, 2, W]), each concatenated family-major. The JAX package's mesh
    route leaves the epilogue to its host twin at the retire; the planes
    are the same bits."""
    def shard(*arrays):
        packed, _la, _rd, planes = duplex_call_pipeline_packed_methyl(*arrays, params=params)
        return packed, planes

    return ShardedFn(mesh, shard)


def sharded_duplex_pipeline(mesh: Mesh, params: ConsensusParams = ConsensusParams(min_reads=0)):
    """The fused convert + extend + duplex stage over the family axis: the
    duplex_call_pipeline output dict, concatenated family-major."""
    return ShardedFn(mesh, lambda *a: duplex_call_pipeline(*a, params=params))

