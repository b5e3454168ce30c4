"""Duplex consensus: merge A- and B-strand single-strand consensi, on torch.

The port of the JAX package's models/duplex.py — the equivalent of
`fgbio CallDuplexConsensusReads` as the reference invokes it
(main.snake.py:163), with --min-reads=0 semantics.

After convert_ag_to_ct + extend_gap, a duplex family is a [4, W] window
tensor with rows (99, 163, 83, 147). The duplex R1 merges rows (99, 163);
the duplex R2 merges rows (83, 147). Each merge is the molecular vote at
depth <= 2. Rows 99/147 are A-strand, 163/83 B-strand; per-column
per-strand depths and error bits ride along for the aD/bD-style tags.

Because the merge rows are consecutive in the row order, the whole merge
of a batch is ONE seg_vote launch over the [F * 4, 1, W] row view with
2-row segments — for the packed and the padded layout alike (the JAX
package's two layouts add the same two rows in the same order).

Two device routes share that merge and its output wire (b0 + qual
planes, pack_duplex_outputs): the unpacked route
(duplex_call_pipeline_packed: the batch's tensors in) and the wire route
(duplex_call_wire_fused: one packed input wire whose reference windows
are gathered from the device-resident genome). Each has a methyl variant
(duplex_call_pipeline_packed_methyl, duplex_call_wire_fused_methyl) that
runs the methylation epilogue (methyl.context) on the same batch, on the
raw pre-conversion planes and the vote's base plane.
"""

from __future__ import annotations

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import NBASE
from bsseqconsensusreads_tpu_torch.models.molecular import narrow_outputs, regular_offsets
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote
from bsseqconsensusreads_tpu_torch.ops.convert import convert_ag_to_ct
from bsseqconsensusreads_tpu_torch.ops.extend import (
    ROW_83,
    ROW_99,
    ROW_147,
    ROW_163,
    extend_gap,
)
from bsseqconsensusreads_tpu_torch.ops.refstore import gather_windows, gather_windows_ext
from bsseqconsensusreads_tpu_torch.ops.wire import (
    split_duplex_wire,
    unpack_duplex_inputs,
    wire_section_sizes,
)

# (rows merged, A-strand row, B-strand row) for duplex R1 and R2.
R1_ROWS = (ROW_99, ROW_163)
R2_ROWS = (ROW_83, ROW_147)
A_ROWS = (ROW_99, ROW_147)
#: (a_row, b_row) per emitted role — shared by the host-side raw-depth
#: threading (pipeline.calling) and the qual tables (ops.reconstruct).
ROLE_STRAND_ROWS = tuple(
    (rr[0], rr[1]) if rr[0] in A_ROWS else (rr[1], rr[0])
    for rr in (R1_ROWS, R2_ROWS)
)
#: Flat row order of the merge: the two R1 rows then the two R2 rows —
#: the family tensor's own row order, so the 2-row segments are a view.
_PACKED_ROW_ORDER = R1_ROWS + R2_ROWS
assert _PACKED_ROW_ORDER == (0, 1, 2, 3)


def duplex_consensus_packed(bases, quals,
                            params: ConsensusParams = ConsensusParams(min_reads=0)):
    """Duplex merge: bases int8 [F, 4, W] (rows 99/163/83/147, NBASE where
    uncovered), quals integer [F, 4, W]. Returns dict of [F, 2, W] tensors:
    base, qual, depth, errors, a_depth, b_depth, a_err, b_err (narrowed).
    Roles: 0 = duplex R1, 1 = duplex R2."""
    f, r, w = bases.shape
    if r != 4:
        raise ValueError(f"duplex families have 4 rows, got {r}")
    quals = quals.to(torch.int16)
    offsets = torch.arange(0, 4 * f + 1, 2, dtype=torch.int32, device=bases.device)
    voted = cuda_vote.seg_vote(
        bases.contiguous().reshape(4 * f, 1, w),
        quals.contiguous().reshape(4 * f, 1, w), offsets, params,
        host_offsets=regular_offsets(2 * f, 2),
    )
    out = {k: v.reshape(f, 2, w) for k, v in voted.items()}
    # per-strand presence/error planes, elementwise over the original rows
    # with the vote's observation filter: a_depth + b_depth == depth and
    # a_err + b_err == errors
    for key, err, rows in (
        ("a_depth", "a_err", [rr[0] for rr in ROLE_STRAND_ROWS]),
        ("b_depth", "b_err", [rr[1] for rr in ROLE_STRAND_ROWS]),
    ):
        rb = bases[:, rows, :]  # [F, 2(role), W]
        rq = quals[:, rows, :]
        obs = (rb != NBASE) & (rq >= params.min_input_base_quality)
        out[key] = obs.to(torch.int32)
        out[err] = (obs & (out["base"] != NBASE) & (rb != out["base"])).to(torch.int32)
    return narrow_outputs(out)


def duplex_consensus(bases, quals,
                     params: ConsensusParams = ConsensusParams(min_reads=0)):
    """The padded-layout duplex merge. In the port it is the same launch as
    duplex_consensus_packed (see the module note)."""
    return duplex_consensus_packed(bases, quals, params)


def duplex_call_pipeline(
    bases, quals, cover, ref, convert_mask, extend_eligible=None,
    params: ConsensusParams = ConsensusParams(min_reads=0),
):
    """The fused duplex stage on the device: AG->CT conversion -> gap
    extension -> duplex merge (the JAX package's layout='packed' and
    'padded' are the same launch here).

    Inputs are DuplexBatch planes as tensors on one device (quals integer,
    widened to int16 here on both routes); returns the duplex_consensus
    output dict plus 'la'/'rd' int8 [F, 4]."""
    b, q, c, la, rd = convert_ag_to_ct(
        bases, quals.to(torch.int16), cover, ref, convert_mask
    )
    b, q, c = extend_gap(b, q, c, la, rd, extend_eligible)
    b = torch.where(c, b, NBASE)
    out = duplex_consensus_packed(b, q, params)
    out["la"] = la
    out["rd"] = rd
    return out


def _duplex_b0(out: dict):
    """The duplex per-column byte: base(3b) | a_depth<<3 | b_depth<<4 |
    a_err<<5 | b_err<<6 (bit 7 spare)."""
    u8 = torch.uint8
    return (
        out["base"].to(u8)
        | (out["a_depth"].to(u8) << 3)
        | (out["b_depth"].to(u8) << 4)
        | (out["a_err"].to(u8) << 5)
        | (out["b_err"].to(u8) << 6)
    )


def _decode_b0(b0):
    a_depth = ((b0 >> 3) & 0x1).astype(np.int8)
    b_depth = ((b0 >> 4) & 0x1).astype(np.int8)
    a_err = ((b0 >> 5) & 0x1).astype(np.int8)
    b_err = ((b0 >> 6) & 0x1).astype(np.int8)
    return {
        "base": (b0 & 0x7).astype(np.int8),
        "depth": (a_depth + b_depth).astype(np.int16),
        "errors": (a_err + b_err).astype(np.int16),
        "a_depth": a_depth,
        "b_depth": b_depth,
        "a_err": a_err,
        "b_err": b_err,
    }


def pack_duplex_outputs(out: dict):
    """Pack the per-column duplex outputs into one planar byte wire: per
    family [4, W] u8 rows — 0-1 the b0 bytes of R1/R2 (_duplex_b0), 2-3 the
    qual of R1/R2. Byte-identical to the JAX package's u32 wire read as
    bytes; one device->host copy. Unpack with unpack_duplex_outputs."""
    return torch.cat([_duplex_b0(out), out["qual"].to(torch.uint8)], dim=-2).reshape(-1)


def unpack_duplex_outputs(packed, f: int, w: int) -> dict:
    """numpy inverse of pack_duplex_outputs -> dict of [f, 2, w] arrays."""
    packed = np.asarray(packed)
    u8 = packed.view(np.uint8) if packed.dtype != np.uint8 else packed
    planes = u8[: f * 4 * w].reshape(f, 4, w)
    out = _decode_b0(planes[:, :2, :])
    out["qual"] = planes[:, 2:, :]
    return out


def duplex_call_pipeline_packed(
    bases, quals, cover, ref, convert_mask, extend_eligible,
    params: ConsensusParams = ConsensusParams(min_reads=0),
):
    """duplex_call_pipeline with per-column outputs packed for one fetch:
    returns (packed uint8 [F*4*W] wire, la int8 [F, 4], rd int8 [F, 4])."""
    out = duplex_call_pipeline(
        bases, quals, cover, ref, convert_mask, extend_eligible, params=params,
    )
    return pack_duplex_outputs(out), out["la"], out["rd"]


def duplex_call_wire_fused(
    words, genome, f: int, w: int,
    params: ConsensusParams = ConsensusParams(min_reads=0),
    qual_mode: str = "q8",
    r: int = 4,
) -> torch.Tensor:
    """The wire duplex stage on the device, ONE input wire
    (DuplexWire.to_words() as its bytes on the device): the five sections
    (starts, limits, meta, nib, qual) are split at static offsets and
    unpacked there (ops.wire), the [f, w+1] reference windows gathered
    from the device-resident genome (ops.refstore), and
    duplex_call_pipeline runs on them. Returns pack_duplex_outputs' bytes,
    the unpacked route's output wire (unpack_duplex_outputs)."""
    if r != 4:
        raise ValueError(f"duplex windows have 4 rows (flags 99/163/83/147); got r={r}")
    nib, qual, meta, starts, limits = split_duplex_wire(words, f, w, r=r, qual_mode=qual_mode)
    bases, quals, cover, convert_mask, eligible = unpack_duplex_inputs(
        nib, qual, meta, f, w, qual_mode=qual_mode
    )
    ref = gather_windows(genome, starts, limits, w + 1)
    return pack_duplex_outputs(duplex_call_pipeline(
        bases, quals, cover, ref, convert_mask, eligible, params=params,
    ))


# ---- methylation epilogue variants (methyl/context.py) -------------------
#
# Each mirrors its plain counterpart with the methylation epilogue run on
# the same batch: it reads the RAW pre-conversion planes (ops.convert
# erases the bottom-strand signal) and the vote's base plane, and adds two
# u8 planes per family to the output.


def duplex_call_pipeline_packed_methyl(
    bases, quals, cover, ref, convert_mask, extend_eligible, ref_ext,
    params: ConsensusParams = ConsensusParams(min_reads=0),
):
    """duplex_call_pipeline_packed + the methyl epilogue.

    ref_ext int8 [F, W + 4]: the bounded extension windows (gathered on
    the host on this route: ops.refstore.RefStore.host_windows_ext).
    Returns (packed, la, rd, planes u8 [F, 2, W])."""
    from bsseqconsensusreads_tpu_torch.methyl.context import methyl_epilogue

    out = duplex_call_pipeline(
        bases, quals, cover, ref, convert_mask, extend_eligible, params=params,
    )
    planes = methyl_epilogue(
        bases, quals, cover, convert_mask, out["base"], ref_ext,
        params.min_input_base_quality,
    )
    return pack_duplex_outputs(out), out["la"], out["rd"], planes


def duplex_call_wire_fused_methyl(
    words, genome, f: int, w: int,
    params: ConsensusParams = ConsensusParams(min_reads=0),
    qual_mode: str = "q8",
    r: int = 4,
) -> torch.Tensor:
    """duplex_call_wire_fused + the methyl epilogue, one wire each way.

    Input wire (its bytes on the device) = DuplexWire.to_words() ++ los
    u32 [f], each family's contig origin (gather_windows_ext's lower
    bound), appended at the END so the five-section prefix parses as it
    is. Output = pack_duplex_outputs' full planes (f * 4 * w bytes) ++ the
    methyl planes' bytes (methyl_wire_words, f * 2 * w bytes): the host
    unpacks the prefix with unpack_duplex_outputs and peels the planes off
    the tail (methyl.context.unpack_methyl_planes)."""
    from bsseqconsensusreads_tpu_torch.methyl.context import (
        methyl_epilogue,
        methyl_wire_words,
    )

    if r != 4:
        raise ValueError(f"duplex windows have 4 rows (flags 99/163/83/147); got r={r}")
    base_bytes = 4 * sum(wire_section_sizes(f, w, r, qual_mode))
    nib, qual, meta, starts, limits = split_duplex_wire(words, f, w, r=r, qual_mode=qual_mode)
    los = words[base_bytes: base_bytes + 4 * f]
    bases, quals, cover, convert_mask, eligible = unpack_duplex_inputs(
        nib, qual, meta, f, w, qual_mode=qual_mode
    )
    ref = gather_windows(genome, starts, limits, w + 1)
    ref_ext = gather_windows_ext(genome, starts, los, limits, w + 4)
    out = duplex_call_pipeline(
        bases, quals, cover, ref, convert_mask, eligible, params=params,
    )
    planes = methyl_epilogue(
        bases, quals, cover, convert_mask, out["base"], ref_ext,
        params.min_input_base_quality,
    )
    return torch.cat([pack_duplex_outputs(out), methyl_wire_words(planes).view(torch.uint8)])
