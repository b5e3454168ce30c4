"""Packed wire formats for the host <-> device hop.

The port of the JAX package's ops/wire.py (its single-device part). Every
hot-path batch crosses to the device as ONE flat uint32 array, packed to
its information content, and comes back as one:

  input  nib:  4 bits/cell  = base code (3b) | cover (1b), 2 cells/byte
  input  qual: adaptive codebook — RTA3 instruments emit 4 quality levels
               ({2,12,23,37}), others 8: 'q2' = 2 bits/cell + a 4-entry
               codebook, 'q4' = 4 bits/cell + a 16-entry codebook, 'q8' =
               raw bytes. Uncovered cells carry codebook[0]; their quals
               are never observed (their bases are NBASE).
  input  meta: 8 bits/family = convert_mask rows (4b) | extend_eligible (1b)
  output:      the unpacked route's packed output planes
               (models.molecular / models.duplex pack_*_outputs): the
               JAX package's slim and b0 outputs save PCIe bytes worth
               less than the host rebuild they cost on the card (PERF.md).

Host side (numpy): the packers and the header refusals. The
numpy packers are the reference; with native=True the packers run the C
sweeps of csrc/host/wirepack.cpp (io.wirepack), byte-identical. The
caller chooses: the stage path takes the C sweep when its emit engine is
native, numpy when it is 'python'.

Device side (torch): the wire arrives as the bytes of the u32 words (one
H2D copy of a uint8 view) and is split and unpacked with uint8 tensor
ops on the device — the nibble and codebook decode never touch the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import NBASE


def _pad_to_words(flat_u8: np.ndarray) -> np.ndarray:
    pad = (-flat_u8.size) % 4
    if pad:
        flat_u8 = np.concatenate([flat_u8, np.zeros(pad, dtype=np.uint8)])
    return flat_u8.view(np.uint32)


QUAL_MODE_BITS = {"q2": 2, "q4": 4}
QUAL_MODES = ("q8", "auto", "q2", "q4")


def _qual_codebook_words(mode: str) -> int:
    return (1 << QUAL_MODE_BITS[mode]) // 4


_QUAL_SENTINEL = 255  # > max legal Phred (93): marks uncovered cells


def _masked_quals(quals: np.ndarray, cover: np.ndarray) -> np.ndarray:
    """Flat quals with uncovered cells replaced by the sentinel."""
    return np.where(cover.reshape(-1), quals.reshape(-1), _QUAL_SENTINEL)


def _qual_levels(masked: np.ndarray, n_uncovered: int):
    """(distinct covered Phred values, covered-cells-carry-255 flag). A
    covered 255 is indistinguishable from the sentinel in `masked`, so it
    is detected by count: the 255 bin exceeding the uncovered-cell
    population means real 0xff quals are present."""
    counts = np.bincount(masked, minlength=256)
    levels = np.nonzero(counts[:_QUAL_SENTINEL])[0].astype(np.uint8)
    if not levels.size:
        levels = np.zeros(1, np.uint8)
    return levels, int(counts[_QUAL_SENTINEL]) > n_uncovered


def _pack_qual_codes(masked: np.ndarray, mode: str, levels: np.ndarray):
    """Codebook-encode quals: returns u32 [codebook ++ packed indices].
    Only covered cells' values enter the codebook; the sentinel maps to
    index 0."""
    bits = QUAL_MODE_BITS[mode]
    if len(levels) > (1 << bits):
        raise ValueError(
            f"{len(levels)} distinct covered quals exceed {mode}'s "
            f"{1 << bits}-entry codebook; use qual_mode='auto'"
        )
    if levels.size and int(levels[-1]) > 93:
        raise ValueError(
            f"covered qual {int(levels[-1])} > 93 (BAM printable max) cannot "
            "ride a codebook mode; use qual_mode='q8' or 'auto'"
        )
    book = np.zeros(1 << bits, dtype=np.uint8)
    book[: len(levels)] = levels
    lut = np.zeros(256, dtype=np.uint8)
    lut[levels] = np.arange(len(levels), dtype=np.uint8)
    idx = lut[masked]
    per = 8 // bits
    pad = (-idx.size) % per
    if pad:
        idx = np.concatenate([idx, np.zeros(pad, dtype=np.uint8)])
    idx = idx.reshape(-1, per)
    packed = np.zeros(len(idx), dtype=np.uint8)
    for i in range(per):
        packed |= idx[:, i] << (bits * i)
    return np.concatenate([book.view(np.uint32), _pad_to_words(packed)])


def _unpack_qual_codes(qual: torch.Tensor, f: int, w: int, r: int, mode: str):
    """Device-side inverse of _pack_qual_codes on the section's bytes ->
    uint8 [f, r, w]."""
    bits = QUAL_MODE_BITS[mode]
    nbook = 1 << bits
    book = qual[:nbook]
    packed = qual[nbook:]
    per = 8 // bits
    mask = nbook - 1
    idx = torch.stack(
        [(packed >> (bits * i)) & mask for i in range(per)], dim=-1
    ).reshape(-1)[: f * r * w]
    return book[idx.long()].reshape(f, r, w)


@dataclasses.dataclass
class DuplexWire:
    """Host-side packed input batch for models.duplex.duplex_call_wire_fused."""

    nib: np.ndarray  # uint32 [F*R*W/8]   base|cover nibbles
    qual: np.ndarray  # uint32 — q8: [F*R*W/4] raw Phred bytes; q2/q4:
    #                   codebook words ++ [F*R*W*bits/32] packed indices
    meta: np.ndarray  # uint32 [ceil(F/4)] convert_mask|eligible bytes
    starts: np.ndarray  # uint32 [F] global genome offset of window (NO_REF = all-N)
    limits: np.ndarray  # uint32 [F] global genome offset one past the contig end
    f: int
    w: int
    qual_mode: str = "q8"  # 'q2'/'q4' codebook or raw 'q8' (see module doc)
    r: int = 4  # reads per family (duplex window rows)

    def to_words(self) -> np.ndarray:
        """ONE flat u32 array for the whole input direction — one H2D
        copy instead of five. Section order/sizes are static given
        (f, w, r, qual_mode); split on the device with split_duplex_wire."""
        return np.concatenate([self.starts, self.limits, self.meta, self.nib, self.qual])


def wire_section_sizes(f: int, w: int, r: int = 4, qual_mode: str = "q8") -> tuple[int, ...]:
    """u32 word counts of the to_words() sections, in order:
    starts, limits, meta, nib, qual."""
    cells = f * r * w
    if qual_mode == "q8":
        qual_words = -(-cells // 4)
    else:
        bits = QUAL_MODE_BITS[qual_mode]
        qual_words = _qual_codebook_words(qual_mode) + -(-(cells * bits) // 32)
    return (f, f, (f + 3) // 4, -(-(cells // 2) // 4), qual_words)


def _as_bytes(words) -> torch.Tensor:
    """The bytes of a u32 wire as a uint8 tensor (a numpy u32 array is
    viewed, not copied; a tensor of 4-byte words is viewed as bytes)."""
    if isinstance(words, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(words, dtype=np.uint32).view(np.uint8))
    return words if words.dtype == torch.uint8 else words.contiguous().view(torch.uint8)


def _split(words, sizes) -> list[torch.Tensor]:
    """Byte sections of a u32 wire at static word counts `sizes`."""
    data = _as_bytes(words)
    out, at = [], 0
    for s in sizes:
        out.append(data[4 * at: 4 * (at + s)])
        at += s
    return out


def split_duplex_wire(words, f: int, w: int, r: int = 4, qual_mode: str = "q8"):
    """Split DuplexWire.to_words() (a numpy u32 array, or its bytes on the
    device) into the byte sections (nib, qual, meta, starts, limits).

    Version refusal: a packed-rows wire (v2, pack_molecular_rows_wire)
    leads with PACKED_WIRE_MAGIC where a v1 wire carries starts[0]; a
    numpy array is checked here, where its bytes are host-visible."""
    if isinstance(words, np.ndarray) and words.size and int(words[0]) == PACKED_WIRE_MAGIC:
        raise ValueError(
            "packed rows wire (v2 magic word) passed to the v1 duplex wire "
            "splitter; unpack with split_molecular_rows_wire"
        )
    starts, limits, meta, nib, qual = _split(words, wire_section_sizes(f, w, r, qual_mode))
    return nib, qual, meta, starts, limits


def _check_qual_mode(qual_mode: str) -> None:
    if qual_mode not in QUAL_MODES:
        raise ValueError(
            f"qual_mode must be one of 'q8', 'auto', 'q2', 'q4'; got {qual_mode!r}"
        )


def pack_duplex_inputs(
    bases: np.ndarray,
    quals: np.ndarray,
    cover: np.ndarray,
    convert_mask: np.ndarray,
    eligible: np.ndarray,
    starts: np.ndarray,
    limits: np.ndarray,
    qual_mode: str = "q8",
    native: bool = False,
) -> DuplexWire:
    """Pack a DuplexBatch into flat u32 wire arrays.

    bases int8/uint8 [F, R, W] (NBASE where uncovered), quals uint8 [F, R, W],
    cover bool [F, R, W], convert_mask bool [F, R], eligible bool [F].
    W must be even. qual_mode 'auto' picks the smallest codebook the covered
    cells' distinct qual values fit ('q2' <= 4 levels, 'q4' <= 16, else
    'q8' raw bytes); the chosen mode travels in DuplexWire.qual_mode and
    MUST be passed to the unpack side. native: the C sweep
    (io.wirepack.pack_duplex), byte-identical to this numpy pack."""
    f, r, w = bases.shape
    if w % 2:
        raise ValueError(f"window width must be even, got {w}")
    _check_qual_mode(qual_mode)
    starts = np.asarray(starts, dtype=np.uint32)
    limits = np.asarray(limits, dtype=np.uint32)
    if native:
        from bsseqconsensusreads_tpu_torch.io import wirepack

        nib, qual, meta, resolved = wirepack.pack_duplex(
            bases, quals, cover, convert_mask, eligible, qual_mode
        )
        return DuplexWire(nib=nib, qual=qual, meta=meta, starts=starts, limits=limits,
                          f=f, w=w, qual_mode=resolved, r=r)
    masked = levels = None
    if qual_mode != "q8":
        n_uncovered = int(cover.size - np.count_nonzero(cover))
    if qual_mode == "auto":
        masked = _masked_quals(np.asarray(quals, dtype=np.uint8), cover)
        levels, has_255 = _qual_levels(masked, n_uncovered)
        n = len(levels)
        # Phred > 93 is outside the BAM printable range ('~'); 255 would
        # collide with the uncovered-cell sentinel — raw bytes are always safe
        if n > 16 or has_255 or int(levels[-1]) > 93:
            qual_mode = "q8"
        else:
            qual_mode = "q2" if n <= 4 else "q4"
    nib = (bases.astype(np.uint8) & 0x7) | (cover.astype(np.uint8) << 3)
    nib = nib.reshape(f * r * w // 2, 2)
    nib_packed = (nib[:, 0] | (nib[:, 1] << 4)).astype(np.uint8)
    meta = np.zeros(f, dtype=np.uint8)
    for row in range(min(r, 4)):
        meta |= convert_mask[:, row].astype(np.uint8) << row
    meta |= eligible.astype(np.uint8) << 4
    if qual_mode == "q8":
        qual_words = _pad_to_words(quals.astype(np.uint8).reshape(-1))
    else:
        if masked is None:
            masked = _masked_quals(np.asarray(quals, dtype=np.uint8), cover)
            levels, has_255 = _qual_levels(masked, n_uncovered)
            if has_255:
                raise ValueError(
                    "covered qual 255 (> 93, BAM printable max) cannot ride "
                    f"a {qual_mode} codebook; use qual_mode='q8' or 'auto'"
                )
        qual_words = _pack_qual_codes(masked, qual_mode, levels)
    return DuplexWire(
        nib=_pad_to_words(nib_packed), qual=qual_words, meta=_pad_to_words(meta),
        starts=starts, limits=limits, f=f, w=w, qual_mode=qual_mode, r=r,
    )


def pack_molecular_inputs(bases: np.ndarray, quals: np.ndarray, qual_mode: str = "auto",
                          native: bool = False) -> DuplexWire:
    """Pack a MolecularBatch's [F, T, 2, W] tensors as a 2T-row input wire
    (the v1 wire): the duplex format with r = 2T, cover = observed
    (derived from the bases), and the duplex-only meta/starts/limits
    sections zero. Unpack with unpack_duplex_inputs(r=2T) and reshape to
    [F, T, 2, W] (models.molecular.molecular_wire_kernel does both)."""
    f, t, two, w = bases.shape
    r = t * two
    b2 = np.ascontiguousarray(bases.reshape(f, r, w))
    return pack_duplex_inputs(
        b2, np.ascontiguousarray(quals.reshape(f, r, w)), b2 != NBASE,
        np.zeros((f, r), dtype=bool), np.zeros(f, dtype=bool),
        np.zeros(f, dtype=np.uint32), np.zeros(f, dtype=np.uint32),
        qual_mode=qual_mode, native=native,
    )


# ---- packed wire v2: segment-packed rows ---------------------------------
#
# v1 ships the [F, T, 2, W] padding envelope (r = 2T rows per family). v2
# ships the segment-packed row plan: a version-tagged header, the
# per-family row-offset plane, the per-row segment-id plane, then the v1
# nib/qual body of the dense [N, 2, W] rows. The two formats refuse each
# other by the magic word.

#: Leading word of every packed-rows wire ("2QSB" little-endian — never a
#: v1 MOLECULAR wire's first word, starts[0] == 0 by construction).
PACKED_WIRE_MAGIC = 0x42535132

#: Header words: magic, n_rows, num_families, n_real_rows, w, qual-mode
#: code (_ROWS_QUAL_CODE), 2 reserved zeros.
PACKED_WIRE_HDR = 8

_ROWS_QUAL_CODE = {"q8": 0, "q2": 1, "q4": 2}
_ROWS_CODE_QUAL = {v: k for k, v in _ROWS_QUAL_CODE.items()}


def rows_wire_section_sizes(n_rows: int, num_families: int, w: int,
                            qual_mode: str = "q8") -> tuple[int, ...]:
    """u32 word counts of the packed-rows wire sections, in order:
    header, row offsets, segment ids, nib, qual."""
    v1 = wire_section_sizes(n_rows, w, r=2, qual_mode=qual_mode)
    return (PACKED_WIRE_HDR, num_families + 1, n_rows, v1[3], v1[4])


def pack_molecular_rows_wire(
    bases: np.ndarray,
    quals: np.ndarray,
    seg: np.ndarray,
    num_families: int,
    n_real_rows: int,
    qual_mode: str = "auto",
    native: bool = False,
) -> tuple[np.ndarray, str]:
    """Pack a segment-packed row plan (ops.encode.PackedRows arrays) into
    ONE flat u32 wire — the packed wire v2.

    bases int8 [N, 2, W] (pad rows all-NBASE), quals uint8 [N, 2, W], seg
    int32 [N] ascending family ids (pad rows carry `num_families`).
    Returns (words, resolved_qual_mode); the resolved mode plus
    (N, num_families, w) are the static split keys of
    models.molecular.molecular_wire_packed_kernel — the header carries
    them too, for host-side validation.

    Layout: header ++ row offsets u32 [num_families + 1] ++ seg u32 [N] ++
    the v1 nib/qual body of the [N, 2, W] rows (native: the C
    wirepack_pack_rows sweep, cover derived from the bases; else the
    numpy pack_duplex_inputs)."""
    n, _, w = bases.shape
    _check_qual_mode(qual_mode)
    seg = np.ascontiguousarray(seg, dtype=np.int32)
    offsets = np.searchsorted(
        seg, np.arange(num_families + 1, dtype=np.int64), side="left"
    ).astype(np.uint32)
    if native:
        from bsseqconsensusreads_tpu_torch.io import wirepack

        nib, qual, resolved = wirepack.pack_rows(bases, quals, qual_mode)
    else:
        dw = pack_duplex_inputs(
            bases, quals, bases != NBASE,
            np.zeros((n, 2), dtype=bool), np.zeros(n, dtype=bool),
            np.zeros(n, dtype=np.uint32), np.zeros(n, dtype=np.uint32),
            qual_mode=qual_mode,
        )
        nib, qual, resolved = dw.nib, dw.qual, dw.qual_mode
    header = np.array(
        [PACKED_WIRE_MAGIC, n, num_families, n_real_rows, w, _ROWS_QUAL_CODE[resolved], 0, 0],
        dtype=np.uint32,
    )
    return np.concatenate([header, offsets, seg.astype(np.uint32), nib, qual]), resolved


def split_molecular_rows_wire(words, n_rows: int, num_families: int, w: int,
                              qual_mode: str = "q8"):
    """Split a packed-rows wire (v2) into byte sections (nib, qual,
    seg [4 * n_rows], offsets [4 * (num_families + 1)]).

    Version refusal: a numpy wire whose leading word is not
    PACKED_WIRE_MAGIC (e.g. a v1 DuplexWire) or whose header disagrees
    with the split keys is rejected before any section is mis-sliced."""
    if isinstance(words, np.ndarray):
        if not words.size or int(words[0]) != PACKED_WIRE_MAGIC:
            raise ValueError(
                "not a packed rows wire (v2): leading magic word missing "
                "— v1 wires unpack with split_duplex_wire"
            )
        hdr = (int(words[1]), int(words[2]), int(words[4]), _ROWS_CODE_QUAL.get(int(words[5])))
        want = (n_rows, num_families, w, qual_mode)
        if hdr != want:
            raise ValueError(
                f"packed rows wire header {hdr} does not match the split keys {want}"
            )
    _hdr, offsets, seg, nib, qual = _split(
        words, rows_wire_section_sizes(n_rows, num_families, w, qual_mode)
    )
    return nib, qual, seg, offsets


def unpack_duplex_inputs(nib, qual, meta, f: int, w: int, r: int = 4, qual_mode: str = "q8"):
    """Device-side inverse of pack_duplex_inputs on the sections' bytes
    (uint8 tensors). Returns (bases int8 [f,r,w], quals uint8 [f,r,w],
    cover bool [f,r,w], convert_mask bool [f,r], eligible bool [f])."""
    nib_u8 = nib[: f * r * w // 2]
    cells = torch.stack([nib_u8 & 0xF, nib_u8 >> 4], dim=-1).reshape(f, r, w)
    bases = (cells & 0x7).to(torch.int8)
    cover = (cells >> 3).to(torch.bool)
    if qual_mode == "q8":
        quals = qual[: f * r * w].reshape(f, r, w)
    else:
        quals = _unpack_qual_codes(qual, f, w, r, qual_mode)
    meta_u8 = meta[:f]
    convert_mask = torch.stack(
        [(meta_u8 >> row) & 1 for row in range(min(r, 4))], dim=-1
    ).to(torch.bool)
    eligible = ((meta_u8 >> 4) & 1).to(torch.bool)
    return bases, quals, cover, convert_mask, eligible


def unpack_rows_wire_inputs(nib, qual, n_rows: int, w: int, qual_mode: str = "q8"):
    """Device-side unpack of the v2 body -> (bases int8 [n_rows, 2, w],
    quals uint8 [n_rows, 2, w]); observation is NBASE-coded in the bases."""
    meta = torch.zeros(0, dtype=torch.uint8, device=nib.device)
    bases, quals, _, _, _ = unpack_duplex_inputs(
        nib, qual, meta, n_rows, w, r=2, qual_mode=qual_mode
    )
    return bases, quals

