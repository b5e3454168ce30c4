"""Device-resident reference genome with a window gather on the device.

The port of the JAX package's ops/refstore.py. The genome is uploaded
once per device as a flat int8 code array (one byte per base, contigs
concatenated); each wire batch sends one uint32 start offset and one
uint32 contig limit per family, and the [F, W+1] windows are gathered on
the device. Out-of-range windows (no contig, start < 0) and columns past
the contig's end gather NBASE — the reference's all-N fallback for a
failed fetch (tools/1.convert_AG_to_CT.py:106-109) and its N padding for
a short one (:116-117).

Offsets are uint32 on the wire (a human genome has more than 2**31
bases). On the device they are widened to int64 by bit pattern
(int32 view & 0xFFFFFFFF), and every index is clamped into
[0, genome_len - 1] before the gather and masked after it: a CUDA index
past the end is an illegal address, where XLA's take clamps silently.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import BASE_CODE, NBASE

#: starts value meaning "no reference for this family" (all-N window).
#: uint32 so a human-scale (~3.1 Gbp > 2**31) concatenated genome indexes
#: without overflow; the genome length cap is 2**32 - 2**16.
NO_REF = np.uint32(0xFFFFFFFF)
MAX_GENOME = (1 << 32) - (1 << 16)
_U32 = 0xFFFFFFFF
#: bytes.translate table: FASTA byte -> its int8 base code (BASE_CODE)
_CODE_TABLE = BASE_CODE.view(np.uint8).tobytes()


def widen_u32(t) -> torch.Tensor:
    """int64 values of uint32 words held as a torch tensor (int32 bit
    patterns, uint32, their bytes as uint8, or int64) or a numpy uint32
    array."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t, dtype=np.uint32).view(np.int32))
    if t.dtype == torch.int64:
        return t
    if t.dtype != torch.int32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _U32


def _gather(genome: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """genome[idx] where valid, NBASE elsewhere; idx clamped first."""
    if genome.numel() == 0:
        return torch.full(idx.shape, NBASE, dtype=torch.int8, device=idx.device)
    return torch.where(valid, genome[idx.clamp(0, genome.numel() - 1)], NBASE)


def gather_windows(genome, starts, limits, width: int) -> torch.Tensor:
    """Gather [F, width] reference windows from the flat genome.

    genome: int8 [G] on the device (all contigs concatenated);
    starts/limits: uint32 [F] global offsets (start of window / one past
    the end of its contig) on the genome's device, as int32 bit patterns
    or the words' bytes (widen_u32).
    starts == NO_REF yields an all-N row; columns at/past `limits` yield N."""
    s = widen_u32(starts)
    idx = s[:, None] + torch.arange(width, dtype=torch.int64, device=s.device)
    valid = (s[:, None] != int(NO_REF)) & (idx < widen_u32(limits)[:, None])
    return _gather(genome, idx, valid)


def gather_windows_ext(genome, starts, los, limits, width: int) -> torch.Tensor:
    """Bounded EXTENSION gather: [F, width] windows starting 2 bases BEFORE
    each family's window (ref_ext[j] = genome[start - 2 + j]), N outside
    [los, limits) — los is the global offset of the family's contig's
    first base, so the methylation context never sees the previous
    contig's trailing bases. int64 arithmetic: pre-genome columns are
    negative and fail the lower bound."""
    s = widen_u32(starts)
    idx = s[:, None] - 2 + torch.arange(width, dtype=torch.int64, device=s.device)
    valid = (
        (s[:, None] != int(NO_REF))
        & (idx >= widen_u32(los)[:, None])
        & (idx < widen_u32(limits)[:, None])
    )
    return _gather(genome, idx, valid)


class RefStore:
    """Concatenated genome codes + per-contig offsets; uploaded to each
    device once (device_codes)."""

    def __init__(self, names, seqs=None, codes=None, lengths=None):
        self.names = list(names)
        if codes is None:
            parts = [
                BASE_CODE[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]
                for s in seqs
            ]
            lengths = [len(p) for p in parts]
            codes = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int8)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)])[:-1]
        self._index = {n: i for i, n in enumerate(self.names)}
        self.codes = np.ascontiguousarray(codes, dtype=np.int8)
        if self.codes.size > MAX_GENOME:
            raise ValueError(
                f"genome of {self.codes.size} bases exceeds the uint32 "
                f"offset cap {MAX_GENOME}; shard contigs across RefStores"
            )
        self._device: dict[str, torch.Tensor] = {}
        self._device_lock = threading.Lock()

    @classmethod
    def from_fasta(cls, path: str) -> "RefStore":
        """The whole genome read straight from the file's bytes: per
        contig one read of its span (located by the faidx index), the
        line ends dropped and the bases coded in one bytes.translate pass,
        copied into the one preallocated code array. Host memory: the
        codes plus two copies of the largest contig's bytes (no per-contig
        string). Same codes as FastaFile.fetch of every contig."""
        from bsseqconsensusreads_tpu_torch.io.fasta import FastaError, FastaFile

        with FastaFile(path) as fa:
            names = fa.references
            spans = [fa.span(n) for n in names]
        lengths = [length for length, _, _ in spans]
        codes = np.empty(sum(lengths), np.int8)
        o = 0
        with open(path, "rb") as fh:
            for name, (length, first, nbytes) in zip(names, spans):
                fh.seek(first)
                raw = fh.read(nbytes)
                coded = raw.translate(_CODE_TABLE, b"\r\n")
                if len(raw) != nbytes or len(coded) != length:
                    raise FastaError(f"{path}: sequence {name!r} disagrees with its .fai index")
                codes[o:o + length] = np.frombuffer(coded, np.int8)
                o += length
        return cls(names, codes=codes, lengths=lengths)

    def device_codes(self, device) -> torch.Tensor:
        """The genome as int8 [G] on `device`: uploaded at first use, once
        per device, under a lock (two first uses never both copy it)."""
        key = str(torch.device(device))
        with self._device_lock:
            codes = self._device.get(key)
            if codes is None:
                codes = self._device[key] = torch.from_numpy(self.codes).to(device)
        return codes

    def contig_indices(self, names) -> np.ndarray:
        """Map contig NAMES (e.g. a BAM header's reference order, which need
        not match the FASTA's) to this store's contig indices; unknown names
        map to -1 (-> NO_REF rows from window_offsets)."""
        return np.asarray([self._index.get(n, -1) for n in names], dtype=np.int64)

    def host_windows(self, starts, limits, width: int) -> np.ndarray:
        """numpy twin of gather_windows over the HOST copy of the genome:
        int8 [F, width] windows with the same NO_REF / past-limit N
        semantics. The duplex rawize reads these when the wire skipped the
        per-family host reference fetch."""
        starts = np.asarray(starts, dtype=np.uint32)
        limits = np.asarray(limits, dtype=np.uint32)
        idx = starts[:, None].astype(np.int64) + np.arange(width)
        valid = (starts[:, None] != NO_REF) & (idx < limits[:, None].astype(np.int64))
        safe = np.minimum(idx, max(self.codes.size - 1, 0))
        ref = self.codes[safe] if self.codes.size else np.zeros(idx.shape, np.int8)
        return np.where(valid, ref, np.int8(NBASE))

    def host_windows_ext(self, starts, los, limits, width: int) -> np.ndarray:
        """numpy twin of gather_windows_ext over the HOST genome copy:
        int8 [F, width] extension windows (start - 2), N outside
        [los, limits)."""
        starts = np.asarray(starts, dtype=np.uint32)
        idx = starts[:, None].astype(np.int64) - 2 + np.arange(width)
        valid = (
            (starts[:, None] != NO_REF)
            & (idx >= np.asarray(los, dtype=np.uint32)[:, None].astype(np.int64))
            & (idx < np.asarray(limits, dtype=np.uint32)[:, None].astype(np.int64))
        )
        safe = np.clip(idx, 0, max(self.codes.size - 1, 0))
        ref = self.codes[safe] if self.codes.size else np.zeros(idx.shape, np.int8)
        return np.where(valid, ref, np.int8(NBASE))

    def window_origins(self, ref_ids) -> np.ndarray:
        """uint32 [F] global offset of each family's contig FIRST base —
        the lower bound of gather_windows_ext. Invalid ref_ids map to 0
        (their starts are NO_REF / limits 0, so the bound never engages)."""
        rid = np.asarray(ref_ids, dtype=np.int64)
        ok = (rid >= 0) & (rid < len(self.names))
        return np.where(ok, self.offsets[np.where(ok, rid, 0)], 0).astype(np.uint32)

    def window_offsets(self, ref_ids, window_starts):
        """Vectorized (starts, limits) uint32 arrays for gather_windows.

        ref_ids outside [0, n_contigs) or window_starts < 0 map to
        start = NO_REF (all-N row — the reference's failed-fetch fallback,
        tools/1.convert_AG_to_CT.py:106-109). Offset math runs in int64 and
        is range-checked before the uint32 narrowing."""
        rid = np.asarray(ref_ids, dtype=np.int64)
        ws = np.asarray(window_starts, dtype=np.int64)
        ok = (rid >= 0) & (rid < len(self.names)) & (ws >= 0)
        safe = np.where(ok, rid, 0)
        starts = self.offsets[safe] + ws
        ok &= starts < MAX_GENOME
        starts = np.where(ok, starts, np.int64(NO_REF))
        limits = np.where(ok, self.offsets[safe] + self.lengths[safe], 0)
        return starts.astype(np.uint32), limits.astype(np.uint32)
