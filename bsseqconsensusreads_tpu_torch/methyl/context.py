"""Per-column methylation epilogue on the duplex vote's batch.

The port of the JAX package's methyl/context.py. Bisulfite (and EM-seq)
conversion leaves methylated cytosines as C and turns unmethylated ones
into T, so once a duplex family's four reads (rows 99/163/83/147) sit in
window space, every reference cytosine column holds the molecule's whole
methylation evidence: extraction is a classify-and-count per column over
the batch tensors the duplex stage already has on the device, shipped
back as two extra u8 planes per family.

Semantics (the JAX package's, pinned by tests/test_torch_methyl.py):

  * A site is a reference C (top-strand cytosine: the NON-converted rows
    read it, raw C = methylated, raw T = unmethylated) or a reference G
    (bottom-strand cytosine: the CONVERT-MASK rows read it, raw G =
    methylated, raw A = unmethylated). The epilogue reads the RAW
    pre-conversion planes; ops.convert erases exactly this signal.
  * Context comes from the bounded reference extension ref_ext [F, W + 4],
    ref_ext[j] = genome[window_start - 2 + j]: CpG / CHG / CHH on the +
    strand from the two FOLLOWING bases, on the - strand from the two
    PRECEDING ones. A needed base that is N (out-of-contig columns gather
    N) suppresses the call.
  * An observation counts when the cell is covered and its input quality
    passes params.min_input_base_quality, the vote's own gate.
  * A column reports only where the duplex vote CALLED a base in at least
    one role.

Output per family: ctx u8 [F, W] (0 = no site; 1/2/3 = CpG/CHG/CHH on +;
4/5/6 = CpG/CHG/CHH on -) and counts u8 [F, W] nibble-packed as
meth | unmeth << 4 (at most 4 rows of evidence each). The device
epilogue (torch, on the tensors' device) and the host twin (numpy) run
ONE integer formula (_epilogue) over two array namespaces, so the planes
are bit-equal by construction. The JAX package computes this in XLA
outside any Pallas kernel; torch elementwise ops on the card are its
port.
"""

from __future__ import annotations

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import NBASE

#: ctx plane code reserved for "no callable site".
CTX_NONE = 0
#: code -> (context name, strand char) for the emit surface.
CTX_NAMES = {
    1: ("CpG", "+"), 2: ("CHG", "+"), 3: ("CHH", "+"),
    4: ("CpG", "-"), 5: ("CHG", "-"), 6: ("CHH", "-"),
}

_A, _C, _G, _T = 0, 1, 2, 3


class _TorchNS:
    """The array operations _epilogue uses, on torch tensors."""

    bool_, uint8, float32 = torch.bool, torch.uint8, torch.float32
    where = staticmethod(torch.where)

    @staticmethod
    def sum(x, axis):
        return x.sum(dim=axis)

    @staticmethod
    def astype(x, dtype):
        return x.to(dtype)


class _NumpyNS:
    """The same operations on numpy arrays (the host twin)."""

    bool_, uint8, float32 = np.bool_, np.uint8, np.float32
    where = staticmethod(np.where)

    @staticmethod
    def sum(x, axis):
        return np.sum(x, axis=axis)

    @staticmethod
    def astype(x, dtype):
        return x.astype(dtype)


def _classify(xp, r_m2, r_m1, r_0, r_p1, r_p2):
    """Context code per column, one formula for both namespaces.

    + strand (ref C): CpG when next is G; CHG when next is a non-N non-G
    and next-but-one is G; CHH when both followers are non-N non-G.
    - strand (ref G): the mirror over the preceding bases with C."""
    p1g, p1n = r_p1 == _G, r_p1 == NBASE
    p2g, p2n = r_p2 == _G, r_p2 == NBASE
    ctx_p = xp.where(p1g, 1, xp.where(p1n, 0, xp.where(p2g, 2, xp.where(p2n, 0, 3))))
    m1c, m1n = r_m1 == _C, r_m1 == NBASE
    m2c, m2n = r_m2 == _C, r_m2 == NBASE
    ctx_m = xp.where(m1c, 4, xp.where(m1n, 0, xp.where(m2c, 5, xp.where(m2n, 0, 6))))
    return xp.where(r_0 == _C, ctx_p, xp.where(r_0 == _G, ctx_m, 0))


def _epilogue(xp, bases, quals, cover, convert_mask, cons_base, ref_ext, min_q):
    """(ctx, counts) u8 [F, W]: the shared integer formula. Sums over bool
    give int64 and where() over Python ints gives int64 in both
    namespaces; every result is narrowed to uint8 before it is packed."""
    w = bases.shape[-1]
    q = xp.astype(quals, xp.float32)
    obs = cover & (q >= min_q)  # [F, 4, W]
    cm = xp.astype(convert_mask, xp.bool_)[:, :, None]  # [F, 4, 1]
    r_m2 = ref_ext[:, 0:w]
    r_m1 = ref_ext[:, 1:w + 1]
    r_0 = ref_ext[:, 2:w + 2]
    r_p1 = ref_ext[:, 3:w + 3]
    r_p2 = ref_ext[:, 4:w + 4]
    ctx = _classify(xp, r_m2, r_m1, r_0, r_p1, r_p2)
    called = (cons_base[:, 0, :] != NBASE) | (cons_base[:, 1, :] != NBASE)
    ctx = xp.astype(xp.where(called, ctx, 0), xp.uint8)
    # top-strand sites read the untreated rows as they are; bottom-strand
    # sites read the convert-mask rows, whose G/A carries the bottom
    # strand's cytosine state
    obs_p = obs & ~cm
    obs_m = obs & cm
    meth_p = xp.sum(obs_p & (bases == _C), 1)
    unme_p = xp.sum(obs_p & (bases == _T), 1)
    meth_m = xp.sum(obs_m & (bases == _G), 1)
    unme_m = xp.sum(obs_m & (bases == _A), 1)
    top = r_0 == _C
    meth = xp.astype(xp.where(top, meth_p, meth_m), xp.uint8)
    unme = xp.astype(xp.where(top, unme_p, unme_m), xp.uint8)
    valid = ctx != 0
    counts = xp.astype(xp.where(valid, meth | (unme << 4), 0), xp.uint8)
    return ctx, counts


def methyl_epilogue(bases, quals, cover, convert_mask, cons_base, ref_ext,
                    min_q: float) -> torch.Tensor:
    """The epilogue on the tensors' device: planes u8 [F, 2, W], row 0 the
    ctx codes, row 1 the nibble-packed counts (meth | unmeth << 4).

    bases / quals / cover are the RAW batch planes [F, 4, W]
    (pre-conversion; quals any integer dtype, cover bool), convert_mask
    bool [F, 4], cons_base int8 [F, 2, W] (the duplex vote's base plane),
    ref_ext int8 [F, W + 4] (ops.refstore.gather_windows_ext)."""
    ctx, counts = _epilogue(
        _TorchNS, bases, quals, cover.to(torch.bool), convert_mask, cons_base,
        ref_ext, float(np.float32(min_q)),
    )
    return torch.stack([ctx, counts], dim=1)


def methyl_epilogue_host(bases, quals, cover, convert_mask, cons_base,
                         ref_ext, min_q: float) -> np.ndarray:
    """numpy host twin of methyl_epilogue: the same planes, bit for bit.
    The duplex stage runs it under methyl_engine 'host'."""
    ctx, counts = _epilogue(
        _NumpyNS,
        np.asarray(bases),
        np.asarray(quals),
        np.asarray(cover, dtype=bool),
        np.asarray(convert_mask, dtype=bool),
        np.asarray(cons_base),
        np.asarray(ref_ext),
        np.float32(min_q),
    )
    return np.stack([ctx, counts], axis=1)


def methyl_wire_words(planes: torch.Tensor) -> torch.Tensor:
    """The planes u8 [F, 2, W] viewed as flat 32-bit words (int32 bit
    patterns; little-endian, so their bytes are the planes' bytes in order
    — the JAX package's bitcast_convert_type words). The output wire
    appends their bytes after the full duplex output planes."""
    return planes.contiguous().reshape(-1, 4).view(torch.int32).reshape(-1)


def unpack_methyl_planes(words, f: int, w: int) -> np.ndarray:
    """numpy inverse of methyl_wire_words -> u8 [f, 2, w]."""
    u8 = np.asarray(words)
    if u8.dtype != np.uint8:
        u8 = u8.view(np.uint8)
    return u8[: f * 2 * w].reshape(f, 2, w)
