"""Banded intra-family alignment for indel-bearing reads.

The port of the JAX package's ops/banded.py. The reference drops any read
whose CIGAR holds an insertion, deletion or hardclip
(tools/1.convert_AG_to_CT.py:79-80); under indel_policy 'align' the
molecular encode (ops.encode._align_pending) aligns each indel read
against its family's anchor (the per-column majority of the directly
placed reads of its role) with a banded Needleman-Wunsch in window space,
so PCR-stutter and homopolymer indel reads add depth instead of vanishing.

* banded_scores — the DP on the device: the band gather and the
  bisulfite-neutral substitution score of every read position at once
  ([N, L, 2B+1]), then a loop over the positions 1..L carrying one
  [N, 2B+1] float32 row, each step the diagonal add, the `up` shift, a
  cummax closure over the deletion chain and the carry of NBASE rows.
  Every operation and its order is the JAX package's lax.scan (the same
  adds, the same NEG), so the scores are bit-equal to its jitted function
  (tests/test_torch_banded.py). It is an XLA scan there, not a Pallas
  kernel: plain torch ops on the card are its port, nine launches per
  read position.
* banded_align — the host numpy traceback of the JAX package, copied
  with its move priority (left > diag > up within eps) and its no_move
  refusal, over the score matrix fetched from the device.

Scoring: read T over anchor C and read A over anchor G are the expected
conversion signals on the two strands, scored `bs_neutral` rather than as
a mismatch. Output rows are window space: matched chars on their column,
inserted chars gone, deleted columns uncovered (NBASE) — the vote's "no
observation".
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import A, C, G, NBASE, T
from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

NEG = -1e9  # effectively -inf for float32 score cells

#: one entry per banded_align call: the DP's (N, L), its seconds on the
#: device (the loop's launches and the score matrix's fetch) and the host
#: traceback's seconds; callers clear it around the run they measure
CALLS: list = []


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def banded_scores(reads, ref, offsets, band: int = 8,
                  match: float = 4.0, mismatch: float = -6.0,
                  gap: float = -8.0, bs_neutral: float = 1.0,
                  device=None) -> torch.Tensor:
    """Banded NW score matrices on `device` (default the card).

    reads: int8 [N, L] (NBASE-padded), ref: int8 [N, W] window anchor codes
    (NBASE = uncovered column), offsets: int32 [N] expected window column of
    each read's first char (numpy arrays or tensors). Returns M float32
    [N, L+1, 2B+1] on the device: M[n, i, d] = best score of consuming i
    read chars with char i at window column offsets[n] + i - 1 + (d - B).
    Padded chars (NBASE) keep rows constant so one loop serves mixed
    lengths."""
    dev = resolve_device(device)
    reads = _as_tensor(reads, torch.int8, dev)
    ref = _as_tensor(ref, torch.int8, dev)
    offsets = _as_tensor(offsets, torch.int32, dev)
    n, l = reads.shape
    w = ref.shape[-1]
    width = 2 * band + 1
    ds = torch.arange(width, dtype=torch.int32, device=dev) - band
    gds = (gap * ds.to(torch.float32))[None, :]  # [1, width]
    f32 = dict(dtype=torch.float32, device=dev)
    # every row's diagonal term at once, [N, L, width]: the band gather
    # (clipped to the window) and the bisulfite-neutral substitution score,
    # NEG off the window — the elementwise half of the scan's step
    cols = (offsets[:, None, None] + torch.arange(l, dtype=torch.int32, device=dev)[None, :, None]
            + ds[None, None, :])
    in_win = (cols >= 0) & (cols < w)
    r = torch.gather(ref[:, None, :].expand(n, l, w), 2, cols.clamp(0, w - 1).long())
    x = reads[:, :, None]
    is_n = (x == NBASE) | (r == NBASE)
    bs = ((x == T) & (r == C)) | ((x == A) & (r == G))
    sub = torch.where(is_n, torch.tensor(0.0, **f32), torch.where(
        x == r, torch.tensor(match, **f32),
        torch.where(bs, torch.tensor(bs_neutral, **f32), torch.tensor(mismatch, **f32))))
    diag_add = torch.where(in_win, sub, torch.tensor(NEG, **f32))
    carry = (reads == NBASE)[:, :, None]  # [N, L, 1]
    del cols, in_win, r, is_n, bs, sub
    neg_col = torch.full((n, 1), NEG, **f32)
    init = (gap * ds.abs().to(torch.float32))[None, :].expand(n, width)
    rows = [init]
    for i in range(1, l + 1):
        prev = rows[-1]
        diag = prev + diag_add[:, i - 1]
        up = torch.cat([prev[:, 1:], neg_col], dim=1) + gap
        pre = torch.maximum(diag, up)
        # deletion-chain closure: M[d] = max_{k<=d} pre[k] + gap*(d-k)
        closed = torch.cummax(pre - gds, dim=1).values + gds
        # padded chars: carry the previous row through unchanged
        rows.append(torch.where(carry[:, i - 1], prev, closed))
    return torch.stack(rows, dim=1)


def _sub_np(x, r, match, mismatch, bs_neutral):
    is_n = (x == NBASE) | (r == NBASE)
    bs = ((x == T) & (r == C)) | ((x == A) & (r == G))
    return np.where(
        is_n, 0.0, np.where(x == r, match, np.where(bs, bs_neutral, mismatch))
    )


def banded_align(reads, quals, ref, offsets, band: int = 8,
                 match: float = 4.0, mismatch: float = -6.0,
                 gap: float = -8.0, bs_neutral: float = 1.0,
                 min_score_per_base: float = 0.0, device=None):
    """Align indel reads into window space.

    reads int8 [N, L] (NBASE-padded), quals uint8 [N, L], ref int8 [N, W]
    anchors, offsets int32 [N]. Returns (bases int8 [N, W], quals uint8
    [N, W], ok bool [N]): window rows with aligned chars on their columns
    (NBASE elsewhere), and ok=False for reads whose best banded score is
    below min_score_per_base * length (unalignable within the band — the
    caller keeps the drop behavior for those).

    The DP runs on `device` (banded_scores; default the card); the
    traceback walks the fetched score matrix on the host, vectorized over
    the batch."""
    reads = np.asarray(reads, dtype=np.int8)
    quals = np.asarray(quals, dtype=np.uint8)
    ref = np.asarray(ref, dtype=np.int8)
    offsets = np.asarray(offsets, dtype=np.int32)
    n, l = reads.shape
    w = ref.shape[-1]
    width = 2 * band + 1
    t0 = time.monotonic()
    m = banded_scores(
        reads, ref, offsets, band, match, mismatch, gap, bs_neutral, device=device
    ).cpu().numpy()  # [N, L+1, width]
    t1 = time.monotonic()

    lens = (reads != NBASE).sum(axis=-1)
    out_b = np.full((n, w), NBASE, dtype=np.int8)
    out_q = np.zeros((n, w), dtype=np.uint8)
    # NBASE chars (pad AND mid-read Ns) carry the row through unchanged,
    # so the last row is every read's final row: start traceback at i=l.
    best_d = np.argmax(m[:, l], axis=-1)
    best = m[np.arange(n), l, best_d]
    ok = best >= min_score_per_base * np.maximum(lens, 1)

    i = np.full(n, l)  # current read position (1-based char index)
    d = best_d.astype(np.int64)
    active = ok.copy()
    rows = np.arange(n)
    ds = np.arange(width) - band
    eps = 1e-4
    for _ in range(2 * l + 2 * width + 4):
        if not active.any():
            break
        cur = m[rows, i, d]
        cols = offsets + (i - 1) + ds[d]
        xi = np.take_along_axis(reads, np.maximum(i - 1, 0)[:, None], 1)[:, 0]
        # NBASE char rows were carried through: step i without moving d
        is_pad = (i > 0) & (xi == NBASE)
        in_win = (cols >= 0) & (cols < w)
        ref_d = ref[rows, np.clip(cols, 0, w - 1)]
        diag = np.where(
            (i > 0) & in_win,
            m[rows, np.maximum(i - 1, 0), d]
            + _sub_np(xi, ref_d, match, mismatch, bs_neutral),
            NEG,
        )
        up = np.where(
            (i > 0) & (d + 1 < width),
            m[rows, np.maximum(i - 1, 0), np.minimum(d + 1, width - 1)] + gap, NEG,
        )
        left = np.where(d > 0, m[rows, i, np.maximum(d - 1, 0)] + gap, NEG)

        # Move priority on exact score ties: left (deletion) > diag > up.
        # Walking backwards, the deletion move first pins a gap inside a
        # repeat run at the rightmost tied column (a fixed convention);
        # diag first would park the preceding base on a column it was not
        # observed at.
        take_pad = active & is_pad
        take_left = active & ~is_pad & (np.abs(left - cur) <= eps)
        take_diag = active & ~is_pad & ~take_left & (np.abs(diag - cur) <= eps)
        take_up = (
            active & ~is_pad & ~take_left & ~take_diag
            & (np.abs(up - cur) <= eps)
        )
        # No move matches the cell score (an invalid band edge): the read
        # is refused, never left half placed with ok=True.
        no_move = active & ~is_pad & ~take_left & ~take_diag & ~take_up
        ok[no_move] = False
        out_b[no_move] = NBASE
        out_q[no_move] = 0
        active = active & ~no_move

        # diag: char i-1 (0-based) sits at column cols
        place = take_diag & in_win
        out_b[rows[place], cols[place]] = np.take_along_axis(
            reads, (i - 1)[:, None], 1
        )[:, 0][place]
        out_q[rows[place], cols[place]] = np.take_along_axis(
            quals, (i - 1)[:, None], 1
        )[:, 0][place]

        i = np.where(take_pad | take_diag | take_up, np.maximum(i - 1, 0), i)
        d = np.where(take_up, np.minimum(d + 1, width - 1), d)
        d = np.where(take_left, np.maximum(d - 1, 0), d)
        active = active & (i > 0)

    cover = out_b != NBASE
    out_b[~cover] = NBASE
    CALLS.append({"n": n, "l": l, "dp_s": t1 - t0, "traceback_s": time.monotonic() - t1})
    return out_b, out_q, ok
