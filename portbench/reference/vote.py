"""The consensus vote, written plainly from fgbio's documented error
model, in a chosen floating type (float64 for the reference; the control
takes bfloat16, the nearest type below the float32 the configuration
states).

Per observation with Phred q: p = two_trials(10^(-q/10), p_post), kept
inside [1e-12, 1 - 1e-7]; a candidate base gains log(1 - p) where the
observation agrees and log(p / 3) where it does not. The call is the
candidate of largest sum (the lowest base among those within 2.5e-6 of
the largest); its error is 1 - 1 / sum_c exp(LL_c - LL_max), combined
with p_pre by two_trials, as Phred clamped to [2, 93] and rounded. A
column with no observation, or whose quality falls below the minimum,
is N at quality 2.
"""

from __future__ import annotations

import numpy as np
import torch

NBASE = 4
TIE = 2.5e-6
NO_CALL_QUAL = 2


def perr(q):
    return 10.0 ** (-np.asarray(q, np.float64) / 10.0)


def two_trials(p1, p2):
    return p1 * (1 - p2) + (1 - p1) * p2 + (2.0 / 3.0) * p1 * p2


def log_terms(quals: np.ndarray, post: float) -> tuple[np.ndarray, np.ndarray]:
    """float64 (log P(obs | agrees), log P(obs | differs)) per Phred."""
    p = np.clip(two_trials(perr(quals), perr(post)), 1e-12, 1.0 - 1e-7)
    return np.log1p(-p), np.log(p / 3.0)


def vote(bases: np.ndarray, quals: np.ndarray, params: dict, dtype=torch.float64) -> dict:
    """Columns of observations -> the consensus of each column.

    bases int [R, W] (4 = no observation), quals int [R, W]. Returns
    base int8 [W], qual uint8 [W], depth int32 [W], errors int32 [W]."""
    bases = np.asarray(bases, np.int64)
    quals = np.asarray(quals, np.int64)
    obs = (bases != NBASE) & (quals >= params["min_input_base_quality"])
    ok, err = log_terms(quals, params["error_rate_post_umi"])
    cand = np.arange(4)
    terms = np.where(obs[..., None], np.where(bases[..., None] == cand, ok[..., None],
                                              err[..., None]), 0.0)  # [R, W, 4]
    t = torch.from_numpy(terms).to(dtype)
    if dtype == torch.float64:
        ll = t.sum(dim=0)
    else:  # every add rounds to the type
        ll = torch.zeros(t.shape[1:], dtype=dtype)
        for r in range(t.shape[0]):
            ll = ll + t[r]
    depth = obs.sum(axis=0).astype(np.int32)
    m = ll.max(dim=-1, keepdim=True).values
    near = ll >= (m - TIE)
    cons = torch.where(near, torch.arange(4), 4).min(dim=-1).values.numpy()
    e = torch.sort(torch.exp(ll - m), dim=-1).values
    denom = ((e[..., 0] + e[..., 1]) + e[..., 2]) + e[..., 3]
    one = torch.ones((), dtype=dtype)
    p_cons = one - one / denom
    p_pre = torch.tensor(float(perr(params["error_rate_pre_umi"])), dtype=dtype)
    p_fin = p_cons * (one - p_pre) + (one - p_cons) * p_pre + (2.0 / 3.0) * p_cons * p_pre
    p_fin = torch.clamp(p_fin, min=1e-12)
    q = torch.clamp(-10.0 * torch.log10(p_fin), 2.0, 93.0)
    q = torch.round(q.to(torch.float64)).numpy()
    keep = (depth > 0) & ~(q < params["min_consensus_base_quality"])
    base = np.where(keep, cons, NBASE).astype(np.int8)
    qual = np.where(keep, q, NO_CALL_QUAL).astype(np.uint8)
    errors = np.where(base != NBASE, (obs & (bases != base)).sum(axis=0), 0).astype(np.int32)
    return {"base": base, "qual": qual, "depth": depth, "errors": errors}
