"""Kernel-built consensus-qual lookup tables.

The port of qual_tables from the JAX package's ops/reconstruct.py. A
column voted from at most two observations has a consensus quality that
is a pure function of (the observation quals, which strands observed,
whether they agreed), so the vote over every such case is run ONCE and
the results are cached. The tables carry the rounding of the device that
built them: on the card that is the card's expf/logf, so the singleton
host path (models.molecular.singleton_consensus_host) reproduces exactly
what the kernel would have called for those columns.

* T_agree / T_disagree [256, 256]: the port's duplex vote (one seg_vote
  launch over a [256, 4, 512] batch whose role-0 columns enumerate every
  (A qual, B qual) pair, agreeing then disagreeing).
* T_single [256] and its two base verdicts: the finalize of one
  observation — ll = (log_ok, log_err, log_err, log_err) of the qual,
  depth 1, through ops.cuda_vote.vote_finalize. These are the same bits
  the duplex vote accumulates for a lone observation (0 + term), so the
  verdicts equal the vote's own.
"""

from __future__ import annotations

import numpy as np
import torch

from bsseqconsensusreads_tpu_torch.alphabet import NBASE
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import cuda_vote, phred
from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

_CACHE: dict = {}


def _build(params: ConsensusParams, device: torch.device):
    from bsseqconsensusreads_tpu_torch.models.duplex import duplex_consensus

    n = 256
    w = 512  # 256 agree + 256 disagree
    bases = np.full((n, 4, w), NBASE, dtype=np.int8)
    quals = np.zeros((n, 4, w), dtype=np.int16)
    # row 0 = A strand (flag 99), row 1 = B strand (flag 163), role 0
    bases[:, 0, :] = 0  # base A, qual = the family index
    quals[:, 0, :] = np.arange(n, dtype=np.int16)[:, None]
    bases[:, 1, 0:256] = 0  # agree: B also base A
    bases[:, 1, 256:512] = 1  # disagree: B base C
    quals[:, 1, :] = np.tile(np.arange(256, dtype=np.int16), 2)[None, :]
    out = duplex_consensus(
        torch.from_numpy(bases).to(device), torch.from_numpy(quals).to(device),
        params,
    )
    qual = out["qual"][:, 0, :].cpu().numpy()  # [256, 512]

    # single observation: base A at qual q (observed when q >= min input)
    table = phred.log_table(params.error_rate_post_umi, device)[:n]
    obs = torch.arange(n, device=device) >= params.min_input_base_quality
    ll = torch.stack([table[:, 0], table[:, 1], table[:, 1], table[:, 1]], dim=-1)
    ll = torch.where(obs[:, None], ll, 0.0).contiguous()
    single_base, single_qual = cuda_vote.vote_finalize(
        ll, obs.to(torch.int32), params
    )
    single_base = single_base.cpu().numpy()
    return (
        np.ascontiguousarray(single_qual.cpu().numpy()),
        np.ascontiguousarray(qual[:, 0:256]),
        np.ascontiguousarray(qual[:, 256:512]),
        np.ascontiguousarray(single_base == NBASE),
        np.ascontiguousarray((single_base != NBASE) & (single_base != 0)),
    )


def qual_tables(params: ConsensusParams, device=None):
    """(T_single [256], T_agree [256, 256], T_disagree [256, 256],
    T_single_masked bool [256], T_single_flip bool [256]) — quals uint8,
    built on `device` (the card unless the caller asks for the CPU) once
    per (params, device) and cached.

    T_single_masked: the lone observation's call is masked to N
    (min_consensus_base_quality or min input qual). T_single_flip: the
    argmax FLIPPED away from the observed base (post-UMI error probability
    > 0.75, raw quals 0-1 under the default model) — the call becomes the
    lowest-index other base and the column counts one error."""
    device = resolve_device(device)
    key = (params, str(device))
    tables = _CACHE.get(key)
    if tables is None:
        tables = _CACHE[key] = _build(params, device)
    return tables
