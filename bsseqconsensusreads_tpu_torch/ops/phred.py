"""Phred-scale probability arithmetic for the consensus error model, in
torch, plus the pinned log-likelihood tables the vote reads.

The reference's consensus engines (fgbio CallMolecularConsensusReads /
CallDuplexConsensusReads, invoked at main.snake.py:54,163) parameterize their
error model with Phred-scaled rates: --error-rate-pre-umi=45 and
--error-rate-post-umi=30. This module is the JAX package's ops/phred.py on
torch tensors (float32 throughout).

Why pinned tables. Every quality the vote sees is an integer (uint8
input, co-call sums <= 510, the conversion prepend's 40), so the
per-observation log terms are a lookup in a [512, 2] table. The JAX
package computes them per element inside its jitted programs, with the
post-UMI rate a static constant, and torch's float32 pow/log1p/log land
an ulp or more away from XLA's on up to half of the quals (XLA's float32
pow is not correctly rounded) — so a recomputation cannot match bit for
bit. log_tables_post_umi.npy therefore holds the bits of the JAX
package's jitted `log_likelihoods(adjust_quals_post_umi(q, rate))` over
q = 0..511 for every integer post-UMI rate 0..93 (float32 [94, 512, 2]):
fgbio takes --error-rate-post-umi as a Phred byte, so an integer rate is
what users pass. `python tests/test_torch_phred.py --write-tables`
regenerates it; the tests hold it bit-equal at all 94 rates. A
non-integer rate computes its table in torch (a few ulps off the JAX
package's; the tests bound one such rate). The finalize's one scalar
constant, phred_to_prob(error_rate_pre_umi), is computed in torch — equal
to the JAX package's constant-folded value at every integer rate — and
pinned for the default 45.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# Phred bounds used for emitted qualities: htslib caps printable quals at 93
# ('~'); 2 ('#') is the conventional no-call / minimum quality.
MAX_PHRED = 93.0
MIN_PHRED = 2.0
NO_CALL_QUAL = 2

#: float32(1 / log(10)), the factor jnp.log10 multiplies by
INV_LN10 = float(np.float32(0.4342944819032518))

#: integer quals 0..TABLE_QUALS-1 index the log-likelihood table
TABLE_QUALS = 512

#: the JAX package's jitted log-likelihood tables, float32 [94, 512, 2]:
#: row r is post-UMI rate r
POST_UMI_TABLES_FILE = Path(__file__).with_name("log_tables_post_umi.npy")
#: integer post-UMI rates 0..PINNED_POST_UMI_RATES-1 read their table from it
PINNED_POST_UMI_RATES = 94
#: the pre-UMI rate whose probability is pinned (the default, and the
#: reference's hard-coded --error-rate-pre-umi)
PINNED_PRE_UMI = 45.0

#: float32 bits of phred_to_prob(45) = 10^-4.5 as the JAX package computes it
_PRE_UMI_45_BITS = 0x3804A2B3
PRE_UMI_45_PROB = np.array([_PRE_UMI_45_BITS], np.uint32).view(np.float32)[0]


def phred_to_prob(q):
    """Error probability for a Phred score: 10^(-q/10)."""
    q = torch.as_tensor(q, dtype=torch.float32)
    return torch.pow(torch.tensor(10.0, dtype=torch.float32, device=q.device), -q / 10.0)


def prob_to_phred(p, min_q: float = MIN_PHRED, max_q: float = MAX_PHRED):
    """Phred score for an error probability, clamped to [min_q, max_q].

    log10 is written as log(p) * float32(1 / log(10)): jnp.log10 lowers to
    exactly that product, so the result rounds the same."""
    p = torch.clamp(torch.as_tensor(p, dtype=torch.float32), 1e-12, 1.0)
    return torch.clamp(-10.0 * (torch.log(p) * INV_LN10), min_q, max_q)


def prob_error_two_trials(p1, p2):
    """Probability the final base is wrong after two independent error
    processes with per-trial error probabilities p1 then p2.

    Exactly one trial errs -> wrong; both err -> wrong unless the second error
    lands back on the original base (1/3 chance under a uniform substitution
    model): p1(1-p2) + (1-p1)p2 + (2/3)p1p2.
    """
    p1 = torch.as_tensor(p1, dtype=torch.float32)
    p2 = torch.as_tensor(p2, dtype=torch.float32, device=p1.device)
    return p1 * (1.0 - p2) + (1.0 - p1) * p2 + (2.0 / 3.0) * p1 * p2


def adjust_quals_post_umi(quals, error_rate_post_umi):
    """Fold the post-UMI error prior into raw base qualities (two
    independent error processes)."""
    p = phred_to_prob(quals)
    p_post = phred_to_prob(torch.tensor(float(error_rate_post_umi), device=p.device))
    return prob_error_two_trials(p, p_post)


def log_likelihoods(p_err):
    """(log P[obs | true==obs], log P[obs | true!=obs]) per observation."""
    p_err = torch.clamp(p_err, 1e-12, 1.0 - 1e-7)
    return torch.log1p(-p_err), torch.log(p_err / 3.0)


_TABLES: dict = {}
_PINNED: np.ndarray | None = None


def pinned_post_umi_tables() -> np.ndarray:
    """The read-only float32 [94, 512, 2] pinned tables (loaded once)."""
    global _PINNED
    if _PINNED is None:
        tables = np.load(POST_UMI_TABLES_FILE)
        if tables.shape != (PINNED_POST_UMI_RATES, TABLE_QUALS, 2) or tables.dtype != np.float32:
            raise ValueError(f"{POST_UMI_TABLES_FILE.name}: {tables.dtype} {tables.shape}")
        tables.setflags(write=False)
        _PINNED = tables
    return _PINNED


def log_table(error_rate_post_umi: float, device) -> torch.Tensor:
    """float32 [512, 2] (log_ok, log_err) for integer quals 0..511 on
    `device`: the pinned JAX bits at an integer rate 0..93, else computed
    in torch at first use (a few ulps off the JAX package's on some
    quals). Cached per (rate, device)."""
    device = torch.device(device)
    rate = float(error_rate_post_umi)
    key = (rate, str(device))
    table = _TABLES.get(key)
    if table is None:
        if rate.is_integer() and 0 <= rate < PINNED_POST_UMI_RATES:
            host = torch.from_numpy(pinned_post_umi_tables()[int(rate)].copy())
        else:
            q = torch.arange(TABLE_QUALS, dtype=torch.float32)
            host = torch.stack(
                log_likelihoods(adjust_quals_post_umi(q, rate)), dim=-1
            )
        table = _TABLES[key] = host.to(device).contiguous()
    return table


def pre_umi_prob(error_rate_pre_umi: float) -> float:
    """phred_to_prob(error_rate_pre_umi) as a float32 value: pinned at 45,
    computed in torch otherwise."""
    if float(error_rate_pre_umi) == PINNED_PRE_UMI:
        return float(PRE_UMI_45_PROB)
    return float(phred_to_prob(float(error_rate_pre_umi)))
