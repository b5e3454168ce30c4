"""Consensus error-model parameters.

The reference hardcodes these numbers in Snakemake rule bodies
(reference: main.snake.py:54,163); this framework promotes them to config
(SURVEY.md §5.6). Defaults reproduce the reference's exact flag values:

  --error-rate-pre-umi=45 --error-rate-post-umi=30
  --min-input-base-quality=0 --min-consensus-base-quality=0
  --consensus-call-overlapping-bases=true
  --min-reads=1 (molecular, main.snake.py:54) / 0 (duplex, main.snake.py:163)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ConsensusParams:
    """Hashable (a cache key for the log tables) consensus parameter set."""

    error_rate_pre_umi: float = 45.0
    error_rate_post_umi: float = 30.0
    min_input_base_quality: int = 0
    min_consensus_base_quality: int = 0
    consensus_call_overlapping_bases: bool = True
    min_reads: int = 1

    def replace(self, **kw) -> "ConsensusParams":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_reference(cls, obj) -> "ConsensusParams":
        """The port's parameters from the JAX package's ConsensusParams,
        or from its dataclasses.asdict — the one piece of state carried
        across packages (genome and reads are plain numpy on both sides).
        Unknown fields raise: a parameter the port does not model must not
        be dropped silently."""
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            obj = dataclasses.asdict(obj)
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - names
        if unknown:
            raise ValueError(f"unknown consensus parameters: {sorted(unknown)}")
        return cls(**dict(obj))


MOLECULAR_DEFAULTS = ConsensusParams(min_reads=1)
DUPLEX_DEFAULTS = ConsensusParams(min_reads=0)
