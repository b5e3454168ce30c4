#!/usr/bin/env python3
"""Drop-in consensus filtering stage.

The port's twin of tools/filter_consensus_reads_tpu.py, with fgbio
FilterConsensusReads semantics:

    fgbio FilterConsensusReads -i molecular.bam -o filtered.bam --min-reads 3
becomes
    python bsseqconsensusreads_tpu_torch/tools/filter_consensus_reads_tpu.py \\
        -i molecular.bam -o filtered.bam -M 3

Depth units: raw-read floors (-M 3 ...) apply to MOLECULAR consensus
output, whose cd tag is raw depth; the duplex stage's cd/ad/bd count
strand presence, so against duplex output use `-M 2 1 1`.

Arguments: those of `python -m bsseqconsensusreads_tpu_torch
filter-consensus`. The filter is host code; --device cuda|cpu is accepted
for the rule shape and moves nothing.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _dropin import run_dropin  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(run_dropin("filter-consensus", sys.argv[1:]))
