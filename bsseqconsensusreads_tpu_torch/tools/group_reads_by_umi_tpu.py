#!/usr/bin/env python3
"""Drop-in UMI grouping stage.

The port's twin of tools/group_reads_by_umi_tpu.py. The reference's input
must already be `fgbio GroupReadsByUmi -s Paired` output; this produces
that contract from a raw aligned BAM with RX tags:

    fgbio GroupReadsByUmi -s Paired -e 1 -i aligned.bam -o grouped.bam
becomes
    python bsseqconsensusreads_tpu_torch/tools/group_reads_by_umi_tpu.py \\
        -s paired -e 1 -i aligned.bam -o grouped.bam

Arguments: those of `python -m bsseqconsensusreads_tpu_torch group`. The
grouping is host code; --device cuda|cpu is accepted for the rule shape
and moves nothing.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _dropin import run_dropin  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(run_dropin("group", sys.argv[1:]))
