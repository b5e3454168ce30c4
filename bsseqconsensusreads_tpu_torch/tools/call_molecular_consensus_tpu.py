#!/usr/bin/env python3
"""Drop-in molecular-consensus stage on the card.

The port's twin of tools/call_molecular_consensus_tpu.py: it replaces
`fgbio CallMolecularConsensusReads` in the reference's first rule
(main.snake.py:46-55) with the same I/O shape:

    rule call_consensus_reads_molecular:
        input:  "input/{s}.bam"            # GroupReadsByUmi -s Paired output
        output: "output/{s}_unalignedConsensus_molecular.bam"
        shell:
            "{python3} bsseqconsensusreads_tpu_torch/tools/call_molecular_consensus_tpu.py "
            "-i {input} -o {output}"

Arguments: those of `python -m bsseqconsensusreads_tpu_torch molecular`,
--device cuda (default) or cpu included.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _dropin import run  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(run("molecular", sys.argv[1:]))
