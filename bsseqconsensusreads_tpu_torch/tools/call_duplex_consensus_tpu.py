#!/usr/bin/env python3
"""Drop-in duplex-consensus stage on the card.

The port's twin of tools/call_duplex_consensus_tpu.py: it replaces the
reference's four-rule chain convert_Bstrain -> extend -> groupsort_convert
-> callduplex (main.snake.py:121-164) with one stage, in a Snakemake rule
of the same shape:

    rule callduplex:
        input:  "output/{s}_consensus_unfiltered_aunamerged_aligned.bam"
        output: "output/{s}_..._duplexconsensus.bam"
        shell:
            "{python3} bsseqconsensusreads_tpu_torch/tools/call_duplex_consensus_tpu.py "
            "-i {input} -o {output} --reference {genome}"

It writes the same unfiltered duplex consensus BAM with RX/MI tags.
Arguments: those of `python -m bsseqconsensusreads_tpu_torch duplex`,
--device cuda (default) or cpu included.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _dropin import run  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(run("duplex", sys.argv[1:]))
