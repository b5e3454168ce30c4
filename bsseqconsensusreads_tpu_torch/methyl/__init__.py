"""Methylation extraction fused into the duplex stage.

The port of the JAX package's methyl/ subsystem: per-column methylation
calls fall out of the duplex vote as an epilogue on the same batch
(methyl.context), per-batch tallies reduce through a spill accumulator
keyed by global genome offset (methyl.tally), and the merged tallies are
written as bedMethyl and a CX cytosine report (methyl.emit). The
epilogue reads the RAW pre-conversion planes, so it is the same for
bisulfite and EM-seq libraries; chemistry 'none' is refused upstream.
"""

from bsseqconsensusreads_tpu_torch.methyl.context import (  # noqa: F401
    CTX_NAMES,
    CTX_NONE,
    methyl_epilogue,
    methyl_epilogue_host,
    methyl_wire_words,
    unpack_methyl_planes,
)
from bsseqconsensusreads_tpu_torch.methyl.tally import (  # noqa: F401
    MethylAccumulator,
    extract_tallies,
    merge_tallies,
)
