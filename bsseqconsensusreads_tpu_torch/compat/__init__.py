"""Interop layer: run third-party pysam scripts on the port's io stack (no
pysam or htslib needed).

The port's counterpart of the JAX package's compat/: the golden
differential tests run the reference's own tools (pure Python + pysam)
through this shim against synthetic BAMs and diff their records against
the port's transforms.
"""

from bsseqconsensusreads_tpu_torch.compat.pysam_shim import install_shim
from bsseqconsensusreads_tpu_torch.compat.refrunner import run_pysam_script

__all__ = ["install_shim", "run_pysam_script"]
