"""PyTorch/CUDA port of bsseqconsensusreads_tpu for NVIDIA Hopper.

Module names follow the JAX package, so each counterpart is found under
the same path. The port imports torch and numpy, never jax nor any module
of the JAX package. Its two hand-written kernels live in csrc/vote.cu
(built at first use, see ops/cuda_vote.py). Entry points run on the card
unless the caller passes device='cpu'.
"""

__version__ = "0.1.0"
