"""The single definition of the base alphabet used across the framework.

A C G T = 0..3 are vote candidates; N = 4 means "no observation" (pad, N call,
or no coverage). Every module (host encoders, JAX kernels, oracles) imports
these — never redefine them locally.
"""

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
NBASE = N
NUM_BASES = 4  # N is not a vote candidate

# char byte -> code (lowercase folded; anything else -> N)
BASE_CODE = np.full(256, NBASE, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    BASE_CODE[_b] = _i
    BASE_CODE[_b + 32] = _i
# code -> char byte
BASE_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

COMPLEMENT = np.array([T, G, C, A, N], dtype=np.int8)
