"""The JAX package's native libraries, built before any other test module
is collected.

pytest collects a directory's modules in name order, and this module's
name sorts first. Its import runs `ensure_reference_natives`, which
builds native/libbamio.so and native/libwirepack.so under a file lock
into a directory of its own and renames them into native/. So in every
pytest-xdist worker, each JAX-package test module that loads one of them
at import finds it whole. Without this, workers collecting at once each
ran that package's loader, which builds a missing library in place, and
a worker could load a file another worker's linker was still writing
("file too short") and skip that module's tests."""

import importlib
import os

import pytest

from bsseqconsensusreads_tpu_torch.utils.testing import (
    REFERENCE_NATIVES,
    ensure_reference_natives,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:  # at import, so before the modules collected after this one
    ensure_reference_natives(REPO)
    BUILD_ERROR = None
except RuntimeError as exc:
    BUILD_ERROR = str(exc)


@pytest.mark.parametrize("so", sorted(REFERENCE_NATIVES))
def test_reference_native_loads_whole(so):
    assert BUILD_ERROR is None, BUILD_ERROR
    loader = importlib.import_module(REFERENCE_NATIVES[so])
    assert loader.available(), loader.load_error()
