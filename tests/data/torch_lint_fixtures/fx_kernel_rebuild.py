"""graftlint fixture: kernel-rebuild — one seeded violation.

A library built and loaded inside the loop pays nvcc (or at least the
load) once per iteration; the same load behind a module-level cache
stays clean.
"""

import ctypes
import subprocess

_LIBS = {}


def _nvcc():
    return "/usr/local/cuda/bin/nvcc"


def fx_rebuild_each(sources):
    libs = []
    for src in sources:
        subprocess.run([_nvcc(), "-shared", "-o", src + ".so", src])  # seeded: kernel-rebuild
        libs.append(src + ".so")
    return libs


def fx_cached_load(path):
    lib = _LIBS.get(path)
    if lib is None:
        for _attempt in range(2):
            lib = _LIBS[path] = ctypes.CDLL(path)
    return lib
