"""The kernel build cache: the BSSEQ_TPU_COMPILE_CACHE_DIR knob.

The port's counterpart of the JAX package's utils/compilecache.py. There a
cold process pays XLA compilation for every kernel shape and the knob
points jax's persistent compilation cache at a shared directory. Here the
compiled capital is the kernel libraries a process builds at first use:
csrc/vote.cu with nvcc (ops.cuda_vote) and the host libraries of
csrc/host with g++ (io._nativelib), written to build/torch_kernels/ beside
the package. With BSSEQ_TPU_COMPILE_CACHE_DIR set they are built into and
loaded from that directory instead, so a later process — a serve replica
spawned after the first, a rerun of `molecular` — loads the first one's
builds: each build holds a file lock and re-checks the source digest
stamp after taking it, so replicas that start together build once.

Accounting, as in the JAX package: while enabled (`maybe_enable`, called
by the CLI entry point and the serve engine), every library a build step
found already built (no nvcc / g++ run) counts as a hit and every build
as a miss; `publish(metrics)` books the unpublished delta into a stage's
counters as `compile_cache_hit` / `compile_cache_miss`, so a ledger shows
that a replica reused the cache (hit > 0, miss == 0). A no-op while the
variable is unset.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

ENV_DIR = "BSSEQ_TPU_COMPILE_CACHE_DIR"

_LOCK = threading.Lock()
_STATE = {"enabled": False, "hits": 0, "misses": 0,
          "published_hits": 0, "published_misses": 0}


def build_dir(default: Path) -> Path:
    """Where kernel libraries are built and loaded: the cache directory
    when BSSEQ_TPU_COMPILE_CACHE_DIR is set, else `default`."""
    directory = os.environ.get(ENV_DIR)
    return Path(directory) if directory else Path(default)


def maybe_enable() -> str | None:
    """Start tallying hits and misses when BSSEQ_TPU_COMPILE_CACHE_DIR is
    set (the directory is created). Idempotent; returns the directory, or
    None when the knob is unset."""
    directory = os.environ.get(ENV_DIR) or None
    if directory is None:
        return None
    os.makedirs(directory, exist_ok=True)
    with _LOCK:
        _STATE["enabled"] = True
    return directory


def enabled() -> bool:
    with _LOCK:
        return _STATE["enabled"]


def record(hit: bool) -> None:
    """One build step's outcome: a library found built (hit) or built
    (miss). Counted only while enabled."""
    with _LOCK:
        if _STATE["enabled"]:
            _STATE["hits" if hit else "misses"] += 1


def counts() -> tuple[int, int]:
    """(hits, misses) tallied so far in this process."""
    with _LOCK:
        return _STATE["hits"], _STATE["misses"]


def publish(metrics) -> None:
    """Book the unpublished hit/miss delta into `metrics` counters
    (compile_cache_hit / compile_cache_miss); a no-op while disabled."""
    with _LOCK:
        if not _STATE["enabled"]:
            return
        dh = _STATE["hits"] - _STATE["published_hits"]
        dm = _STATE["misses"] - _STATE["published_misses"]
        _STATE["published_hits"] = _STATE["hits"]
        _STATE["published_misses"] = _STATE["misses"]
    metrics.count("compile_cache_hit", dh)
    metrics.count("compile_cache_miss", dm)
