"""The consensus vote kernels for Hopper: build, bind, launch — and their
plain PyTorch versions.

Replaces the JAX package's ops/pallas_vote.py (its only two Pallas
kernels). The CUDA source is csrc/vote.cu; it is compiled by nvcc for
sm_90a into build/torch_kernels/libbsseq_vote.so (or the directory
BSSEQ_TPU_COMPILE_CACHE_DIR names: utils.compilecache) at first use, from
the sources in this checkout alone, and bound with ctypes.

* seg_vote — the fused segmented column vote. Counterpart of _vote_kernel
  (column_vote_groups; pallas_call at ops/pallas_vote.py:277) and of
  _finalize_kernel (vote_finalize_groups; pallas_call at
  ops/pallas_vote.py:217) together with the XLA segment sum in front of
  it. A persistent grid streams the rows through a ring of shared-memory
  stages filled by 1-D TMA copies; each thread owns 8 contiguous cells of
  one segment (2 cells of every segment in a unit whose rows run deep),
  adds the segment's rows in row order with the terms built once per
  resident block from the pinned 512 x 2 log-likelihood table, finalizes
  in registers and writes base, qual, depth and errors once as
  8/8/16/16-byte vectors. Bound: device memory (3 B read per observation
  cell, 6 B written per output cell; the arithmetic is a few adds per
  cell). Every layout of the slice is one launch: molecular packed (ragged
  offsets, 2 planes), duplex packed (2-row segments, 1 plane) and padded
  (offsets k * T). It takes W % 16 == 0 and 16-byte aligned tensors and
  raises on anything else (the path's windows are multiples of 32).
* seg_vote_partials — seg_vote's partials mode: the same launch writes
  the in-order sums, the per-base counts and the depth and skips the
  finalize (the deep route's template-axis split over a mesh,
  parallel.deep_family, adds the shards' partials in rank order and
  finalizes the sums with vote_finalize). Plain twin:
  models.molecular.vote_partials_segments.
* vote_finalize — the finalize alone over summed log-likelihoods
  (_finalize_kernel's counterpart): one column per thread, one
  128-thread block per 128 columns. Bound: device memory (20 B read, 2 B
  written per column). The singleton path's single-observation tables
  (ops.reconstruct.qual_tables) run through it.

Beside each kernel: its plain PyTorch version (seg_vote_plain,
vote_finalize_plain) and a launch counter (LAUNCHES); SEG_VOTE_SHAPES
counts seg_vote's launches by (N, P, W, S). A wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises — there is no fallback.

Numbers: the plain versions are bit-equal to the JAX package's XLA legs
on the CPU (tests/test_torch_vote.py). On the card the log-likelihood
sums are bit-identical to the plain version by construction (same table
bits, same add order, -fmad=false); base, depth and errors agree outside
the tie band, and chip_smoke.py requires every qual equal too (every run
on the card has logged 0 differing quals).

A bounds-checked debug build of the same source
(use_bounds_checked_build(True): -DBSSEQ_VOTE_BOUNDS_CHECK -lineinfo,
into build/torch_kernels/libbsseq_vote_debug.so) traps on any row,
offset, segment, shared-memory stage, output cell or TMA address outside
its tensor; the release build compiles those checks to nothing.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import phred
from bsseqconsensusreads_tpu_torch.utils import compilecache

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "vote.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libbsseq_vote.so"
DEBUG_LIBRARY = BUILD_DIR / "libbsseq_vote_debug.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
#: the bounds-checked debug build's extra flags
DEBUG_FLAGS = ("-DBSSEQ_VOTE_BOUNDS_CHECK", "-lineinfo")

#: launches of each kernel — one added where the wrapper launches, nowhere
#: else; callers reset entries to 0 around the run they measure
LAUNCHES = {"seg_vote": 0, "seg_vote_partials": 0, "vote_finalize": 0}
#: seg_vote launches by (N, P, W, S) — counted with LAUNCHES, reset with it
SEG_VOTE_SHAPES: collections.Counter = collections.Counter()
#: launches by (kernel, tag) for launches made under launch_tag — counted
#: with LAUNCHES, reset with it
TAGGED_LAUNCHES: collections.Counter = collections.Counter()

_libs: dict = {}
_debug = False
#: one build and load at a time, and exact launch counts, when the
#: overlap workers launch from several threads
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_TAG = threading.local()


class KernelError(RuntimeError):
    """The vote kernels did not build, load or launch. Never retried or
    degraded (faults.retry.fatal): the run fails."""


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the vote kernels build on a machine with the CUDA toolkit")


def build(verbose: bool = False, debug: bool = False) -> Path:
    """Compile csrc/vote.cu into LIBRARY (DEBUG_LIBRARY with DEBUG_FLAGS
    when `debug`) unless a build of the same source and flags is already
    there. Returns the library path. With BSSEQ_TPU_COMPILE_CACHE_DIR set
    the library lives there (utils.compilecache: a found build counts as a
    hit, an nvcc run as a miss); the build holds a file lock, so processes
    that start together compile once."""
    library = compilecache.build_dir(BUILD_DIR) / (DEBUG_LIBRARY if debug else LIBRARY).name
    flags = NVCC_FLAGS + (DEBUG_FLAGS if debug else ())
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    stamp = library.with_name(library.name + ".sha256")

    def fresh() -> bool:
        return library.exists() and stamp.exists() and stamp.read_text() == digest

    if fresh():
        compilecache.record(hit=True)
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    with open(library.with_name(library.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if fresh():  # another process built it while this one waited
            compilecache.record(hit=True)
            return library
        tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose and proc.stderr:
            print(proc.stderr, end="")
        os.replace(tmp, library)
        stamp_tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}.tmp")
        stamp_tmp.write_text(digest)
        os.replace(stamp_tmp, stamp)
    compilecache.record(hit=False)
    return library


def use_bounds_checked_build(on: bool) -> None:
    """Launch the kernels from the bounds-checked debug build (True) or
    the release build (False, the default) from now on in this process."""
    global _debug
    _debug = bool(on)


def _load():
    """The selected build with its C signatures declared (pointers and the
    stream as c_void_p), loaded once per process and build."""
    lib = _libs.get(_debug)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _libs.get(_debug)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(str(build(debug=_debug)))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bsseq_seg_vote.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ci, cf, cf, vp, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.bsseq_seg_vote.restype = ci
        lib.bsseq_vote_finalize.argtypes = [vp, vp, ci, cf, cf, vp, vp, vp]
        lib.bsseq_vote_finalize.restype = ci
        _libs[_debug] = lib
    return lib


def _check_cuda(*tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"vote kernels take CPU or CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("vote kernels take contiguous tensors")


def _check_aligned(**tensors) -> None:
    """The kernels copy and load these in 16-byte units: refuse, never copy."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (data_ptr {t.data_ptr():#x})")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} launch failed: cudaError {rc}")


def _check_seg_vote(bases, quals, offsets) -> tuple[int, int, int, int]:
    """seg_vote's refusals on CUDA tensors; returns (N, P, W, S)."""
    _check_cuda(bases, quals, offsets)
    if bases.dtype != torch.int8 or quals.dtype != torch.int16:
        raise ValueError(f"seg_vote takes int8 bases / int16 quals, got {bases.dtype}/{quals.dtype}")
    if offsets.dtype != torch.int32 or bases.dim() != 3 or quals.shape != bases.shape:
        raise ValueError("seg_vote takes [N, P, W] planes and int32 offsets")
    n, p, w = bases.shape
    s = offsets.numel() - 1
    if w % 16:
        raise ValueError(f"seg_vote takes W % 16 == 0, got W = {w}")
    if n * p * w >= 2**31 or s * p * w >= 2**31:
        raise ValueError(f"seg_vote takes < 2**31 cells, got [{n}, {p}, {w}] x {s}")
    _check_aligned(bases=bases, quals=quals)
    return n, p, w, s


def seg_vote(bases, quals, offsets, params: ConsensusParams,
             with_ll: bool = False) -> dict:
    """The segmented vote: rows offsets[s]:offsets[s+1] of every plane vote
    column by column.

    bases int8 [N, P, W] (NBASE = no observation), quals int16 [N, P, W]
    integer Phreds in 0..511 (already co-called), offsets int32 [S + 1]
    ascending row offsets. Returns {base int8, qual uint8, depth int16,
    errors int16} of [S, P, W], plus ll float32 [S, P, W, 4] when
    with_ll. CPU tensors take seg_vote_plain; CUDA tensors launch
    bsseq_seg_vote."""
    if bases.device.type == "cpu":
        return seg_vote_plain(bases, quals, offsets, params, with_ll)
    n, p, w, s = _check_seg_vote(bases, quals, offsets)
    dev = bases.device
    table = phred.log_table(params.error_rate_post_umi, dev)
    out = {
        "base": torch.empty((s, p, w), dtype=torch.int8, device=dev),
        "qual": torch.empty((s, p, w), dtype=torch.uint8, device=dev),
        "depth": torch.empty((s, p, w), dtype=torch.int16, device=dev),
        "errors": torch.empty((s, p, w), dtype=torch.int16, device=dev),
    }
    if with_ll:
        out["ll"] = torch.empty((s, p, w, 4), dtype=torch.float32, device=dev)
    if s * p * w == 0:
        return out
    rc = _load().bsseq_seg_vote(
        bases.data_ptr(), quals.data_ptr(), offsets.data_ptr(), table.data_ptr(),
        n, s, p, w, int(params.min_input_base_quality),
        float(params.min_consensus_base_quality),
        phred.pre_umi_prob(params.error_rate_pre_umi),
        out["base"].data_ptr(), out["qual"].data_ptr(),
        out["depth"].data_ptr(), out["errors"].data_ptr(),
        out["ll"].data_ptr() if with_ll else None, None, None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "bsseq_seg_vote")
    _count("seg_vote", (n, p, w, s))
    return out


def seg_vote_partials(bases, quals, offsets, params: ConsensusParams):
    """seg_vote's partials mode: the in-order segment sums without the
    finalize — (ll float32 [S, P, W, 4], cnt float32 [S, P, W, 4] per-base
    counts, depth int32 [S, P, W]), what a reads shard of the deep route's
    template-axis split contributes (parallel.deep_family). Same inputs and
    refusals as seg_vote. CPU tensors take the plain twin
    (models.molecular.vote_partials_segments); CUDA tensors launch
    bsseq_seg_vote with its partials outputs."""
    from bsseqconsensusreads_tpu_torch.models.molecular import vote_partials_segments

    if bases.device.type == "cpu":
        return vote_partials_segments(bases, quals, offsets, params)
    n, p, w, s = _check_seg_vote(bases, quals, offsets)
    dev = bases.device
    table = phred.log_table(params.error_rate_post_umi, dev)
    ll = torch.empty((s, p, w, 4), dtype=torch.float32, device=dev)
    cnt = torch.empty((s, p, w, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((s, p, w), dtype=torch.int32, device=dev)
    if s * p * w == 0:
        return ll, cnt, depth
    rc = _load().bsseq_seg_vote(
        bases.data_ptr(), quals.data_ptr(), offsets.data_ptr(), table.data_ptr(),
        n, s, p, w, int(params.min_input_base_quality),
        float(params.min_consensus_base_quality),
        phred.pre_umi_prob(params.error_rate_pre_umi),
        None, None, None, None, ll.data_ptr(), cnt.data_ptr(), depth.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "bsseq_seg_vote (partials)")
    _count("seg_vote_partials", (n, p, w, s))
    return ll, cnt, depth


def _count(kernel: str, shape=None) -> None:
    """One launch of `kernel` (and of its shape for seg_vote), and one
    under the calling thread's launch tag when one is set."""
    tag = getattr(_TAG, "name", None)
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
        if kernel == "seg_vote":
            SEG_VOTE_SHAPES[shape] += 1
        if tag is not None:
            TAGGED_LAUNCHES[(kernel, tag)] += 1


@contextlib.contextmanager
def launch_tag(name: str):
    """Count this thread's launches inside the block also under `name` in
    TAGGED_LAUNCHES (the mesh's per-shard launches: parallel.sharding)."""
    prev = getattr(_TAG, "name", None)
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = prev


def seg_vote_plain(bases, quals, offsets, params: ConsensusParams,
                   with_ll: bool = False) -> dict:
    """seg_vote in plain PyTorch (any device): the in-order segment sum
    (models.molecular.vote_partials_segments), the finalize and the count
    trick — the JAX package's packed XLA leg term for term."""
    from bsseqconsensusreads_tpu_torch.models.molecular import (
        errors_from_counts,
        vote_finalize,
        vote_partials_segments,
    )

    ll, cnt, depth = vote_partials_segments(bases, quals, offsets, params)
    base, qual = vote_finalize(ll, depth, params)
    out = {
        "base": base,
        "qual": qual,
        "depth": depth.to(torch.int16),
        "errors": errors_from_counts(cnt, depth, base).to(torch.int16),
    }
    if with_ll:
        out["ll"] = ll
    return out


def vote_finalize(ll, depth, params: ConsensusParams):
    """Finalize summed log-likelihoods: ll float32 [..., W, 4], depth int32
    [..., W] -> (base int8, qual uint8) [..., W]. CPU tensors take
    vote_finalize_plain; CUDA tensors launch bsseq_vote_finalize."""
    if ll.device.type == "cpu":
        return vote_finalize_plain(ll, depth, params)
    if ll.dtype != torch.float32 or depth.dtype != torch.int32:
        raise ValueError(f"vote_finalize takes float32 ll / int32 depth, got {ll.dtype}/{depth.dtype}")
    if ll.shape[-1] != 4 or ll.shape[:-1] != depth.shape:
        raise ValueError(f"ll {tuple(ll.shape)} does not match depth {tuple(depth.shape)}")
    _check_cuda(ll, depth)
    _check_aligned(ll=ll)
    if depth.numel() >= 2**31:
        raise ValueError(f"vote_finalize takes < 2**31 columns, got {depth.numel()}")
    dev = ll.device
    base = torch.empty(depth.shape, dtype=torch.int8, device=dev)
    qual = torch.empty(depth.shape, dtype=torch.uint8, device=dev)
    if depth.numel() == 0:
        return base, qual
    rc = _load().bsseq_vote_finalize(
        ll.data_ptr(), depth.data_ptr(), depth.numel(),
        float(params.min_consensus_base_quality),
        phred.pre_umi_prob(params.error_rate_pre_umi),
        base.data_ptr(), qual.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "bsseq_vote_finalize")
    _count("vote_finalize")
    return base, qual


def vote_finalize_plain(ll, depth, params: ConsensusParams):
    """vote_finalize in plain PyTorch (models.molecular.vote_finalize)."""
    from bsseqconsensusreads_tpu_torch.models.molecular import (
        vote_finalize as finalize,
    )

    return finalize(ll, depth, params)
