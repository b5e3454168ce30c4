"""Build-on-first-use loader for the port's host C++ libraries.

io.native (libbsseq_bamio: the BGZF/BAM codec, columnar ingest, the C
MI grouper, the encode scans and fills, the k-way run merge) and
io.wirepack (libbsseq_wirepack: the batch record emit, the raw-record
sort, the duplex rawize and strand calls) share this scaffold. Each
library compiles with g++ from the port's own sources in csrc/host/ into
build/torch_kernels/ (or BSSEQ_TPU_COMPILE_CACHE_DIR, utils.compilecache)
at first use, with the flags of the JAX package's
native/Makefile, and is rebuilt when its source or flags change (a sha256
stamp beside it). The build holds a file lock, so concurrent first uses
in several processes build once, and lands by tmp file + os.replace, so
no process ever loads a half-written library.

A library that does not build or load raises NativeLibraryError with the
compiler's or loader's message. Nothing degrades to a Python engine
behind the caller's back: the Python engines are chosen by name. The
`native_load` failpoint fires before the first load of each library in
a process and raises NativeLibraryError too (the JAX package falls back
to its Python codec there; the port has no fallback). Loads are locked:
the overlap and host pools' workers may race to the first use.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

from bsseqconsensusreads_tpu_torch.utils import compilecache

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

#: the C++ compiler; tests point it at a missing path to prove a failed
#: build raises
COMPILER = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


@dataclass(frozen=True)
class HostLibrary:
    source: str
    library: str
    compile_flags: tuple[str, ...] = ()
    link_flags: tuple[str, ...] = ()

    @property
    def source_path(self) -> Path:
        return SOURCE_DIR / self.source

    @property
    def path(self) -> Path:
        return compilecache.build_dir(BUILD_DIR) / self.library


LIBRARIES = {
    "bamio": HostLibrary("bamio.cpp", "libbsseq_bamio.so", ("-pthread",), ("-lz",)),
    "wirepack": HostLibrary("wirepack.cpp", "libbsseq_wirepack.so"),
}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


class NativeLibraryError(OSError):
    """A host library did not build or load. `stderr` holds the
    compiler's (or the loader's) message."""

    def __init__(self, library: str, what: str, stderr: str = ""):
        msg = f"{library}: {what}"
        if stderr:
            msg = f"{msg}\n{stderr.rstrip()}"
        super().__init__(msg)
        self.library = library
        self.stderr = stderr


def _command(lib: HostLibrary, out: Path) -> list[str]:
    return [COMPILER, *CXX_FLAGS, *lib.compile_flags, "-o", str(out),
            str(lib.source_path), *lib.link_flags]


def _digest(lib: HostLibrary) -> str:
    flags = " ".join(_command(lib, Path("out"))[1:])
    return hashlib.sha256(lib.source_path.read_bytes() + flags.encode()).hexdigest()


def build(name: str, force: bool = False) -> Path:
    """Compile the named library unless a build of the same source and
    flags is already there (force: rebuild regardless). Returns its path."""
    lib = LIBRARIES[name]
    digest = _digest(lib)
    stamp = lib.path.with_name(lib.path.name + ".sha256")

    def fresh() -> bool:
        return (not force and lib.path.exists() and stamp.exists()
                and stamp.read_text() == digest)

    if fresh():
        compilecache.record(hit=True)
        return lib.path
    lib.path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.path.with_name(lib.path.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if fresh():  # another process built it while this one waited
            compilecache.record(hit=True)
            return lib.path
        if shutil.which(COMPILER) is None:
            raise NativeLibraryError(
                lib.library, f"compiler {COMPILER!r} not found; the host "
                f"libraries build from {SOURCE_DIR} with g++ and zlib")
        tmp = lib.path.with_name(f"{lib.path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(_command(lib, tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeLibraryError(
                lib.library, f"{COMPILER} failed ({proc.returncode})", proc.stderr)
        os.replace(tmp, lib.path)
        stamp_tmp = stamp.with_name(f"{stamp.name}.{os.getpid()}.tmp")
        stamp_tmp.write_text(digest)
        os.replace(stamp_tmp, stamp)
    compilecache.record(hit=False)
    return lib.path


def load(name: str, required_symbols: tuple[str, ...]) -> ctypes.CDLL:
    """The named library, built if needed and loaded once per process. A
    library lacking one of `required_symbols` (a stale build) is rebuilt
    once; if it still lacks one, or fails to load, NativeLibraryError."""
    cached = _LOADED.get(name)
    if cached is not None:
        return cached
    with _LOAD_LOCK:
        cached = _LOADED.get(name)
        if cached is not None:
            return cached
        return _load_locked(name, required_symbols)


def _load_locked(name: str, required_symbols: tuple[str, ...]) -> ctypes.CDLL:
    from bsseqconsensusreads_tpu_torch.faults import failpoints

    lib = LIBRARIES[name]
    if failpoints.ARMED:
        try:
            failpoints.fire("native_load", so=lib.library)
        except Exception as exc:  # an injected load failure
            raise NativeLibraryError(lib.library, f"failpoint injected: {exc}") from None
    for attempt in range(2):
        path = build(name, force=attempt > 0)
        try:
            handle = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeLibraryError(lib.library, f"cannot load {path}", str(exc)) from None
        missing = [s for s in required_symbols if not hasattr(handle, s)]
        if not missing:
            _LOADED[name] = handle
            return handle
    raise NativeLibraryError(
        lib.library, f"lacks required symbols: {', '.join(missing)}")
