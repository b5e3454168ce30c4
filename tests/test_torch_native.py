"""The port's host C++ libraries: where they build and load from, what a
failed build does, concurrent first builds, the BGZF codec against the
JAX package's, and the C record-path sweeps against their Python twins.

The libraries need only g++ and zlib, so they build (from csrc/host/ into
build/torch_kernels/) and run in the CPU tests too."""

import os
import subprocess
import sys

import numpy as np
import pytest

from bsseqconsensusreads_tpu.io import native as jnative
from bsseqconsensusreads_tpu_torch.io import _nativelib, bam, native, wirepack
from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamReader, BamWriter, RawRecords
from bsseqconsensusreads_tpu_torch.io.bgzf import BgzfWriter
from bsseqconsensusreads_tpu_torch.models import molecular
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import hosttwin
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline import extsort as te
from bsseqconsensusreads_tpu_torch.pipeline import stages
from test_torch_pipeline import _port_chain, _sha, grouped_env, mixture_env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_libraries_load_from_the_build_dir_and_never_from_native():
    # a fresh process: nothing of the JAX package or jax is loaded, and
    # the mapped libraries are the port's builds
    code = r"""
import sys
sys.modules["jax"] = None
from bsseqconsensusreads_tpu_torch.io import native, wirepack
native.lib(); wirepack.lib()
maps = open("/proc/self/maps").read()
paths = sorted({l.split()[-1] for l in maps.splitlines() if ".so" in l.split()[-1]})
print("\n".join(paths))
bad = [m for m in sys.modules if m == "bsseqconsensusreads_tpu" or m.startswith(("bsseqconsensusreads_tpu.", "jax."))]
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
    paths = out.stdout.split()
    build = os.path.join(REPO, "build", "torch_kernels")
    for so in ("libbsseq_bamio.so", "libbsseq_wirepack.so"):
        assert os.path.join(build, so) in paths, paths
    assert not [p for p in paths if p.startswith(os.path.join(REPO, "native") + os.sep)]


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A process state in which the host libraries are neither loaded nor
    built, and the compiler is missing."""
    monkeypatch.setattr(_nativelib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_nativelib, "COMPILER", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_nativelib, "_LOADED", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(wirepack, "_LIB", None)
    return tmp_path


def test_a_failed_build_raises_on_every_entry_point(no_library, grouped_env):
    path = grouped_env["bam"]
    with pytest.raises(_nativelib.NativeLibraryError, match="not found"):
        _nativelib.build("bamio")
    with pytest.raises(_nativelib.NativeLibraryError):
        BamReader(path)
    with pytest.raises(_nativelib.NativeLibraryError):
        BamWriter(str(no_library / "x.bam"), BamHeader())
    with BamReader(path, engine="python") as r:
        st = tc.StageStats()
        # 'auto' does not hand back Python records when the library is broken
        with pytest.raises(_nativelib.NativeLibraryError):
            stages.molecular_ingest_stream(path, r, st, ingest_choice="auto")
        with pytest.raises(_nativelib.NativeLibraryError):
            stages.duplex_ingest_stream(path, r, st, ingest_choice="native")
        with pytest.raises(_nativelib.NativeLibraryError):
            next(tc.call_molecular_batches(r, device="cpu", emit="auto"))
        with pytest.raises(_nativelib.NativeLibraryError):
            te.resolve_sort_engine("auto")
        # the Python engines stay selectable by name
        assert stages.molecular_ingest_stream(path, r, st, ingest_choice="python") is r
        assert te.resolve_sort_engine("python") == "python"
    assert not (no_library / "build" / "libbsseq_bamio.so").exists()


def test_a_compile_error_carries_the_compilers_stderr(no_library, monkeypatch):
    src = no_library / "src"
    src.mkdir()
    (src / "wirepack.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_nativelib, "SOURCE_DIR", src)
    monkeypatch.setattr(_nativelib, "COMPILER", "g++")
    with pytest.raises(_nativelib.NativeLibraryError) as err:
        _nativelib.build("wirepack")
    assert "error" in err.value.stderr and "wirepack.cpp" in err.value.stderr
    assert not list((no_library / "build").glob("*.tmp"))


def test_a_stale_stamp_rebuilds(no_library, monkeypatch):
    monkeypatch.setattr(_nativelib, "COMPILER", "g++")
    lib = _nativelib.build("wirepack")
    stamp = lib.with_name(lib.name + ".sha256")
    first = lib.stat().st_mtime_ns
    assert _nativelib.build("wirepack") == lib and lib.stat().st_mtime_ns == first
    stamp.write_text("stale")
    _nativelib.build("wirepack")
    assert lib.stat().st_mtime_ns != first and stamp.read_text() != "stale"


def test_concurrent_first_builds_build_once_and_all_load(tmp_path):
    code = r"""
import sys
from pathlib import Path
from bsseqconsensusreads_tpu_torch.io import _nativelib
_nativelib.BUILD_DIR = Path(sys.argv[1])
_nativelib.load("wirepack", ("wirepack_sort_raw_records",))
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "libbsseq_wirepack.so", "libbsseq_wirepack.so.lock", "libbsseq_wirepack.so.sha256"]


@pytest.mark.parametrize("threads", [1, 3])
def test_bgzf_writers_match_the_jax_native_writer_byte_for_byte(tmp_path, threads):
    rng = np.random.default_rng(3)
    # ~400 KB over several blocks: text-like runs and incompressible bytes
    payload = (b"ACGT" * 40_000) + rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    port, jax_out, py = (str(tmp_path / n) for n in ("port.gz", "jax.gz", "py.gz"))
    with native.NativeBgzfWriter(port, 6, threads=threads) as w:
        for i in range(0, len(payload), 70_001):
            w.write(payload[i : i + 70_001])
    with jnative.NativeBgzfWriter(jax_out, 6, threads=threads) as w:
        for i in range(0, len(payload), 70_001):
            w.write(payload[i : i + 70_001])
    with BgzfWriter.open(py, 6) as w:
        w.write(payload)
    assert _sha(port) == _sha(jax_out) == _sha(py)
    with native.NativeBgzfReader(port, threads=threads) as r:
        assert r.read(len(payload) + 10) == payload
    with native.NativeBgzfReader(port) as r2, pytest.raises(native.GuardError):
        r2.read(5)  # buffered bytes now stand between the C stream and the caller
        r2.read_unbuffered(5)


def test_bam_engines_read_and_write_the_same_bytes(grouped_env, tmp_path):
    with BamReader(grouped_env["bam"], engine="python") as r:
        header, recs = r.header, list(r)
    out = {}
    for engine in ("python", "native"):
        out[engine] = str(tmp_path / f"{engine}.bam")
        with BamWriter(out[engine], header, engine=engine) as w:
            w.write_all(recs)
        with BamReader(out[engine], engine="native" if engine == "python" else "python") as r:
            assert list(r) == recs
    assert _sha(out["python"]) == _sha(out["native"])
    with pytest.raises(ValueError, match="unknown engine"):
        bam._select_bgzf("pbgzf", None, None)


def test_strand_calls_equal_the_host_twin():
    rng = np.random.default_rng(11)
    f, w = 64, 96
    bases = rng.integers(0, 5, (f, 4, w)).astype(np.int8)
    cover = rng.random((f, 4, w)) < 0.8
    bases[~cover] = 4
    ref = rng.integers(0, 5, (f, w + 1)).astype(np.int8)
    cmask = rng.random((f, 4)) < 0.5
    elig = rng.random(f) < 0.6
    want, _ = hosttwin.strand_call_planes(bases, cover, ref, cmask, elig)
    np.testing.assert_array_equal(wirepack.strand_calls(bases, cover, ref, cmask, elig), want)


@pytest.mark.parametrize("overlap", [True, False])
def test_bcount_sparse_equals_the_numpy_chain(overlap):
    rng = np.random.default_rng(12)
    f, t, w = 32, 4, 64
    bases = rng.integers(0, 5, (f, t, 2, w)).astype(np.int8)
    quals = rng.choice(np.array([2, 12, 23, 37], np.uint8), (f, t, 2, w))
    cons = rng.integers(0, 5, (f, 2, w)).astype(np.int8)
    params = ConsensusParams(min_input_base_quality=10, consensus_call_overlapping_bases=overlap)
    want = molecular.sparsify_base_counts(
        molecular.molecular_base_counts(bases, quals, params), cons)
    np.testing.assert_array_equal(wirepack.bcount_sparse(bases, quals, cons, params), want)


def _blob_stream(path, block):
    """The records of a BAM as RawRecords blocks of `block` records."""
    with BamReader(path) as r:
        blobs = list(r.raw_records())
    return [RawRecords(b"".join(blobs[i : i + block]), len(blobs[i : i + block]))
            for i in range(0, len(blobs), block)]


def test_native_sort_across_run_boundaries_and_merge_passes_is_the_python_sort(
        mixture_env, tmp_path, monkeypatch):
    # 13-record runs cut 5-record RawRecords blocks mid-block, and a fan-in
    # of 4 forces pre-merge passes: the output is still the stable sort
    mol, _ = _port_chain(mixture_env, "unaligned", "sort_src")
    with BamReader(mol) as r:
        header = r.header
    items = _blob_stream(mol, 5)
    monkeypatch.setattr(te, "MERGE_FANIN", 4)
    out, counts = {}, {}
    for engine in ("python", "native"):
        out[engine] = str(tmp_path / f"{engine}.bam")
        with BamWriter(out[engine], header) as w:
            counts[engine] = te.external_sort_raw_to_writer(
                iter(items), w, header, workdir=str(tmp_path), buffer_records=13, engine=engine)
    assert counts["native"] == counts["python"] == sum(i.count for i in items)
    assert _sha(out["native"]) == _sha(out["python"])
    with BamWriter(str(tmp_path / "py_codec.bam"), header, engine="python") as w, \
            pytest.raises(OSError, match="native-codec"):
        te.external_sort_raw_to_writer(iter(items), w, header, engine="native")


def test_sort_write_seconds_land_in_the_stage_metrics(grouped_env):
    stats = tc.StageStats()
    _port_chain(grouped_env, "self", "sortwrite", stats=stats)
    assert stats.metrics.seconds.get("sort_write", 0.0) > 0.0
