"""The port's batch engine (parallel.hostpool, the overlap workers of
pipeline.calling) on the CPU: the molecular and duplex bytes for host
workers 0/1/2/4 x overlap workers 0/2 against the JAX package's inline
bytes (its host pool and overlap pool off), deep families and
methylation included.

Tolerance: equality — the BAMs, bedMethyl and CX files SHA-equal, the
stage counters equal across worker counts. The JAX package's own
overlap path is not a reference here (its overlap identity test is red,
ROADMAP queue 3)."""

import hashlib
import itertools

import numpy as np
import pytest

from bsseqconsensusreads_tpu.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu.methyl import tally as jtally
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops import refstore as jrs
from bsseqconsensusreads_tpu.ops.encode import codes_to_seq
from bsseqconsensusreads_tpu.pipeline import calling as jc
from bsseqconsensusreads_tpu.pipeline import extsort as je
from bsseqconsensusreads_tpu.utils.testing import stream_duplex_families, write_fasta
from bsseqconsensusreads_tpu_torch.io.bam import BamReader as PortReader
from bsseqconsensusreads_tpu_torch.methyl import tally as ttally
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import refstore as trs
from bsseqconsensusreads_tpu_torch.parallel import hostpool
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline import extsort as te
from bsseqconsensusreads_tpu_torch.pipeline import stages

JROUTE = dict(mesh=None, transport="unpacked", layout="packed", emit="python",
              vote_kernel="xla")
WORKERS = list(itertools.product((0, 1, 2, 4), (0, 2)))


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """80 bisulfite families of 1-3 templates per strand, and the JAX
    package's inline molecular (deep_threshold 2: the 3-template families
    take the deep route) and duplex-with-methyl outputs on them."""
    tmp = tmp_path_factory.mktemp("torch_hostpool")
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=20_000).astype(np.int8)
    genome = codes_to_seq(codes)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, "chr1", genome)
    quals = [bytes(np.random.default_rng(40 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=90)) for i in range(8)]
    recs = stream_duplex_families(
        codes, 80, read_len=90, templates_for=lambda fam: 1 + fam % 3,
        qual_for=lambda fam, ti, flag: quals[(fam + ti + flag) & 7], bisulfite=True,
    )
    bam = str(tmp / "grouped.bam")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(genome))])
    with BamWriter(bam, header) as w:
        w.write_all(recs)
    e = {"tmp": tmp, "bam": bam, "fasta": fasta, "genome": genome}

    def fetch(_name, s, end):
        return genome[s:end]

    e["fetch"] = fetch
    mp = pytest.MonkeyPatch()
    mp.setenv("BSSEQ_TPU_HOST_WORKERS", "0")
    mp.setenv("BSSEQ_TPU_OVERLAP_THREADS", "0")
    try:
        jmol = str(tmp / "jax_mol.bam")
        with BamReader(bam) as r:
            batches = jc.call_molecular_batches(
                r, JaxParams(min_reads=1), mode="self", grouping="coordinate",
                batch_families=16, deep_threshold=2, **JROUTE)
            je.write_batch_stream(batches, jmol, r.header, "self", sort_engine="python")
        base = str(tmp / "jax_dup.bam")
        store = jrs.RefStore.from_fasta(fasta)
        acc = jtally.MethylAccumulator(store, base + ".bedmethyl", base + ".CX_report.txt")
        with BamReader(jmol) as r:
            batches = jc.call_duplex_batches(
                r, fetch, ["chr1"], JaxParams(min_reads=0), mode="self",
                grouping="coordinate", batch_families=16, refstore=store, methyl=acc,
                **JROUTE)
            je.write_batch_stream(batches, base, r.header, "self", sort_engine="python")
        acc.finalize()
    finally:
        mp.undo()
    e["jax"] = {"mol": _sha(jmol), "dup": _sha(base), "bed": _sha(base + ".bedmethyl"),
                "cx": _sha(base + ".CX_report.txt")}
    return e


def _port(env, tag, engine):
    """The port's molecular (deep_threshold 2) and duplex-with-methyl
    stages on the CPU at the current worker settings: (SHAs, stats)."""
    tmp = env["tmp"]
    mol = str(tmp / f"mol_{tag}.bam")
    mstats = tc.StageStats(stage="molecular")
    with PortReader(env["bam"]) as r:
        batches = tc.call_molecular_batches(
            stages.molecular_ingest_stream(env["bam"], r, mstats, ingest_choice=engine),
            ConsensusParams(min_reads=1), mode="self", grouping="coordinate",
            batch_families=16, stats=mstats, device="cpu", deep_threshold=2, emit=engine)
        te.write_batch_stream(batches, mol, r.header, "self", metrics=mstats.metrics,
                              sort_engine=engine)
    dup = str(tmp / f"dup_{tag}.bam")
    dstats = tc.StageStats(stage="duplex")
    acc = ttally.MethylAccumulator(trs.RefStore.from_fasta(env["fasta"]), dup + ".bedmethyl",
                                   dup + ".CX_report.txt", engine=engine)
    with PortReader(mol) as r:
        batches = tc.call_duplex_batches(
            stages.duplex_ingest_stream(mol, r, dstats, ingest_choice=engine),
            env["fetch"], ["chr1"], ConsensusParams(min_reads=0), mode="self",
            grouping="coordinate", batch_families=16, stats=dstats, device="cpu",
            emit=engine, refstore=acc.refstore, methyl=acc)
        te.write_batch_stream(batches, dup, r.header, "self", metrics=dstats.metrics,
                              sort_engine=engine)
    acc.finalize()
    shas = {"mol": _sha(mol), "dup": _sha(dup), "bed": _sha(dup + ".bedmethyl"),
            "cx": _sha(dup + ".CX_report.txt")}
    return shas, mstats, dstats


_COUNTS = ("families", "consensus_out", "skipped_families", "leftover_records", "batches",
           "pad_cells", "used_cells", "records_in")


@pytest.mark.parametrize("engine", ["native", "python"])
def test_bytes_equal_the_jax_packages_for_every_worker_count(env, engine, monkeypatch):
    counts = set()
    for hw, ov in WORKERS:
        monkeypatch.setenv("BSSEQ_TPU_HOST_WORKERS", str(hw))
        monkeypatch.setenv("BSSEQ_TPU_OVERLAP_THREADS", str(ov))
        shas, mstats, dstats = _port(env, f"{engine}_{hw}_{ov}", engine)
        assert shas == env["jax"], (engine, hw, ov)
        for st in (mstats, dstats):
            assert st.counter("batches_retried") == st.counter("batches_degraded") == 0
            assert st.metrics.counters.get("overlap_pool_workers", 0) == ov
            assert st.metrics.counters.get("host_pool_workers", 0) == hw
        assert mstats.metrics.counters["deep_routed_families"] > 0
        counts.add(tuple(getattr(st, k) for st in (mstats, dstats) for k in _COUNTS))
    assert len(counts) == 1


def test_worker_defaults_follow_the_jax_packages_rule(monkeypatch):
    import torch

    monkeypatch.delenv("BSSEQ_TPU_OVERLAP_THREADS", raising=False)
    assert tc._overlap_workers(torch.device("cpu")) == 0
    assert tc._overlap_workers(torch.device("cuda")) == 2
    monkeypatch.setenv("BSSEQ_TPU_OVERLAP_THREADS", "3")
    assert tc._overlap_workers(torch.device("cpu")) == 3
    monkeypatch.delenv("BSSEQ_TPU_HOST_WORKERS", raising=False)
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    assert hostpool.host_workers() == 4
    monkeypatch.setattr("os.cpu_count", lambda: 1)
    assert hostpool.host_workers() == 0


def test_prefetch_keeps_one_task_in_flight():
    """_hp_prefetch submits task N+1 only after task N finished (the
    encode's FASTA reads never overlap), and yields in input order."""
    import threading
    import time

    live = []
    peak = []
    lock = threading.Lock()

    def task(x):
        with lock:
            live.append(x)
            peak.append(len(live))
        time.sleep(0.01)
        with lock:
            live.remove(x)
        return x * 2

    pool = hostpool.HostPool(4)
    try:
        out = list(tc._hp_prefetch(iter(range(12)), pool, task))
    finally:
        pool.shutdown()
    assert out == [2 * x for x in range(12)]
    assert max(peak) == 1


def test_shared_counters_lose_no_update_under_thread_switching():
    """The stage Metrics and the kernels' launch counts are shared by the
    overlap and host workers: 16 threads at a 1 us switch interval must
    lose no count."""
    import sys
    import threading

    from bsseqconsensusreads_tpu_torch.utils.observe import Metrics

    metrics = Metrics()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                metrics.count("n")
                metrics.add_seconds("t", 1.0)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert metrics.counters["n"] == 32_000
    assert metrics.seconds["t"] == 32_000.0
