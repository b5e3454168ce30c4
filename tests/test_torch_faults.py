"""The port's fault machinery (faults.failpoints, faults.retry) on the CPU
against the JAX package's, and each failpoint site the port fires,
armed alone, against the unarmed run.

Tolerance: equality — parsed schedules field by field, the firing
sequence of seeded probabilistic schedules, the retry executor's
counters, and `run`'s target and intermediate bytes (decompressed) with
the retry/degrade/stall counters each schedule predicts. Schedules are
deterministic (times=, @batch=, @hit=, stalls of 0.5 s or less)."""

import gzip
import os

import numpy as np
import pytest
import torch

from bsseqconsensusreads_tpu.faults import failpoints as jfp
from bsseqconsensusreads_tpu.faults import retry as jretry
from bsseqconsensusreads_tpu.io import bam as jbam
from bsseqconsensusreads_tpu.utils import observe as jobserve
from bsseqconsensusreads_tpu.utils.testing import (
    make_grouped_bam_records,
    random_genome,
    write_fasta,
)
from bsseqconsensusreads_tpu_torch import config as pconfig
from bsseqconsensusreads_tpu_torch.faults import failpoints as pfp
from bsseqconsensusreads_tpu_torch.faults import retry as pretry
from bsseqconsensusreads_tpu_torch.io._nativelib import NativeLibraryError
from bsseqconsensusreads_tpu_torch.ops.cuda_vote import KernelError
from bsseqconsensusreads_tpu_torch.pipeline import stages as pstages
from bsseqconsensusreads_tpu_torch.utils.observe import Metrics

SPECS = [
    "dispatch_kernel=raise:RuntimeError:times=1@batch=2",
    "fetch_out=stall:3s@batch=3",
    "extsort_spill=io_error:p=0.01:seed=42",
    "hostpool_task=raise:times=1;bucket_spill=io_error:times=2@stage=molecular",
    "bucket_finalize=exit:9@hit=3, ckpt_shard_write=io_error:times=1",
    "net_send=delay:0.5s@peer=127.0.0.1",
    "serve_retire=raise:ValueError@job=j1",
    "native_load=raise:OSError",
]
BAD = ["nosuch=raise", "fetch_out", "fetch_out=explode", "fetch_out=raise:KeyError",
       "fetch_out=drop", "fetch_out=raise:times=x", "fetch_out=raise@color=red",
       "fetch_out=io_error:extra", "fetch_out=raise:q=1"]
FIELDS = ("site", "action", "exc_name", "prob", "seed", "duration_s", "exit_code",
          "times", "batch", "stage", "job", "hit", "peer", "spec")


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    pfp.disarm()
    jfp.disarm()


def test_sites_and_actions_equal_the_jax_registrys():
    assert pfp.SITES == jfp.SITES
    assert pfp.NET_SITES == jfp.NET_SITES
    assert pfp.NET_ACTIONS == jfp.NET_ACTIONS
    assert pfp._ACTIONS == jfp._ACTIONS


@pytest.mark.parametrize("spec", SPECS)
def test_parsed_schedules_equal_the_jax_registrys(spec):
    p, j = pfp.parse_schedule(spec), jfp.parse_schedule(spec)
    assert [[getattr(fp, f) for f in FIELDS] for fp in p] == \
        [[getattr(fp, f) for f in FIELDS] for fp in j]


@pytest.mark.parametrize("spec", BAD)
def test_bad_schedules_are_refused_with_the_jax_registrys_message(spec):
    with pytest.raises(jfp.FailpointError) as je:
        jfp.parse_schedule(spec)
    with pytest.raises(pfp.FailpointError) as pe:
        pfp.parse_schedule(spec)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("spec", [
    "hostpool_task=raise:p=0.3:seed=7",
    "fetch_out=io_error:p=0.5:seed=11:times=4",
    "dispatch_kernel=raise@hit=5",
    "dispatch_kernel=raise:times=2@batch=3",
    "extsort_spill=io_error:p=0.2:seed=3@stage=methyl",
])
def test_firing_sequences_equal_the_jax_registrys(spec):
    def sequence(mod):
        mod.arm(spec)
        fired = []
        for i in range(60):
            ctx = {"batch": i % 6, "stage": ("methyl", "duplex")[i % 2]}
            try:
                mod.fire(spec.split("=")[0], **ctx)
                fired.append(0)
            except Exception as exc:  # the injected fault
                fired.append(type(exc).__name__)
        counts = mod.fired_counts()
        mod.disarm()
        return fired, counts

    assert sequence(pfp) == sequence(jfp)
    assert not pfp.ARMED


def _flaky(fails: int, exc=RuntimeError):
    state = {"n": 0}

    def unit():
        state["n"] += 1
        if state["n"] <= fails:
            raise exc(f"transient {state['n']}")
        return "ok"

    return unit, state


@pytest.mark.parametrize("fails,seeded", [(0, False), (1, False), (2, False), (3, False),
                                          (5, False), (1, True), (2, True), (3, True)])
def test_guarded_counts_equal_the_jax_executors(fails, seeded):
    """Retry, recover and degrade counts of guarded (3 attempts) for a
    unit failing `fails` times, with and without a seeded failure."""
    out = {}
    for name, mod, metrics in (("jax", jretry, jobserve.Metrics()), ("port", pretry, Metrics())):
        unit, state = _flaky(fails)
        kw = {"failed": RuntimeError("seed")} if seeded else {}
        res = mod.guarded(unit, degrade=lambda: "degraded", metrics=metrics, stage="s",
                          batch=1, policy=mod.RetryPolicy(max_attempts=3),
                          sleep=lambda s: None, **kw)
        out[name] = (res, state["n"], {k: metrics.counters.get(k, 0) for k in (
            "batches_retried", "batches_recovered", "batches_degraded", "retry_attempts")})
    assert out["port"] == out["jax"]


def test_guarded_without_a_fallback_reraises():
    unit, _ = _flaky(5, OSError)
    with pytest.raises(OSError, match="transient 3"):
        pretry.guarded(unit, policy=pretry.RetryPolicy(max_attempts=3), sleep=lambda s: None)
    unit, state = _flaky(5, ValueError)  # a programming error: never retried
    with pytest.raises(ValueError):
        pretry.guarded(unit, sleep=lambda s: None)
    assert state["n"] == 1


@pytest.mark.parametrize("exc", [
    KernelError("bsseq_seg_vote launch failed: cudaError 700"),
    NativeLibraryError("libbsseq_bamio.so", "g++ failed (1)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA driver error: unspecified launch failure"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
] + ([torch.AcceleratorError("CUDA error: misaligned address")]
     if hasattr(torch, "AcceleratorError") else []))
def test_cuda_and_build_errors_are_never_retried_or_degraded(exc):
    """The port's difference from the JAX package: a CUDA error, the card
    out of memory, a kernel build or launch error and a host library
    error propagate at once — retrying a sticky CUDA error fails again,
    and no degrade may hide a broken card or kernel."""
    assert pretry.fatal(exc) and not pretry.fatal(RuntimeError("injected"))
    calls = {"n": 0, "degraded": 0}

    def unit():
        calls["n"] += 1
        raise exc

    def degrade():
        calls["degraded"] += 1

    metrics = Metrics()
    with pytest.raises(type(exc)):
        pretry.guarded(unit, degrade=degrade, metrics=metrics, sleep=lambda s: None)
    with pytest.raises(type(exc)):
        pretry.guarded(unit, degrade=degrade, metrics=metrics, failed=exc,
                       sleep=lambda s: None)
    assert calls == {"n": 1, "degraded": 0} and not metrics.counters


def test_native_load_failpoint_raises_the_native_library_error(monkeypatch):
    from bsseqconsensusreads_tpu_torch.io import _nativelib

    monkeypatch.setattr(_nativelib, "_LOADED", {})
    pfp.arm("native_load=raise:OSError")
    with pytest.raises(NativeLibraryError, match="failpoint injected"):
        _nativelib.load("wirepack", ())
    pfp.disarm()
    assert _nativelib.load("wirepack", ()) is not None


@pytest.fixture(scope="module")
def run_env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_faults")
    rng = np.random.default_rng(57)
    name, genome = random_genome(rng, 12_000)
    fasta = str(tmp / "genome.fa")
    write_fasta(fasta, name, genome)
    header, records = make_grouped_bam_records(rng, name, genome, n_families=40,
                                               error_rate=0.01)
    bam = str(tmp / "sampleF.bam")
    with jbam.BamWriter(bam, header) as w:
        w.write_all(records)
    env = {"tmp": tmp, "fasta": fasta, "bam": bam}
    env["clean"] = _run(env, "clean", {})
    return env


def _run(env, tag, over):
    cfg = pconfig.FrameworkConfig(
        genome_dir=os.path.dirname(env["fasta"]),
        genome_fasta_file_name=os.path.basename(env["fasta"]), backend="cpu",
        batch_families=8, sort_buffer_records=30, **over)
    outdir = str(env["tmp"] / tag)
    target, _r, stats = pstages.run_pipeline(cfg, env["bam"], outdir=outdir)
    inter = os.path.join(outdir, "sampleF_consensus_unfiltered_aunamerged_aligned.bam")
    planes = []
    for path in (target, inter):
        with gzip.open(path) as fh:
            planes.append(fh.read())
    counts = {}
    for st in stats.values():
        for k in ("batches_retried", "batches_recovered", "batches_degraded",
                  "batches_stalled"):
            counts[k] = counts.get(k, 0) + st.counter(k)
    return planes, counts


ZERO = {"batches_retried": 0, "batches_recovered": 0, "batches_degraded": 0,
        "batches_stalled": 0}
#: (schedule, extra env, config overrides, predicted counters)
DRILL = {
    "dispatch_kernel": ("dispatch_kernel=raise:RuntimeError:times=1@batch=2", {}, {},
                        dict(ZERO, batches_retried=1, batches_recovered=1)),
    "fetch_out": ("fetch_out=io_error:times=1@stage=duplex", {}, {},
                  dict(ZERO, batches_retried=1, batches_recovered=1)),
    # two overlap workers, no host workers: the dispatch thread joins
    # batch 1 after encoding two more batches, well inside the 0.5 s stall,
    # while the other worker carries the batches behind it
    "fetch_out_stall": ("fetch_out=stall:0.5s:times=1@batch=1",
                        {"BSSEQ_TPU_STALL_TIMEOUT_S": "0.25", "BSSEQ_TPU_OVERLAP_THREADS": "2",
                         "BSSEQ_TPU_HOST_WORKERS": "0"}, {},
                        dict(ZERO, batches_stalled=1)),
    "retire_future": ("retire_future=raise:times=1@batch=1", {}, {},
                      dict(ZERO, batches_retried=1, batches_recovered=1)),
    "hostpool_task": ("hostpool_task=raise:times=1", {}, {},
                      dict(ZERO, batches_retried=1, batches_recovered=1)),
    "degrade": ("dispatch_kernel=raise:times=3@batch=2", {"BSSEQ_TPU_RETRY_MAX": "3"}, {},
                dict(ZERO, batches_retried=1, batches_degraded=1)),
    "extsort_spill": ("extsort_spill=io_error:times=1", {}, {"sort_engine": "python"},
                      dict(ZERO, batches_retried=1, batches_recovered=1)),
    "extsort_spill_native": ("extsort_spill=io_error:times=1", {}, {},
                             dict(ZERO, batches_retried=1, batches_recovered=1)),
    "bucket_spill": ("bucket_spill=io_error:times=1", {}, {"sort_engine": "bucket"},
                     dict(ZERO, batches_retried=1, batches_recovered=1)),
    "ckpt_shard_write": ("ckpt_shard_write=io_error:times=1", {}, {"checkpoint_every": 2},
                         dict(ZERO, batches_retried=1, batches_recovered=1)),
}


@pytest.mark.parametrize("case", sorted(DRILL))
def test_each_fired_site_armed_alone_writes_the_unarmed_bytes(run_env, case, monkeypatch):
    spec, env, over, want = DRILL[case]
    monkeypatch.setenv("BSSEQ_TPU_RETRY_BACKOFF_S", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pfp.arm(spec)
    try:
        planes, counts = _run(run_env, case, over)
        fired = pfp.fired_counts()
    finally:
        pfp.disarm()
    assert planes == run_env["clean"][0]
    assert run_env["clean"][1] == ZERO
    site = spec.split("=")[0]
    assert fired.get(site, 0) >= 1
    if site in ("extsort_spill", "bucket_spill", "ckpt_shard_write"):
        # durable-write retries count on the stage metrics when the
        # writer holds them, and never degrade
        assert counts["batches_degraded"] == 0 and counts["batches_stalled"] == 0
    else:
        assert counts == want
