#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsseqconsensusreads_tpu_torch) on one
NVIDIA card: builds the hand-written vote kernels, holds each against its
plain PyTorch version at the main path's shapes, then drives the
molecular -> duplex consensus path end to end and checks what comes out.

    python3 chip_smoke.py                 # the full run (one card)
    python3 chip_smoke.py --families 2000 # a shorter main-path run
    python3 chip_smoke.py --kernels-only  # phases 0-2 (e.g. under compute-sanitizer)
    python3 chip_smoke.py --engine-ab --families 20000
                                          # phases 0-1, then the host engines A/B

Phases:
  0. the card: `nvidia-smi --query-gpu=name,power.limit` and the device
     name; no CUDA device -> exit 2 with no result.
  1. build csrc/vote.cu with nvcc for sm_90a (ptxas report + seconds) and
     the two host libraries from csrc/host/ with g++, all at once (seconds
     and paths).
  2. each kernel against its plain version on the card, at the main paths'
     shapes (Phase 3's 2048 and `run`'s 512 families per batch), at the
     shapes a tiled kernel gets wrong first (empty segments, one 1,500-row
     segment, W 160 / 224, min input qual 20 on one and two planes;
     vote_finalize at [4096, 192], n % 4 != 0 and the main path's [256])
     and at the deep-family route's (padded [1, 5120, 2, 192],
     [3, 5120, 2, 192] and [1, 16384, 2, 192], one packed 4,097-row
     segment): mismatch counts — log-likelihood sums bit-identical, base,
     qual, depth and errors equal; seg_vote's partials mode (sums, counts,
     depth, no finalize) at the deep mesh route's shapes (one reads slot's
     half of the deep dispatches), bit-identical to its plain twin. Times: CUDA events around each launch,
     every launch after an L2 flush, all enqueued behind a sleep kernel and
     read after one synchronize, so the host runs ahead (mean of the event
     pairs); each kernel timed twice in turns (spread printed) and once
     under torch.profiler (key_averages: the kernel's own device time).
     The byte bound at 3.35 TB/s and its share of each time; the event
     timer's floor (a one-element add); one PyTorch library call over the
     same contributions (torch.segment_reduce) as a yardstick the port
     never calls. The plain version of a case deeper than 2,000 rows is
     timed by its one comparison call.
  2b. (after Phase 3's head) a child process under CUDA_LAUNCH_BLOCKING=1
     runs every Phase 2 seg_vote case on the bounds-checked debug build of
     csrc/vote.cu (a trap on any row, offset, segment, stage, output cell
     or TMA address outside its tensor) against the release build, then
     the head's molecular and duplex stages on it (the release bytes).
  3. end to end: a grouped BAM of --families families (default 200,000:
     the JAX package's tools/scale_rehearsal.py mixture: read length 150,
     fragment 180, 2 Mb genome, 70% one template per strand and the rest
     two, RTA3-binned quals, ~1.3% substitutions), written by the port's
     native writer, and a human-scale genome FASTA + .fai made from a
     seed (25 random contigs of GRCh38's chromosome lengths, then the 2 Mb
     data contig last, 3.09 Gbp; the duplex stages of phases 3, 3w and 4a
     read it, the head and phases 4b-4c the 2 Mb one); the molecular
     stage (mode 'self', grouping 'coordinate', 2048 families per batch),
     write_batch_stream, the duplex stage, write_batch_stream — with the
     native host engines and
     transport 'unpacked' named explicitly (ingest, emit and sort
     'native': a failed host build fails the run), the kernels' launch
     counts set to 0 before and read after each stage, each stage under
     torch.profiler (the card's activity only) for its device busy seconds
     and idle share, and seg_vote's launches counted by (N, P, W, S). Per
     stage: families/s, the seconds of every host phase (ingest, encode,
     host_vote, rawize, emit, sort_write) and device phase (kernel,
     device_wait, fetch), the ingest_native / group_native counters, the
     route of the device batches, the bytes each way per device batch,
     the peak host RSS and device memory, and the launches.
  3w. the same input through both stages with transport 'wire' (one
     packed input wire per batch, the whole human-scale genome read and
     uploaded to the card inside the duplex stage, timed as genome_load),
     measured the same way in the same call: both BAMs must equal Phase
     3's byte for byte, every device batch must take
     the wire and seg_vote must launch in both stages; printed beside
     Phase 3's numbers, with the wire's resolved qual modes.
     Then the identity head: --cpu-families families of the same mixture
     plus three deep families (4,097, 5,000 and 16,385 templates per
     strand: two take the deep route, one is past DEEP_TEMPLATE_CAP and is
     skipped and counted) through both stages on the card with the native
     and the Python engines over both transports (all SHA-equal to native
     unpacked required), and on the CPU over both transports (SHA-equal to
     each other and to the card), stage by stage on identical input, every
     molecular run with the deep counters checked; and the qual tables
     built on the card equal to the CPU-built ones.
  4. `run`, the system's entry point, in the same temporary directory:
     a. cli.main(["run", "--bam", <Phase 3's input>, "--reference", ...,
        "--outdir", ...]) with the default config (aligner 'self', 512
        families per batch, intermediate at deflate level 1), the kernels'
        counts set to 0 just before and read just after, each stage under
        torch.profiler: the seconds of each rule, per stage families/s and
        phases (beside Phase 3's families/s from the same call), launches
        and seg_vote shapes, the idle share. The intermediate's and the
        target's records must equal Phase 3's molecular.bam and duplex.bam
        byte for byte, their headers equal apart from @PG lines, both
        stages must take the wire (transport 'auto' on the card) and launch
        seg_vote, the qual-table build vote_finalize, and
        deep_skipped_families must be 0. A second identical run must
        skip both rules "up to date" and leave the target's SHA and mtime.
     b. crash and resume on the card at the --cpu-families head: a child
        process runs the checkpointed pipeline (checkpoint_every 1, 16
        families per batch) and is SIGKILLed once the molecular stage has
        made >= 2 batches durable and before its target exists (the phase
        fails if the kill did not land there); a second child resumes. The
        target must be SHA-equal to an uninterrupted run of the same
        config, the resumed molecular stage must run fewer batches.
     c. aligner 'none' at the head on the card and on the CPU: the FASTQs
        equal.
  5. methylation, fused into the duplex stage:
     a. cli.main(["duplex", ..., "--methyl", "both"]) on Phase 3's
        molecular families below a quarter of --families (a depth cut for
        the run's time limit) and the human-scale genome, transport
        'auto' (the wire): its BAM equal to Phase 3w's; counts set to 0
        just before and read just after (a main path);
     b. the same over 'unpacked': its BAM equal to Phase 3's, its
        bedMethyl and CX equal to 5a's. Logged beside Phase 3w's and 3's
        duplex families/s: the methyl and finalize seconds, unique sites,
        spill runs, bytes each way per batch, idle share, peak host RSS
        and device memory;
     c. the head on the card over the wire and unpacked and on the CPU
        with the device and the host methyl engines: the same bedMethyl
        and CX; one head batch's epilogue planes on the card equal to the
        numpy twin's, and the epilogue's time per batch (events, and the
        device time of its kernels from torch.profiler);
     d. a checkpointed `run` with methyl 'both' on the head, SIGKILLed
        once the duplex stage has 2 durable batches, resumed in a new
        process: target, bedMethyl and CX SHA-equal to an uninterrupted
        run, the resumed stage spilling >= 1 run.

  6. the raw-BAM entry: Phase 3's mixture, seed and genome one step
     earlier (raw.bam: per-family duplex UMIs in RX, B strands' halves
     swapped, no MI; and raw_head.bam, the head's families), written by a
     child process while Phase 3 writes its inputs (awaited before any
     stage is measured):
     a. run_pipeline(FrameworkConfig(filter={"min_reads": [2, 1, 1]}))
        on raw.bam's families below an eighth of --families (a depth cut
        for the run's time limit) and the human-scale genome, default
        settings: the
        rules group_reads_by_umi, call_consensus_molecular_tpu,
        call_duplex_tpu and filter_consensus_duplex, each under
        torch.profiler and the peak-memory sampler (seconds, records/s of
        the group and filter rules, stage phases, launches, idle share),
        the kernels' counts set to 0 just before and read just after (a
        main path). Gates: molecules = --families and every drop counter
        0; the grouped intermediate's MIs partition its records exactly
        by generator family and strand (records whose MI is not
        '<family>/<strand>' are counted); the unfiltered target's records,
        as a sorted multiset with RX set aside, equal 4a's target's
        records of the same families, the
        headers equal apart from @PG; the filter's counts reconcile;
     b. raw_head.bam through `run` (grouped, the same filter) on the card
        and on the CPU: grouped intermediate, unfiltered and filtered
        targets SHA-equal; `metrics --compact` on both grouped heads the
        same JSON; `group` through cli.main: the runs' grouped records;
        `sort --order coordinate|name|template-coordinate` of the card's
        and the CPU's grouped heads SHA-equal;
     c. `duplex --passthrough` on the head's molecular BAM with leftover
        records appended (flag 0 and 1, a duplicated 83, a softclipped
        163, an indel read, a hard-clipped read) on the card and the CPU:
        SHA-equal, leftover_records 5, the four kinds written through.

  7. the batch engine (every phase runs at the port's
     defaults: 2 overlap workers on their own CUDA streams and
     min(4, cores-1) host workers; every stage summary carries them, and
     every unarmed path must count 0 retried, recovered, degraded and
     stalled batches):
     a. run_pipeline with sort_engine 'bucket' and stream_interstage on
        Phase 3's families below an eighth of --families (a depth cut for
        the run's time limit): the one fused rule, its target and molecular
        intermediate equal to 4a's records (@PG aside); bucket_count, the
        rule seconds beside 4a's, peak host RSS; a main path;
     b. the same default `run` in a child process with
        BSSEQ_TPU_HOST_WORKERS=0 and BSSEQ_TPU_OVERLAP_THREADS=0 on Phase
        3's families below a quarter of --families (a depth cut): the target
        equal to 4a's records of those families, per-stage families/s beside 4a's (the pools'
        measured effect on this card);
     c. the failpoint drill at the head's normal families: each schedule
        of DRILL armed
        alone (a dispatch raise, a 3 s fetch stall under a 1 s watchdog,
        a host-pool raise, spill / shard / bucket-spill I/O errors, a
        dispatch raise past BSSEQ_TPU_RETRY_MAX that degrades one batch:
        its unit once more on the card, so the run's kernel launches
        equal the unarmed run's), each target SHA-equal to the unarmed
        run with the predicted counters and fires; then bucket_finalize=exit:9
        in a checkpointed child process and a resume;
     d. the input guard: `molecular` on 400 normal head families with
        out-of-range quals — strict exits 3 with the same reason on the
        card and the CPU; under quarantine the output, the sidecar and
        the counters are equal card vs CPU and reconcile.

  8. indel recovery (indel_policy 'align'): the Phase 3 mixture at
     --families families with INDEL_RATE of the reads carrying one 1-3 bp
     insertion or deletion (mostly in homopolymers, one in 16 of them
     garbage past the indel), written by a child process beside Phase 3's
     inputs:
     a. run_pipeline(FrameworkConfig(indel_policy="align")) on the card
        on its families below a quarter of --families (a depth cut for the
        run's time limit; a main path): families/s per stage, indel_aligned /
        indel_dropped (their sum must equal the C scan's keep == 2 reads),
        every banded_scores call's (N, L) and the DP's and the host
        traceback's seconds beside the molecular wall, and one call's
        launches and time on the card;
     b. `molecular --indel-policy drop` on the same input: families
        without an indel read byte-equal to 8a's intermediate, family by
        family, every other family's cD at least 8a's (and some deeper);
        families/s beside 8a's;
     c. the indel head (its deep families carry indel reads) with align
        through both stages on the card and the CPU: SHA-equal.
  9. the multi-device layer on one card (mesh='auto' is one device there):
     a. Phase 3's families below a quarter of --families (a depth cut
        for the run's time limit) through both stages on make_mesh(n_data=2)
        over two slots of cuda:0 (two streams), sharded (unpacked) and
        round-robin (transport 'wire'): every BAM's records equal to Phase
        3's or 3w's records of those families, every device batch on the mesh route, seg_vote launched on
        the slots the route uses (per-slot launch counts), families/s,
        stall and idle share beside Phase 3's (a main path);
     b. the head on make_mesh(n_data=1, n_reads=2): the deep families'
        template axis over two slots (seg_vote's partials mode on each,
        the sums added in rank order, vote_finalize): base, depth and
        errors equal to one device, quals within 1 (the count printed),
        every other family byte-equal;
     c. two processes (init_distributed over gloo, no per-batch traffic),
        one mesh slot each on the card: each votes its local_family_count
        share of the head's strand families; the merged records equal the
        one-process head run's;
     d. the head's duplex stage with methyl 'both' on make_mesh(n_data=2):
        each data slot runs the methyl epilogue on the card; the BAM equal
        to Phase 3's head duplex BAM, bedMethyl and CX to 5c's.

  10. the serving tier (serve/):
     a. Phase 3's families below a quarter of --families (a depth cut for
        the run's time limit) split by family into 4 tenant BAMs (a
        sixteenth of --families each), submitted at once to one in-process
        ServeEngine(device='cuda', mode 'self', 512 families per batch,
        max_active 4) after its warmup() — the counts set to 0 just before
        the submits and read after the last job is done (a main path):
        every job done, batches_shared_jobs > 0, each tenant's records
        equal to Phase 3's molecular records of its families, tenant 0
        sha256-equal to a standalone `molecular --batching sequential` on
        the card, drain(timeout=60) True, no failpoint fired; aggregate
        families/s, per-job submit-to-done latency, seg_vote launches by
        (N, P, W, S), vote_finalize launches, the idle share under
        torch.profiler, the compile-cache counts, peak host RSS and
        device memory;
     b. `serve` in a child process on unix and tcp addresses, on the
        families of Phase 3's input below 2,000: `submit --wait` over each
        address sha256-equal to `molecular --batching sequential` on the
        card and on the CPU; a bogus u32 length answered
        {"ok": false, "guard": "oversized_frame"}; SIGTERM with two jobs
        admitted: exit 0 and both jobs' bytes;
     c. `route --replicas 2` on the card with a shared, empty
        BSSEQ_TPU_COMPILE_CACHE_DIR (a replica loads the other's kernel
        build: hit and no miss), r0 armed with
        fleet_replica_exit=exit:9@batch=2: 4 jobs of 10b's input over tcp,
        requeued when r0 dies (jobs_requeued >= 1, jobs_routed = 4 +
        jobs_requeued), every output sha256-equal to 10b's; one client
        submit under net_send=delay:0.2s and one under dup (admitted
        once): the same bytes; the respawned r0 hits the cache; the fleet
        drains and the router exits 0.

Prints the kernel table as one JSON line (launches: the main paths of
Phases 3, 3w, 4a, 5a, 5b, 6a, 7a, 8a, 9a, 9b and 10a together), the
nvidia-smi line, and last {"ok": true, "device": {...}}. Any failed check
exits non-zero. `--phases` runs a subset of Phases 4-10 after Phase 3 (a
short check; the default runs them all).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.monotonic()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
TIE_TOL = 2.5e-6
SLEEP_CYCLES = 200_000_000  # ~0.1 s of card time: the host enqueues meanwhile


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2


def time_ms(torch, fn, repeats: int, flush) -> float:
    """Mean device time of fn() over `repeats` launches, each after an L2
    flush (a read of 256 MB: the cache holds clean lines of another
    buffer). The card first spins in a sleep kernel while every (flush,
    start event, launch, end event) is enqueued behind it, then one
    synchronize: each event pair brackets the launch on the card, never
    the wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    pairs = []
    for _ in range(repeats):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / repeats


def profiled_ms(torch, fn, repeats: int, flush, kernel: str):
    """Mean device time of the kernel whose name contains `kernel` in a
    torch.profiler trace of the same loop: key_averages(), else the trace's
    device events; None when the trace holds no such kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(repeats):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if kernel in e.key and e.count:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            return total / e.count / 1e3
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def timed(torch, fn, repeats: int, flush, kernel: str) -> dict:
    """The kernel's time twice in turns (events, then the profiler's view
    of the same loop, then events again): mean, spread, and the profiler's
    mean with its share of the bound computed by the caller."""
    first = time_ms(torch, fn, repeats, flush)
    prof = profiled_ms(torch, fn, repeats, flush, kernel)
    second = time_ms(torch, fn, repeats, flush)
    return {
        "ms": (first + second) / 2, "ms_runs": [first, second],
        "spread": max(first, second) / min(first, second) - 1.0,
        "profiler_ms": prof if prof is not None else "not measured",
    }


def shares(bound: float, t: dict, floor_ms: float) -> dict:
    """bound / time by the event timer and by the profiler, beside the
    launch floor the event timer reads."""
    prof = t["profiler_ms"]
    return {
        "bound_share": bound / t["ms"],
        "profiler_bound_share": bound / prof if isinstance(prof, float) else "not measured",
        "launch_floor_ms": floor_ms,
    }


def random_rows(np, rng, n: int, planes: int, w: int, read_len: int):
    """[n, planes, w] int8 bases / uint8 quals: one read of read_len per
    (row, plane) at a random offset, RTA3-binned quals, 1% N calls."""
    bases = np.full((n, planes, w), 4, np.int8)
    quals = np.zeros((n, planes, w), np.uint8)
    span = min(read_len, w)
    starts = rng.integers(0, w - span + 1, size=(n, planes))
    cols = starts[..., None] + np.arange(span)
    truth = rng.integers(0, 4, size=(w,)).astype(np.int8)
    obs = np.broadcast_to(truth[cols], cols.shape).copy()
    err = rng.random(cols.shape) < 0.013
    obs[err] = rng.integers(0, 4, size=int(err.sum()))
    obs[rng.random(cols.shape) < 0.01] = 4
    q = rng.choice(np.array([2, 12, 23, 37], np.uint8), size=cols.shape)
    ii, pp = np.indices(cols.shape[:2])
    bases[ii[..., None], pp[..., None], cols] = obs
    quals[ii[..., None], pp[..., None], cols] = q
    return bases, quals


def kernel_cases(np, torch, dev):
    """The seg_vote cases as (name, bases, quals, offsets, params) on the
    card, quals already co-called where the path co-calls: the main path's
    shapes, then the shapes a tiled kernel gets wrong first (empty
    segments, one deep segment, W not a power of two, the input-qual
    filter on one and two planes)."""
    from bsseqconsensusreads_tpu_torch.models.molecular import overlap_cocall
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams

    rng = np.random.default_rng(2024)
    default, q20 = ConsensusParams(), ConsensusParams(min_input_base_quality=20)

    def on_card(b, q):
        return torch.from_numpy(b).to(dev), torch.from_numpy(q).to(dev).to(torch.int16)

    def molecular(name, lens, w, params, pad_rows=0):
        # ragged segments (0 = empty) then sentinel pad rows past the end
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        b, q = random_rows(np, rng, int(offsets[-1]) + pad_rows, 2, w, 150)
        bt, qt = overlap_cocall(*on_card(b, q))
        return (name, bt.contiguous(), qt.contiguous(),
                torch.from_numpy(offsets).to(dev), params)

    def ragged(f, n):
        return 1 + rng.multinomial(n - f, np.full(f, 1.0 / f))

    def padded_deep(name, k, t, real, w, params):
        # k families of `real` templates each, padded to t rows with N
        b, q = random_rows(np, rng, k * t, 2, w, 150)
        pad = (np.arange(k * t) % t) >= real
        b[pad], q[pad] = 4, 0
        bt, qt = overlap_cocall(*on_card(b, q))
        return (name, bt.contiguous(), qt.contiguous(),
                torch.arange(0, k * t + 1, t, dtype=torch.int32, device=dev), params)

    def segments(name, n, planes, w, t, params, read_len=150):
        b, q = random_rows(np, rng, n, planes, w, read_len)
        bt, qt = on_card(b, q)
        return (name, bt, qt, torch.arange(0, n + 1, t, dtype=torch.int32, device=dev), params)

    cases = [molecular(f"molecular_packed_w{w}", ragged(2048, 8192), w, default)
             for w in (192, 4096)]
    cases.append(segments("duplex_packed_w192", 4 * 2048, 1, 192, 2, default))
    # `run`'s default 512 families per batch (Phase 4a's most frequent shapes)
    cases.append(molecular("molecular_packed_w192_b512", ragged(512, 1024), 192, default))
    cases.append(segments("duplex_packed_w192_b512", 4 * 512, 1, 192, 2, default))
    cases.append(segments("padded_g512_t2_w512", 1024, 1, 512, 2, default, 512))
    cases.append(segments("padded_g4096_t8_w192", 2048 * 8, 2, 192, 8, default))
    # a pow2 family bucket: 1,400 real families and 648 empty pad families
    # spread among them, plus pad rows past the last segment
    lens = np.zeros(2048, np.int64)
    real = np.sort(rng.choice(2048, 1400, replace=False))
    lens[real] = ragged(1400, 5600)
    cases.append(molecular("ragged_empty_w192", lens, 192, default, pad_rows=2592))
    lens = ragged(511, 2000)
    cases.append(molecular("deep_1500_w192", np.insert(lens, 200, 1500), 192, default))
    # the deep-family route (pipeline/calling.py _bucket_deep): padded
    # dispatches of 4,097-template families in the 5,120 bucket (one, and
    # the three a dispatch holds), one family at DEEP_TEMPLATE_CAP, and a
    # 4,097-row segment among packed ones
    for k, t, real in ((1, 5120, 4097), (3, 5120, 4097), (1, 16384, 16384)):
        cases.append(padded_deep(f"deep_padded_k{k}_t{t}_w192", k, t, real, 192, default))
    cases.append(molecular("deep_4097_w192", np.insert(lens, 100, 4097), 192, default))
    for w in (160, 224):
        cases.append(molecular(f"molecular_packed_w{w}", ragged(2048, 8192), w, default))
    cases.append(molecular("min_input_q20_p2_w192", ragged(2048, 8192), 192, q20))
    cases.append(segments("min_input_q20_p1_w192", 4 * 2048, 1, 192, 2, q20))
    return cases


def partials_cases(np, torch, dev):
    """seg_vote's partials mode at the deep mesh route's shapes: one reads
    slot's half of the template axis of the head's deep dispatches (two
    families of the 5,120 bucket, and one) and of a family at
    DEEP_TEMPLATE_CAP, co-called, as (name, bases, quals, offsets)."""
    from bsseqconsensusreads_tpu_torch.models.molecular import overlap_cocall

    rng = np.random.default_rng(2025)
    cases = []
    for k, t, real in ((2, 2560, 2048), (1, 2560, 2049), (1, 8192, 8192)):
        b, q = random_rows(np, rng, k * t, 2, 192, 150)
        pad = (np.arange(k * t) % t) >= real
        b[pad], q[pad] = 4, 0
        bt, qt = overlap_cocall(torch.from_numpy(b).to(dev),
                                torch.from_numpy(q).to(dev).to(torch.int16))
        cases.append((f"partials_k{k}_t{t}_w192", bt.contiguous(), qt.contiguous(),
                      torch.arange(0, k * t + 1, t, dtype=torch.int32, device=dev)))
    return cases


def seg_vote_bound_ms(bases, offsets) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms): each input read once (base
    1 B + qual 2 B per cell, offsets, table), each output written once
    (6 B per column); 4 float adds per observed cell plus ~25 float ops per
    output column."""
    n, p, w = bases.shape
    s = offsets.numel() - 1
    nbytes = n * p * w * 3 + (s + 1) * 4 + 512 * 2 * 4 + s * p * w * 6
    observed = int((bases != 4).sum())
    ops = 4 * observed + 25 * s * p * w
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def compare_vote(np, torch, got: dict, want: dict) -> dict:
    """Mismatch counts of kernel vs plain under the contract."""
    ll_k, ll_p = got["ll"].cpu().numpy(), want["ll"].cpu().numpy()
    srt = np.sort(ll_p, axis=-1)
    tie = (srt[..., 3] - srt[..., 2]) <= TIE_TOL
    res = {"ll_bits_differ": int((ll_k.view(np.uint32) != ll_p.view(np.uint32)).sum())}
    for k in ("base", "depth", "errors"):
        d = got[k].cpu().numpy() != want[k].cpu().numpy()
        res[f"{k}_differ_outside_tie"] = int((d & ~tie).sum())
        res[f"{k}_differ"] = int(d.sum())
    dq = np.abs(got["qual"].cpu().numpy().astype(int) - want["qual"].cpu().numpy().astype(int))
    res["qual_differ"] = int((dq > 0).sum())
    res["qual_max_abs"] = int(dq.max()) if dq.size else 0
    res["tie_columns"] = int(tie.sum())
    return res


def finalize_cases(np, torch, dev, params):
    """vote_finalize inputs as (name, ll, depth): ll [4096, 192, 4] summed
    by a molecular vote, its first 4,093 columns (n % 4 == 1), and the
    main path's single-observation table ([256], as ops.reconstruct builds
    it)."""
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, phred

    b, q = random_rows(np, np.random.default_rng(7), 4096 * 4, 1, 192, 150)
    off = torch.arange(0, 4096 * 4 + 1, 4, dtype=torch.int32, device=dev)
    vote = cuda_vote.seg_vote_plain(
        torch.from_numpy(b).to(dev), torch.from_numpy(q).to(dev).to(torch.int16),
        off, params, with_ll=True,
    )
    ll = vote["ll"].reshape(4096, 192, 4).contiguous()
    depth = vote["depth"].reshape(4096, 192).to(torch.int32)
    table = phred.log_table(params.error_rate_post_umi, dev)[:256]
    single = torch.stack([table[:, 0], table[:, 1], table[:, 1], table[:, 1]], dim=-1)
    return [
        ("vote_finalize_4096x192", ll, depth),
        ("vote_finalize_4093", ll.reshape(-1, 4)[:4093].contiguous(),
         depth.reshape(-1)[:4093].contiguous()),
        ("vote_finalize_256", single.contiguous(), torch.ones(256, dtype=torch.int32, device=dev)),
    ]


def phase2(np, torch, dev, repeats: int) -> tuple[list[dict], list[dict], list[dict]]:
    from bsseqconsensusreads_tpu_torch.models.molecular import (
        vote_contrib,
        vote_partials_segments,
    )
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, phred

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > L2
    flush.fill_(1)
    # what the event timer reads for a launch that does almost nothing
    tiny = torch.zeros(1, device=dev)
    time_ms(torch, lambda: tiny.add_(1), repeats, flush)  # first use of each op
    floor_ms = time_ms(torch, lambda: tiny.add_(1), repeats, flush)
    log(f"phase2 launch floor: {floor_ms:.6f} ms (events around a one-element add)")
    seg_rows = []
    for name, b, q, off, params in kernel_cases(np, torch, dev):
        got = cuda_vote.seg_vote(b, q, off, params, with_ll=True)
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
        deepest = int((off[1:] - off[:-1]).max())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = cuda_vote.seg_vote_plain(b, q, off, params, with_ll=True)
        end.record()
        torch.cuda.synchronize()
        res = compare_vote(np, torch, got, want)
        del got, want
        t = timed(torch, lambda: cuda_vote.seg_vote(b, q, off, params), repeats, flush,
                  "seg_vote_kernel")
        if deepest > 2000:
            # the plain version walks the deepest segment one row per step
            # (~0.6 ms each): its one comparison call is its time
            plain_ms = start.elapsed_time(end)
        else:
            plain_ms = time_ms(torch, lambda: cuda_vote.seg_vote_plain(b, q, off, params),
                               max(2, repeats // 10), flush)
        lib_ms = None
        if hasattr(torch, "segment_reduce"):
            table = phred.log_table(params.error_rate_post_umi, dev)
            contrib = vote_contrib(b, q, table, params.min_input_base_quality)[0]
            contrib = contrib.reshape(b.shape[0], -1)[: int(off[-1])]
            lengths = (off[1:] - off[:-1]).to(torch.int64)
            try:
                lib_ms = time_ms(
                    torch, lambda: torch.segment_reduce(contrib, "sum", lengths=lengths),
                    repeats, flush,
                )
            except RuntimeError as exc:  # the yardstick only; the port never calls it
                log(f"phase2 {name}: torch.segment_reduce refused the input ({exc})")
            del contrib
        bytes_ms, ops_ms = seg_vote_bound_ms(b, off)
        bound = max(bytes_ms, ops_ms)
        row = {
            "case": name, "shape": list(b.shape), "segments": off.numel() - 1,
            "deepest_segment_rows": deepest,
            "min_input_base_quality": params.min_input_base_quality,
            **t, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **shares(bound, t, floor_ms), **res,
        }
        log(f"phase2 seg_vote {json.dumps(row)}")
        check(res["ll_bits_differ"] == 0, f"{name}: log-likelihood sums differ from the plain version")
        for k in ("base", "depth", "errors", "qual"):
            check(res[f"{k}_differ"] == 0, f"{name}: {k} differs from the plain version")
        seg_rows.append(row)

    params = ConsensusParams()
    fin_rows = []
    for name, ll, depth in finalize_cases(np, torch, dev, params):
        kb, kq = cuda_vote.vote_finalize(ll, depth, params)
        pb, pq = cuda_vote.vote_finalize_plain(ll, depth, params)
        srt = np.sort(ll.cpu().numpy(), axis=-1)
        tie = (srt[..., 3] - srt[..., 2]) <= TIE_TOL
        dbase = kb.cpu().numpy() != pb.cpu().numpy()
        dq = np.abs(kq.cpu().numpy().astype(int) - pq.cpu().numpy().astype(int))
        t = timed(torch, lambda: cuda_vote.vote_finalize(ll, depth, params), repeats, flush,
                  "vote_finalize_kernel")
        plain_ms = time_ms(torch, lambda: cuda_vote.vote_finalize_plain(ll, depth, params),
                           max(2, repeats // 10), flush)
        cols = depth.numel()
        bytes_ms = cols * (16 + 4 + 2) / HBM_BYTES_PER_S * 1e3
        ops_ms = cols * 25 / FP32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        row = {
            "case": name, "shape": list(ll.shape), **t, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **shares(bound, t, floor_ms),
            "base_differ_outside_tie": int((dbase & ~tie).sum()),
            "base_differ": int(dbase.sum()), "qual_differ": int((dq > 0).sum()),
            "qual_max_abs": int(dq.max()), "tie_columns": int(tie.sum()),
        }
        log(f"phase2 vote_finalize {json.dumps(row)}")
        check(row["base_differ"] == 0, f"{name}: base differs from the plain version")
        check(row["qual_differ"] == 0, f"{name}: qual differs from the plain version")
        fin_rows.append(row)

    # seg_vote's partials mode against its plain twin (vote_partials_segments)
    part_rows = []
    for name, b, q, off in partials_cases(np, torch, dev):
        got = cuda_vote.seg_vote_partials(b, q, off, params)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = vote_partials_segments(b, q, off, params)  # the plain twin, on the card
        end.record()
        torch.cuda.synchronize()
        differ = {k: int((g.view(torch.int32) != w.view(torch.int32)).sum())
                  for k, g, w in zip(("ll_bits", "cnt_bits", "depth"), got, want)}
        ll_max_abs = float((got[0] - want[0]).abs().max())
        del got, want
        t = timed(torch, lambda: cuda_vote.seg_vote_partials(b, q, off, params), repeats, flush,
                  "seg_vote_kernel")
        contrib = vote_contrib(b, q, phred.log_table(params.error_rate_post_umi, dev),
                               params.min_input_base_quality)[0].reshape(b.shape[0], -1)
        lengths = (off[1:] - off[:-1]).to(torch.int64)
        lib_ms = None
        try:
            lib_ms = time_ms(torch, lambda: torch.segment_reduce(contrib, "sum", lengths=lengths),
                             repeats, flush)
        except RuntimeError as exc:  # the yardstick only; the port never calls it
            log(f"phase2 {name}: torch.segment_reduce refused the input ({exc})")
        del contrib
        n, p_, w = b.shape
        s_ = off.numel() - 1
        nbytes = n * p_ * w * 3 + (s_ + 1) * 4 + 512 * 2 * 4 + s_ * p_ * w * (16 + 16 + 4)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * int((b != 4).sum()) / FP32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        row = {
            "case": name, "shape": list(b.shape), "segments": s_, **t,
            # the plain twin walks the deep segments one row per step: its
            # one comparison call is its time
            "plain_ms": start.elapsed_time(end),
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **shares(bound, t, floor_ms), **{f"{k}_differ": v for k, v in differ.items()},
            "max_abs_err": ll_max_abs,
        }
        log(f"phase2 seg_vote_partials {json.dumps(row)}")
        check(not any(differ.values()), f"{name}: the partials differ from the plain twin's")
        part_rows.append(row)
    return seg_rows, fin_rows, part_rows


# ---------------------------------------------------------------- phase 3


#: the identity head's deep families: templates per strand of three of
#: its families — two on the deep route (pipeline/calling.py _split_deep,
#: above MAX_TEMPLATES 4,096) and one past DEEP_TEMPLATE_CAP 16,384
DEEP_HEAD = (4097, 5000, 16385)


def write_inputs(np, workdir: str, families: int, cpu_families: int, raw: bool = False,
                 indel: bool = False):
    """The grouped BAM of `families` families, the head BAM of
    `cpu_families` families of the same mixture plus the DEEP_HEAD
    families spread among them, and the genome FASTA. raw: the same two
    inputs one step earlier, raw.bam and raw_head.bam — per-family
    duplex UMIs in RX (B strands' halves swapped) and no MI — and no
    FASTA. indel: the same two inputs with INDEL_RATE of the reads
    carrying a 1-3 bp indel (utils.testing.indel_read; every other read
    as in grouped.bam), indel.bam and indel_head.bam, and no FASTA."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamWriter
    from bsseqconsensusreads_tpu_torch.ops.encode import codes_to_seq
    from bsseqconsensusreads_tpu_torch.utils.testing import (
        stream_duplex_families,
        write_fasta,
    )

    read_len, genome_len = 150, 2_000_000
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=genome_len).astype(np.int8)
    fasta = os.path.join(workdir, "genome.fa")
    if not (raw or indel):
        write_fasta(fasta, "chr1", codes_to_seq(codes))
    qual_pool = [
        bytes(np.random.default_rng(100 + i).choice(
            np.array([2, 12, 23, 37], np.uint8), size=read_len
        )) for i in range(64)
    ]
    err_pos = rng.integers(2, read_len - 2, size=4096)
    err_base = rng.integers(0, 4, size=4096)

    def mutate(seq: str, fam: int, ti: int, flag: int) -> str:
        h = (fam * 31 + ti * 7 + flag) & 4095  # ~1.3%: 2 positions per read
        for k in (h, (h * 2654435761) & 4095):
            i = int(err_pos[k])
            seq = seq[:i] + "ACGT"[err_base[k]] + seq[i + 1:]
        return seq

    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", genome_len)])
    name = "raw" if raw else "indel" if indel else "grouped"
    big = os.path.join(workdir, f"{name}.bam")
    small = os.path.join(workdir, f"{name}_head.bam")
    n_head = cpu_families + len(DEEP_HEAD)
    deep = {n_head * (i + 1) // (len(DEEP_HEAD) + 1): t for i, t in enumerate(DEEP_HEAD)}
    for path, n, tmpl in ((big, families, lambda fam: 1 if fam % 10 < 7 else 2),
                          (small, n_head, lambda fam: deep.get(fam, 1 if fam % 10 < 7 else 2))):
        with BamWriter(path, header, engine="native") as w:
            for rec in stream_duplex_families(
                codes, n, read_len=read_len, frag_extra=30, templates_for=tmpl,
                qual_for=lambda fam, ti, flag: qual_pool[(fam + ti * 13 + flag) & 63],
                mutate=mutate, bisulfite=True, raw_umis=raw,
                indel_rate=INDEL_RATE if indel else 0.0,
            ):
                w.write(rec)
    return fasta, big, small


#: GRCh38 primary-assembly chromosome lengths (chr1..chr22, chrX, chrY,
#: chrM): the human-scale genome's filler contigs, 3,088,286,401 bases
GRCH38_LENGTHS = (
    248956422, 242193529, 198295559, 190214555, 181538259, 170805979, 159345973,
    145138636, 138394717, 133797422, 135086622, 133275309, 114364328, 107043718,
    101991189, 90338345, 83257441, 80373285, 58617616, 64444167, 46709983,
    50818468, 156040895, 57227415, 16569,
)
FASTA_LINE = 60


def write_genome_fillers(np, workdir: str) -> tuple[str, list]:
    """The human-scale genome's first part: 25 random contigs of GRCh38's
    chromosome lengths made from a seed, written as FASTA; returns (path,
    their .fai lines). write_human_genome appends the data contig."""
    path = os.path.join(workdir, "genome_human_scale.fa")
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(38)
    fai: list = []
    with open(path, "wb") as fh:
        for i, n in enumerate(GRCH38_LENGTHS, start=1):
            _write_contig(np, fh, f"hs_chr{i}", acgt[np.frombuffer(rng.bytes(n), np.uint8) & 3], fai)
    return path, fai


def _write_contig(np, fh, name: str, seq, fai: list) -> None:
    """One contig in FASTA_LINE-wide lines, its .fai line (as `samtools
    faidx` writes it) appended to `fai`."""
    n = seq.size
    fh.write(f">{name}\n".encode())
    fai.append(f"{name}\t{n}\t{fh.tell()}\t{FASTA_LINE}\t{FASTA_LINE + 1}\n")
    full = n // FASTA_LINE
    lines = np.empty((full, FASTA_LINE + 1), np.uint8)
    lines[:, :FASTA_LINE] = seq[: full * FASTA_LINE].reshape(full, FASTA_LINE)
    lines[:, FASTA_LINE] = ord("\n")
    fh.write(lines.data)
    if n % FASTA_LINE:
        fh.write(seq[full * FASTA_LINE:].tobytes() + b"\n")


def write_human_genome(np, data_fasta: str, path: str, fai: list) -> str:
    """The human-scale genome FASTA and its .fai: the filler contigs at
    `path` (write_genome_fillers), then the data genome's chr1 LAST, so
    every read's window lies past 2**31 in the concatenated genome (the
    uint32 offsets' upper half). The reads and their windows are the data
    genome's, so every stage writes the bytes it writes on the data
    genome alone."""
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile

    with FastaFile(data_fasta) as fa:
        data = fa.fetch("chr1").encode("ascii")
    with open(path, "ab") as fh:
        fh.seek(0, os.SEEK_END)
        _write_contig(np, fh, "chr1", np.frombuffer(data, np.uint8), fai)
    with open(path + ".fai", "w") as fh:
        fh.writelines(fai)
    return path


class PeakMemory:
    """Peak host RSS (/proc/self/statm read every 5 ms by a thread: the
    card's machine refuses the VmHWM reset) and peak device memory
    allocated by torch over a `with` block, in GiB; the host RSS at its
    start beside it."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    def __init__(self, torch):
        import threading

        self.torch = torch
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self.host_gib = self.host_start_gib = self.device_gib = 0.0

    @classmethod
    def _rss_gib(cls) -> float:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * cls.PAGE / 2**30

    def _sample(self):
        while not self._done.wait(0.005):
            self.host_gib = max(self.host_gib, self._rss_gib())

    def __enter__(self):
        self.host_gib = self.host_start_gib = self._rss_gib()
        self.torch.cuda.reset_peak_memory_stats()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        self.host_gib = max(self.host_gib, self._rss_gib())
        self.device_gib = self.torch.cuda.max_memory_allocated() / 2**30
        return False


def device_busy_s(torch, prof) -> float:
    """Seconds in which the card ran a kernel or a copy during a profiled
    run: the union of the device events' intervals."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e6


def run_stage(stage: str, inp: str, out: str, fasta: str, device: str, prof=None,
              engine: str = "native", *, transport: str, indel_policy: str = "drop",
              mesh="auto"):
    """One stage through the port's entry points, every host engine
    (ingest, emit, sort) named `engine` and the device transport named
    `transport` ('unpacked' or 'wire'; the duplex stage gets the FASTA as
    its refstore), the molecular stage's `indel_policy`, on `mesh` (the
    callers' 'auto', or a parallel.mesh.Mesh); returns (StageStats, per-kernel
    launches in this stage, wall seconds). With `prof`, a torch.profiler
    that records the card's activity, the stage runs under it."""
    import contextlib

    with prof if prof is not None else contextlib.nullcontext():
        return _run_stage(stage, inp, out, fasta, device, engine, transport, indel_policy, mesh)


def _run_stage(stage: str, inp: str, out: str, fasta: str, device: str, engine: str,
               transport: str, indel_policy: str, mesh):
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.pipeline import calling, stages
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream

    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    cuda_vote.SEG_VOTE_SHAPES.clear()
    stats = calling.StageStats(stage=stage)
    t0 = time.monotonic()
    with BamReader(inp) as reader:
        if stage == "molecular":
            batches = calling.call_molecular_batches(
                stages.molecular_ingest_stream(inp, reader, stats, ingest_choice=engine,
                                               indel_policy=indel_policy),
                ConsensusParams(min_reads=1), mode="self",
                batch_families=2048, grouping="coordinate", stats=stats,
                device=device, emit=engine, transport=transport,
                indel_policy=indel_policy, mesh=mesh,
            )
            write_batch_stream(batches, out, reader.header, "self",
                               sort_engine=engine, metrics=stats.metrics)
        else:
            with FastaFile(fasta) as fa:
                names = [n for n, _ in reader.header.references]
                batches = calling.call_duplex_batches(
                    stages.duplex_ingest_stream(inp, reader, stats, ingest_choice=engine),
                    fa.fetch, names, ConsensusParams(min_reads=0),
                    mode="self", batch_families=2048, grouping="coordinate",
                    stats=stats, device=device, emit=engine, transport=transport,
                    refstore=fasta, mesh=mesh,
                )
                write_batch_stream(batches, out, reader.header, "self",
                                   sort_engine=engine, metrics=stats.metrics)
    wall = time.monotonic() - t0
    check_unarmed(stats.metrics.counters, f"{stage} on {device}")
    return stats, dict(cuda_vote.LAUNCHES), wall


HOST_PHASES = ("ingest", "encode", "host_vote", "rawize", "emit", "sort_write")
DEVICE_PHASES = ("kernel", "device_wait", "fetch")
RECOVERY = ("batches_retried", "batches_recovered", "batches_degraded", "batches_stalled")


def check_unarmed(counters: dict, tag: str) -> None:
    """An unarmed path retries, recovers, degrades and stalls nothing."""
    bad = {k: counters.get(k, 0) for k in RECOVERY if counters.get(k, 0)}
    check(not bad, f"{tag}: recovery counters on an unarmed path: {bad}")


def check_unarmed_stats(stats: dict, tag: str) -> None:
    for stage, st in stats.items():
        if hasattr(st, "metrics"):
            check_unarmed(st.metrics.counters, f"{tag} {stage}")


def pool_fields(counters: dict) -> dict:
    """The batch engine a stage ran with, and its recovery counters."""
    return {"overlap_pool_workers": counters.get("overlap_pool_workers", 0),
            "host_pool_workers": counters.get("host_pool_workers", 0),
            **{k: counters.get(k, 0) for k in RECOVERY}}


def stage_summary(stage: str, stats, wall: float) -> dict:
    """families/s, the seconds of every phase of one stage run, the route
    its device batches took, the bytes each way per device batch and the
    wire's resolved qual modes."""
    m = stats.metrics.seconds
    c = stats.metrics.counters
    device_batches = sum(v for k, v in c.items() if k.startswith("route_batches_"))
    check_unarmed(c, f"{stage} stage")
    return {
        "stage": stage, "families": stats.families,
        "families_per_s": stats.families / wall, "wall_s": wall,
        "records_in": stats.records_in, "records_out": stats.consensus_out,
        "batches": stats.batches, "skipped_families": stats.skipped_families,
        **{f"{k}_s": m.get(k, 0.0) for k in HOST_PHASES + DEVICE_PHASES},
        "genome_load_s": m.get("genome_load", 0.0),
        "sub_phases_s": {k: v for k, v in m.items() if "." in k},
        "ingest_native": c.get("ingest_native", 0),
        "group_native": c.get("group_native", 0),
        "route_batches_wire": c.get("route_batches_wire", 0),
        "route_batches_single": c.get("route_batches_single", 0),
        "h2d_bytes_per_batch": c.get("h2d_bytes", 0) / device_batches if device_batches else 0,
        "d2h_bytes_per_batch": c.get("d2h_bytes", 0) / device_batches if device_batches else 0,
        "wire_qual": {k[len("wire_qual_"):]: v for k, v in c.items() if k.startswith("wire_qual_")},
        **pool_fields(c),
        "stall_s": m.get("stall", 0.0), "spill_write_s": m.get("spill_write", 0.0),
    }


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def diff_records(a_path: str, b_path: str) -> tuple[int, int, str]:
    """(records, differing records, first difference) between two BAMs,
    record by record (the caller requires 0 differing)."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    n = ndiff = 0
    first = ""
    with BamReader(a_path) as ra, BamReader(b_path) as rb:
        for ra_rec, rb_rec in zip(ra, rb, strict=True):
            n += 1
            same = (
                ra_rec.qname == rb_rec.qname and ra_rec.flag == rb_rec.flag
                and ra_rec.pos == rb_rec.pos and ra_rec.seq == rb_rec.seq
                and ra_rec.cigar == rb_rec.cigar and ra_rec.qual == rb_rec.qual
                and ra_rec.tags == rb_rec.tags
            )
            if same:
                continue
            ndiff += 1
            if not first:
                first = f"{ra_rec.qname} flag {ra_rec.flag} pos {ra_rec.pos}"
    return n, ndiff, first


def check_deep_head(stats, tag: str) -> None:
    """The head's DEEP_HEAD families, per strand MI: those above
    MAX_TEMPLATES are routed deep (the JAX package's count, which includes
    the family past the cap), those past DEEP_TEMPLATE_CAP skipped and
    counted."""
    from bsseqconsensusreads_tpu_torch.ops.encode import MAX_TEMPLATES
    from bsseqconsensusreads_tpu_torch.pipeline.calling import DEEP_TEMPLATE_CAP

    c = stats.metrics.counters
    routed = 2 * sum(t > MAX_TEMPLATES for t in DEEP_HEAD)
    over = 2 * sum(t > DEEP_TEMPLATE_CAP for t in DEEP_HEAD)
    log(f"phase3 head deep {tag}: deep_routed_families {c.get('deep_routed_families', 0)}, "
        f"deep_skipped_families {c.get('deep_skipped_families', 0)}, "
        f"skipped_families {stats.skipped_families}")
    check(c.get("deep_routed_families", 0) == routed,
          f"head {tag}: {c.get('deep_routed_families', 0)} deep families routed, want {routed}")
    check(c.get("deep_skipped_families", 0) == over and stats.skipped_families >= over,
          f"head {tag}: the families past DEEP_TEMPLATE_CAP were not skipped and counted")


def main_path(torch, stages_io, fasta: str, transport: str, tag: str) -> tuple[dict, dict, dict]:
    """Both stages on the card, native engines, over `transport`: each
    stage under torch.profiler with the kernels' counts set to 0 just
    before and read just after. Returns (launches summed over the stages,
    per-stage summaries, seg_vote launches by shape)."""
    import collections

    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    launches = {}
    summaries = {}
    shapes = collections.Counter()
    for stage, inp, out in stages_io:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with PeakMemory(torch) as mem:
            stats, counts, wall = run_stage(stage, inp, out, fasta, "cuda", prof,
                                            engine="native", transport=transport)
        shapes.update(cuda_vote.SEG_VOTE_SHAPES)
        busy = device_busy_s(torch, prof)
        summary = {
            **stage_summary(stage, stats, wall), "transport": transport,
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
            "peak_host_rss_gib": mem.host_gib, "host_rss_at_start_gib": mem.host_start_gib,
            "peak_device_allocated_gib": mem.device_gib,
            "launches": counts, "sha256": sha256(out),
        }
        log(f"{tag} stage {json.dumps(summary)}")
        summaries[stage] = summary
        check(stats.families > 0 and stats.consensus_out > 0, f"{tag} {stage}: no output")
        check(summary["ingest_native"] == 1 and summary["group_native"] == 1,
              f"{tag} {stage}: the main path did not ingest through the native engine")
        check(counts["seg_vote"] > 0, f"{tag} {stage}: seg_vote never launched")
        route = "route_batches_wire" if transport == "wire" else "route_batches_single"
        other = "route_batches_single" if transport == "wire" else "route_batches_wire"
        check(summary[route] > 0 and summary[other] == 0,
              f"{tag} {stage}: the device batches did not all take the {transport} route")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches, summaries, shapes


def log_shapes(tag: str, shapes, case_shapes) -> None:
    """seg_vote's launches by (N, P, W, S), most frequent first, and
    whether the leading one is a Phase 2 case."""
    top = [[list(k), v] for k, v in shapes.most_common()]
    log(f"{tag} seg_vote shapes: {json.dumps(top)}")
    if top:
        log(f"{tag} most frequent shape {top[0][0]} is a phase-2 case: "
            f"{tuple(top[0][0]) in case_shapes}")


def phase3(np, torch, work: str, families: int, cpu_families: int, case_shapes):
    """Phase 3 (the unpacked main path), Phase 3w (the wire main path), the
    identity head and the qual tables. Returns (launches on both main
    paths, Phase 3's per-stage summaries, the inputs (data genome FASTA,
    grouped BAM, head BAM, human-scale genome FASTA))."""
    import collections

    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, reconstruct

    from concurrent.futures import ThreadPoolExecutor

    # the human-scale genome's filler contigs are written while the inputs
    # are, and Phase 6's raw inputs by a child process meanwhile (awaited
    # before any stage is measured); the data contig, the data genome, is
    # appended after
    t0 = time.monotonic()
    children = {kind: subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), f"--write-{kind}", work,
         "--families", str(families), "--cpu-families", str(cpu_families)],
        env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    ) for kind in ("raw", "indel")}
    try:
        with ThreadPoolExecutor(1) as pool:
            fillers = pool.submit(write_genome_fillers, np, work)
            fasta, big, small = write_inputs(np, work, families, cpu_families)
            log(f"phase3 input: {families} families written in {time.monotonic() - t0:.1f} s")
            genome = write_human_genome(np, fasta, *fillers.result())
        log(f"phase3 human-scale genome: {os.path.getsize(genome)} bytes, "
            f"{len(GRCH38_LENGTHS) + 1} contigs, written in {time.monotonic() - t0:.1f} s "
            "(beside the inputs)")
        errs = {kind: child.communicate(timeout=900)[1] for kind, child in children.items()}
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    for kind, phase in (("raw", 6), ("indel", 8)):
        log(f"phase{phase} {kind} input: {families} families (and the {kind} head) written by "
            f"a child process in {time.monotonic() - t0:.1f} s, rc {children[kind].returncode}")
        check(children[kind].returncode == 0,
              f"writing the {kind} inputs failed: {errs[kind].decode()[-2000:]}")

    def io(suffix):
        mol = os.path.join(work, f"molecular{suffix}.bam")
        return (("molecular", big, mol),
                ("duplex", mol, os.path.join(work, f"duplex{suffix}.bam")))

    # the main path (Phase 3) and the same input over the wire (Phase 3w),
    # in alternating order: molecular unpacked then wire, duplex wire then
    # unpacked. Each stage's kernel counts cover exactly that stage; the
    # qual tables are built inside the first (first use on this device)
    reconstruct._CACHE.clear()
    mol, dup = io(""), io("_wire")
    runs = [main_path(torch, mol[:1], genome, "unpacked", "phase3"),
            main_path(torch, dup[:1], genome, "wire", "phase3w"),
            main_path(torch, dup[1:], genome, "wire", "phase3w"),
            main_path(torch, mol[1:], genome, "unpacked", "phase3")]
    check(runs[0][0]["vote_finalize"] > 0, "molecular: vote_finalize never launched")
    launches, summaries, shapes = {}, {}, collections.Counter()
    wire_launches, wire_summaries, wire_shapes = {}, {}, collections.Counter()
    for (la, su, sh), (l_acc, s_acc, sh_acc) in zip(runs, [
            (launches, summaries, shapes), (wire_launches, wire_summaries, wire_shapes),
            (wire_launches, wire_summaries, wire_shapes), (launches, summaries, shapes)]):
        for k, v in la.items():
            l_acc[k] = l_acc.get(k, 0) + v
        s_acc.update(su)
        sh_acc.update(sh)
    log_shapes("phase3", shapes, case_shapes)
    log_shapes("phase3w", wire_shapes, case_shapes)
    for stage, wsum in wire_summaries.items():
        usum = summaries[stage]
        side = {
            "stage": stage,
            "families_per_s": {"wire": wsum["families_per_s"], "unpacked": usum["families_per_s"]},
            **{k: {"wire": wsum[k], "unpacked": usum[k]} for k in (
                "wall_s", *(f"{p}_s" for p in HOST_PHASES + DEVICE_PHASES), "genome_load_s",
                "h2d_bytes_per_batch", "d2h_bytes_per_batch", "device_idle_share",
                "peak_host_rss_gib", "host_rss_at_start_gib", "peak_device_allocated_gib",
                "route_batches_wire", "route_batches_single")},
            "sub_phases_s": {"wire": wsum["sub_phases_s"], "unpacked": usum["sub_phases_s"]},
            "wire_qual": wsum["wire_qual"],
            "same_sha256": wsum["sha256"] == usum["sha256"],
        }
        log(f"phase3w vs phase3 {json.dumps(side)}")
        check(side["same_sha256"], f"phase3w {stage}: the wire wrote other bytes than phase 3")
    for k, v in wire_launches.items():
        launches[k] = launches.get(k, 0) + v

    # on the head input, stage by stage on identical input: the card with
    # the native engines against the card with the Python engines, both
    # transports each (the same bytes required), and against the CPU
    runs = (("cuda", "native", "unpacked"), ("cuda", "python", "unpacked"),
            ("cuda", "native", "wire"), ("cuda", "python", "wire"),
            ("cpu", "native", "unpacked"), ("cpu", "native", "wire"))
    for stage, inp in (("molecular", small),
                       ("duplex", os.path.join(work, "mol_head_cuda_native_unpacked.bam"))):
        outs = {}
        for dev, engine, transport in runs:
            out = os.path.join(work, f"{stage[:3]}_head_{dev}_{engine}_{transport}.bam")
            stats, _counts, wall = run_stage(stage, inp, out, fasta, dev, engine=engine,
                                             transport=transport)
            outs[dev, engine, transport] = out
            log(f"phase3 head {stage} {dev} {engine} {transport}: {wall:.2f} s, "
                f"sha256 {sha256(out)}")
            if stage == "molecular":
                check_deep_head(stats, f"{dev} {engine} {transport}")
                if (dev, engine, transport) == runs[0]:
                    log_shapes("phase3 head molecular", cuda_vote.SEG_VOTE_SHAPES, case_shapes)
        ref = sha256(outs["cuda", "native", "unpacked"])
        for key in runs[1:4]:
            same = sha256(outs[key]) == ref
            log(f"phase3 head {stage}: card {key[1]} {key[2]} vs card native unpacked: "
                f"byte-identical={same}")
            check(same, f"{stage}: card {key[1]} {key[2]} wrote other bytes than native unpacked")
        same_cpu = sha256(outs["cpu", "native", "wire"]) == sha256(outs["cpu", "native", "unpacked"])
        log(f"phase3 head {stage}: cpu wire vs cpu unpacked: byte-identical={same_cpu}")
        check(same_cpu, f"{stage}: the wire on the CPU wrote other bytes than unpacked")
        for transport in ("unpacked", "wire"):
            card, cpu = outs["cuda", "native", transport], outs["cpu", "native", transport]
            n, ndiff, first = diff_records(card, cpu)
            same = sha256(card) == sha256(cpu)
            log(f"phase3 card-vs-cpu {stage} {transport}: {n} records, {ndiff} differ, "
                f"byte-identical={same}" + (f", first: {first}" if first else ""))
            check(n > 0, f"{stage}: the card-vs-CPU comparison saw no records")
            check(ndiff == 0 and same, f"{stage} {transport}: the card's BAM differs from the CPU's")

    params = ConsensusParams(min_reads=1)
    card = reconstruct.qual_tables(params, "cuda")
    host = reconstruct.qual_tables(params, "cpu")
    names = ("single", "agree", "disagree", "masked", "flip")
    for name, a, b in zip(names, card, host):
        a, b = np.asarray(a), np.asarray(b)
        d = int((a != b).sum())
        if name in ("masked", "flip"):
            log(f"phase3 qual table {name}: {d} verdicts differ")
            check(d == 0, f"qual table {name}: card and CPU verdicts differ")
            continue
        log(f"phase3 qual table {name}: {d} entries differ")
        if d:
            idx = np.argwhere(a != b)[:10].tolist()
            log(f"phase3 qual table {name}: differing entries {idx}")
        check(d == 0, f"qual table {name}: {d} entries differ between card and CPU")
    return launches, (summaries, wire_summaries), (fasta, big, small, genome)


# ---------------------------------------------------------------- phase 4


def same_records(a_path: str, b_path: str) -> tuple[bool, int, list, list]:
    """(record streams identical, decompressed record bytes compared,
    header lines of a, header lines of b): the bytes after each header,
    read through the native codec in 1 MiB chunks."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    n = 0
    with BamReader(a_path) as ra, BamReader(b_path) as rb:
        heads = ra.header.text.splitlines(), rb.header.text.splitlines()
        if ra.header.references != rb.header.references:
            return False, 0, *heads
        while True:
            ca, cb = ra._bgzf.read(1 << 20), rb._bgzf.read(1 << 20)
            if ca != cb:
                return False, n, *heads
            if not ca:
                return True, n, *heads
            n += len(ca)


def family_of(blob: bytes) -> int:
    """The generator family of an encoded record: its qname is the
    family's `f<family>:<strand>:<template>` in the inputs, `<family>/<strand>`
    or `<family>` in the consensus outputs."""
    q = blob[36:36 + blob[12] - 1]
    if q[:1] == b"f":
        return int(q[1:q.index(b":")])
    return int(q.split(b"/")[0])


def family_subset(src: str, dst: str, limit: int) -> str:
    """The records of `src` whose family is below `limit`, in order,
    written to `dst` under `src`'s header (a depth cut of a path: the
    generator places families independently, so a family's records are
    the same in the cut as in the whole)."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter

    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with BamReader(src) as r, BamWriter(dst, r.header, level=1) as w:
        w.write_raw_many(b for b in r.raw_records() if family_of(b) < limit)
    return dst


def same_family_records(path: str, ref: str, limit: int) -> tuple[bool, int, dict]:
    """(path's records equal, in order, to ref's records of the families
    below `limit`; records compared; header lines that differ apart from
    @PG)."""
    import itertools

    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    n = 0
    with BamReader(path) as a, BamReader(ref) as b:
        hdiff = header_difference(a.header.text.splitlines(), b.header.text.splitlines())
        want = (x for x in b.raw_records() if family_of(x) < limit)
        for x, y in itertools.zip_longest(a.raw_records(), want):
            if x != y:
                return False, n, hdiff
            n += 1
    return n > 0, n, hdiff


def header_difference(a: list, b: list) -> dict:
    """Header lines of a and b apart from @PG: the ones only one side has."""
    a = [ln for ln in a if not ln.startswith("@PG")]
    b = [ln for ln in b if not ln.startswith("@PG")]
    return {"only_run": [ln for ln in a if ln not in b], "only_phase3": [ln for ln in b if ln not in a]}


def run_cli(argv: list[str]) -> tuple[dict, list[str]]:
    """cli.main(argv) with its stdout JSON and stderr lines captured."""
    import contextlib
    import io

    from bsseqconsensusreads_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    check(rc == 0, f"run exited {rc}")
    doc = json.loads(out.getvalue().strip().splitlines()[-1])
    for stage, st in doc.get("stats", {}).items():
        if "batches_retried" in st:
            check_unarmed(st, f"{argv[0]} {stage}")
    return doc, err.getvalue().splitlines()


def phase4(np, torch, work: str, inputs, phase3_summaries: dict, case_shapes=frozenset()) -> dict:
    """`run` — the system's entry point — on the card: 4a the main path
    at Phase 3's input, 4b a SIGKILLed checkpointed run resumed in a new
    process, 4c aligner 'none' on the card and on the CPU. Returns the
    kernels' launches on 4a's main path."""
    fasta, big, small, genome = inputs
    launches = phase4a(torch, work, genome, big, phase3_summaries, case_shapes)
    phase4b(work, fasta, small)
    phase4c(work, fasta, small)
    return launches


def phase4a(torch, work: str, fasta: str, big: str, phase3_summaries: dict,
            case_shapes=frozenset()) -> dict:
    import collections

    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, reconstruct
    from bsseqconsensusreads_tpu_torch.pipeline import stages

    outdir = os.path.join(work, "run")
    per_stage: dict = {}
    shapes = collections.Counter()
    originals = {name: getattr(stages.PipelineBuilder, name)
                 for name in ("run_molecular", "run_duplex")}

    def observed(name):
        """The stage body under torch.profiler, with its launches and wall
        (the trace is read after the run, outside the rule's seconds)."""
        def body(self, rule, mode):
            stage = name.split("_", 1)[1]
            before = dict(cuda_vote.LAUNCHES)
            shapes_before = collections.Counter(cuda_vote.SEG_VOTE_SHAPES)
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            t0 = time.monotonic()
            with PeakMemory(torch) as mem, prof:
                originals[name](self, rule, mode)
            wall = time.monotonic() - t0
            shapes.update(cuda_vote.SEG_VOTE_SHAPES - shapes_before)
            per_stage[stage] = (self.stats[stage], wall, prof, mem,
                                {k: v - before[k] for k, v in cuda_vote.LAUNCHES.items()})
        return body

    # the main path: counts set to 0 just before, read just after; the
    # qual tables are built again inside it (first use on this device)
    reconstruct._CACHE.clear()
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    cuda_vote.SEG_VOTE_SHAPES.clear()
    argv = ["run", "--bam", big, "--reference", fasta, "--outdir", outdir]
    try:
        for name in originals:
            setattr(stages.PipelineBuilder, name, observed(name))
        t0 = time.monotonic()
        doc, err = run_cli(argv)
        run_wall = time.monotonic() - t0
    finally:
        for name, fn in originals.items():
            setattr(stages.PipelineBuilder, name, fn)
    launches = dict(cuda_vote.LAUNCHES)
    rules = [ln for ln in err if ln.startswith(("[ran]", "[skip]"))]
    log(f"phase4a run: {run_wall:.3f} s; rules: {json.dumps(rules)}")
    RUN4A.update(doc=doc, rules=rules, wall=run_wall, outdir=outdir)
    log(f"phase4a stdout stats: {json.dumps(doc['stats'])}")
    for stage, (stats, wall, prof, mem, counts) in per_stage.items():
        busy = device_busy_s(torch, prof)
        summary = {
            **stage_summary(stage, stats, wall),
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
            "peak_host_rss_gib": mem.host_gib, "host_rss_at_start_gib": mem.host_start_gib,
            "peak_device_allocated_gib": mem.device_gib,
            "launches": counts,
            "phase3_families_per_s": phase3_summaries[stage]["families_per_s"],
        }
        log(f"phase4a stage {json.dumps(summary)}")
        route = "wire" if summary["route_batches_single"] == 0 else (
            "unpacked" if summary["route_batches_wire"] == 0 else "both")
        log(f"phase4a route {stage}: {route} ({summary['route_batches_wire']} wire, "
            f"{summary['route_batches_single']} unpacked device batches)")
        check(counts["seg_vote"] > 0, f"run {stage}: seg_vote never launched")
        check(route == "wire" and summary["route_batches_wire"] > 0,
              f"run {stage}: transport 'auto' on the card did not take the wire")
    check(set(per_stage) == {"molecular", "duplex"}, f"run drove stages {sorted(per_stage)}")
    check(launches["vote_finalize"] > 0, "run: vote_finalize never launched")
    check(doc["stats"]["molecular"]["deep_skipped_families"] == 0,
          "run: deep families were skipped")
    top = [[list(k), v] for k, v in shapes.most_common()]
    log(f"phase4a seg_vote shapes: {json.dumps(top)}")
    for shape, _n in top[:2]:
        log(f"phase4a shape {shape} is a phase-2 case: {tuple(shape) in case_shapes}")

    target = doc["target"]
    inter = os.path.join(outdir, "grouped_consensus_unfiltered_aunamerged_aligned.bam")
    check(target == os.path.join(outdir, "grouped_consensus_duplex_unfiltered.bam"),
          f"run target {target}")
    for name, path, ref in (("intermediate", inter, "molecular.bam"),
                            ("target", target, "duplex.bam")):
        same, nbytes, h_run, h_ref = same_records(path, os.path.join(work, ref))
        hdiff = header_difference(h_run, h_ref)
        log(f"phase4a {name} vs phase 3's {ref}: records identical={same} "
            f"({nbytes} decompressed bytes), header lines apart from @PG that differ: "
            f"{json.dumps(hdiff)}, run's @PG: {json.dumps([ln for ln in h_run if ln.startswith('@PG')])}")
        check(same, f"run {name}: records differ from phase 3's {ref}")
        check(not hdiff["only_run"] and not hdiff["only_phase3"],
              f"run {name}: header differs from phase 3's beyond @PG")

    # a second identical run: both rules up to date, the target untouched
    before = (sha256(target), os.path.getmtime(target))
    doc2, err2 = run_cli(argv)
    rules2 = [ln for ln in err2 if ln.startswith(("[ran]", "[skip]"))]
    log(f"phase4a second run: {json.dumps(rules2)}")
    check(len(rules2) == 2 and all(ln.startswith("[skip]") and ln.endswith("up to date")
                                   for ln in rules2), "second run re-ran a rule")
    check((sha256(target), os.path.getmtime(target)) == before and doc2["target"] == target,
          "second run changed the target")
    return launches


#: Phase 4a's run (its stdout document, rule lines, wall and outdir):
#: Phase 7 compares against it
RUN4A: dict = {}


RESUME_CHILD = r"""
import json, os, sys
from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline
fasta, bam, outdir, batch_families, methyl = sys.argv[1:6]
cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta), genome_fasta_file_name=os.path.basename(fasta),
                      checkpoint_every=1, batch_families=int(batch_families), methyl=methyl)
target, results, stats = run_pipeline(cfg, bam, outdir=outdir)
print(json.dumps({"target": target, "batches": {k: s.batches for k, s in stats.items()},
                  "counters": {k: s.metrics.counters for k, s in stats.items()},
                  "rules": [[r.name, r.ran, r.reason] for r in results]}))
"""


def kill_mid_stage(cmd: list, stage_target: str, tag: str) -> dict:
    """Run the checkpointed child `cmd` and SIGKILL it once the stage
    writing `stage_target` has made >= 2 batches durable and before the
    target exists; fails unless the kill landed there. Returns the
    manifest as the kill left it."""
    import signal

    manifest = stage_target + ".ckpt.json"
    env = {**os.environ, "PYTHONPATH": REPO}
    child = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    seen = None
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and child.poll() is None:
            try:
                with open(manifest) as fh:
                    done = json.load(fh)["batches_done"]
            except (OSError, ValueError, KeyError):
                done = 0
            if done >= 2 and not os.path.exists(stage_target):
                child.send_signal(signal.SIGKILL)
                seen = done
                break
            time.sleep(0.002)
    finally:
        if child.poll() is None and seen is None:
            child.kill()
        _out, err = child.communicate(timeout=120)
    log(f"{tag} kill: returncode {child.returncode}, batches durable when sent {seen}")
    with open(manifest) as fh:
        at_kill = json.load(fh)
    check(seen is not None and child.returncode == -signal.SIGKILL,
          f"{tag}: the kill did not land mid-stage (child rc {child.returncode}): "
          f"{err.decode()[-2000:]}")
    check(at_kill["batches_done"] >= 2 and not os.path.exists(stage_target),
          f"{tag}: the killed run left no durable batches or a finished target")
    return at_kill


def phase4b(work: str, fasta: str, small: str, batch_families: int = 16) -> None:
    """Crash and resume on the card: a child process runs the checkpointed
    pipeline, is SIGKILLed once the molecular stage has made >= 2 batches
    durable (and before its target exists), and a second child resumes.
    The target must be SHA-equal to an uninterrupted run of the same
    config, and the resumed molecular stage must run fewer batches."""
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline

    cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta),
                          genome_fasta_file_name=os.path.basename(fasta),
                          checkpoint_every=1, batch_families=batch_families)
    t0 = time.monotonic()
    whole, _results, whole_stats = run_pipeline(cfg, small, outdir=os.path.join(work, "ck_whole"))
    check_unarmed_stats(whole_stats, "phase4b")
    log(f"phase4b uninterrupted: {time.monotonic() - t0:.2f} s, batches "
        f"{ {k: s.batches for k, s in whole_stats.items()} }, sha256 {sha256(whole)}")

    outdir = os.path.join(work, "ck_crash")
    stage_target = os.path.join(outdir, "grouped_head_consensus_unfiltered_aunamerged_aligned.bam")
    cmd = [sys.executable, "-c", RESUME_CHILD, fasta, small, outdir, str(batch_families), "off"]
    at_kill = kill_mid_stage(cmd, stage_target, "phase4b")

    t0 = time.monotonic()
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"the resumed run failed: {res.stderr[-2000:]}")
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"phase4b resume: {time.monotonic() - t0:.2f} s, manifest at kill "
        f"{at_kill['batches_done']} batches, resumed batches {doc['batches']}, "
        f"rules {json.dumps(doc['rules'])}, sha256 {sha256(doc['target'])}")
    check(sha256(doc["target"]) == sha256(whole), "the resumed target differs from the uninterrupted run")
    check(doc["batches"]["molecular"] < whole_stats["molecular"].batches,
          "the resumed molecular stage did not skip its durable batches")


def phase4c(work: str, fasta: str, small: str) -> None:
    """aligner 'none' at the head on the card and on the CPU: the FASTQs
    must be equal (the card-vs-CPU contract)."""
    import gzip

    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline

    fqs = {}
    for backend in ("cuda", "cpu"):
        cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta),
                              genome_fasta_file_name=os.path.basename(fasta),
                              aligner="none", backend=backend)
        fq1, _results, _stats = run_pipeline(cfg, small, outdir=os.path.join(work, f"none_{backend}"))
        check_unarmed_stats(_stats, f"phase4c {backend}")
        fqs[backend] = [fq1, fq1.replace("_1.fq.gz", "_2.fq.gz")]
    for mate in (0, 1):
        with gzip.open(fqs["cuda"][mate], "rt") as fa, gzip.open(fqs["cpu"][mate], "rt") as fb:
            la, lb = fa.read().splitlines(), fb.read().splitlines()
        check(len(la) == len(lb) and la, f"fastq {mate + 1}: line counts differ")
        diff_lines = diff_quals = max_abs = 0
        for i, (x, y) in enumerate(zip(la, lb)):
            if x == y:
                continue
            diff_lines += 1
            check(i % 4 == 3 and len(x) == len(y), f"fastq {mate + 1} line {i + 1} differs beyond quals")
            d = [abs(ord(p) - ord(q)) for p, q in zip(x, y) if p != q]
            diff_quals += len(d)
            max_abs = max(max_abs, *d)
        log(f"phase4c fastq {mate + 1}: {len(la) // 4} entries, card vs cpu: "
            f"{diff_lines} qual lines differ, {diff_quals} quals, max |diff| {max_abs}")
        check(diff_lines == 0, f"fastq {mate + 1}: the card's FASTQ differs from the CPU's")


# ---------------------------------------------------------------- phase 5


def run_duplex_cli(argv: list[str]) -> tuple[dict, dict, float]:
    """cli.main(["duplex", ...]) with its stderr captured: (the methyl
    report, the stage's stats line, wall seconds of the command)."""
    import contextlib
    import io

    from bsseqconsensusreads_tpu_torch import cli

    err = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.monotonic() - t0
    check(rc == 0, f"duplex exited {rc}")
    lines = [json.loads(ln) for ln in err.getvalue().splitlines() if ln.startswith("{")]
    reports = [ln["methyl"] for ln in lines if "methyl" in ln]
    check(len(reports) == 1, "duplex --methyl printed no methyl report")
    check_unarmed(lines[-1], "duplex --methyl")
    return reports[0], lines[-1], wall


def methyl_argv(inp: str, out: str, fasta: str, device: str, transport: str,
                engine: str = "auto") -> list[str]:
    """The duplex subcommand with --methyl both, at Phase 3's stage
    settings (mode self, 2048 families per batch, grouping coordinate)."""
    return ["duplex", "-i", inp, "-o", out, "--reference", fasta, "--mode", "self",
            "--batch-families", "2048", "--grouping", "coordinate", "--device", device,
            "--transport", transport, "--methyl", "both", "--methyl-engine", engine]


def phase5(np, torch, work: str, inputs, phase3_summaries, cut: int) -> dict:
    """Methylation, fused into the duplex stage: 5a/5b over the wire and
    unpacked (the main paths) on Phase 3's molecular families below `cut`
    (a quarter of --families: the run's time limit), 5c the head on
    the card and the CPU with both methyl engines and one batch's planes
    against the numpy twin, 5d a SIGKILLed checkpointed `run` with methyl
    resumed. Returns the kernels' launches on 5a and 5b."""
    fasta, _big, small, genome = inputs
    launches = phase5ab(torch, work, genome, phase3_summaries, cut)
    phase5c(np, torch, work, fasta)
    phase5d(work, fasta, small)
    return launches


def phase5ab(torch, work: str, genome: str, phase3_summaries, cut: int) -> dict:
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    p3, p3w = phase3_summaries
    t0 = time.monotonic()
    mol = family_subset(os.path.join(work, "molecular.bam"),
                        os.path.join(work, "cut", "molecular.bam"), cut)
    log(f"phase5 input: phase 3's molecular families below {cut} "
        f"({time.monotonic() - t0:.1f} s)")
    launches: dict = {}
    rows = {}
    for tag, transport, ref_bam in (("5a", "auto", "duplex_wire.bam"),
                                    ("5b", "unpacked", "duplex.bam")):
        out = os.path.join(work, f"methyl_{tag}.bam")
        for k in cuda_vote.LAUNCHES:
            cuda_vote.LAUNCHES[k] = 0
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        with PeakMemory(torch) as mem, prof:
            report, st, wall = run_duplex_cli(methyl_argv(mol, out, genome, "cuda", transport))
        counts = dict(cuda_vote.LAUNCHES)
        busy = device_busy_s(torch, prof)
        batches = st.get("route_batches_wire", 0) + st.get("route_batches_single", 0)
        row = {
            "phase": tag, "transport": transport, "families": st["families"],
            "families_per_s": st["families"] / wall, "wall_s": wall,
            "stage_wall_s": st["wall_seconds"],
            "methyl_s": st.get("methyl_seconds", 0.0),
            "finalize_s": {k: st.get(f"methyl_finalize{k}_seconds", 0.0)
                           for k in ("", ".merge", ".bedmethyl", ".cx")},
            "genome_load_s": {k: st.get(f"genome_load{k}_seconds", 0.0)
                              for k in ("", ".read", ".upload")},
            "unique_sites": report["sites"], "spill_runs": st.get("methyl_spill_runs", 0),
            "route_batches_wire": st.get("route_batches_wire", 0),
            "route_batches_single": st.get("route_batches_single", 0),
            "h2d_bytes_per_batch": st.get("h2d_bytes", 0) / batches if batches else 0,
            "d2h_bytes_per_batch": st.get("d2h_bytes", 0) / batches if batches else 0,
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
            "peak_host_rss_gib": mem.host_gib, "host_rss_at_start_gib": mem.host_start_gib,
            "peak_device_allocated_gib": mem.device_gib, "launches": counts,
            "sha256": {k: sha256(p) for k, p in (
                ("bam", out), ("bed", report["bed"]), ("cx", report["cx"]))},
        }
        log(f"phase{tag} methyl {json.dumps(row)}")
        rows[tag] = row
        same, n, hdiff = same_family_records(out, os.path.join(work, ref_bam), cut)
        log(f"phase{tag} duplex BAM vs phase 3's {ref_bam} (its families below {cut}): "
            f"{n} records identical={same}, header lines that differ: {json.dumps(hdiff)}")
        check(same and not hdiff["only_run"] and not hdiff["only_phase3"],
              f"phase{tag}: methyl changed the consensus BAM")
        check(report["sites"] > 0, f"phase{tag}: no methylation sites")
        check(counts["seg_vote"] > 0, f"phase{tag}: seg_vote never launched")
        route = "route_batches_wire" if transport == "auto" else "route_batches_single"
        check(row[route] > 0 and row[route] == batches,
              f"phase{tag}: the device batches did not all take the {transport} route")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    a, b = rows["5a"]["sha256"], rows["5b"]["sha256"]
    log(f"phase5b vs phase5a: bedMethyl identical={a['bed'] == b['bed']}, "
        f"CX identical={a['cx'] == b['cx']}")
    check(a["bed"] == b["bed"] and a["cx"] == b["cx"],
          "phase5: the wire and the unpacked route wrote other methylation files")
    side = {
        "families_per_s": {
            "5a_methyl_wire": rows["5a"]["families_per_s"],
            "3w_duplex_wire": p3w["duplex"]["families_per_s"],
            "5b_methyl_unpacked": rows["5b"]["families_per_s"],
            "3_duplex_unpacked": p3["duplex"]["families_per_s"],
        },
        "wire_ratio_5a_over_3w": rows["5a"]["families_per_s"] / p3w["duplex"]["families_per_s"],
        "unpacked_ratio_5b_over_3": rows["5b"]["families_per_s"] / p3["duplex"]["families_per_s"],
        "h2d_bytes_per_batch": {"5a": rows["5a"]["h2d_bytes_per_batch"],
                                "3w": p3w["duplex"]["h2d_bytes_per_batch"],
                                "5b": rows["5b"]["h2d_bytes_per_batch"],
                                "3": p3["duplex"]["h2d_bytes_per_batch"]},
        "d2h_bytes_per_batch": {"5a": rows["5a"]["d2h_bytes_per_batch"],
                                "3w": p3w["duplex"]["d2h_bytes_per_batch"],
                                "5b": rows["5b"]["d2h_bytes_per_batch"],
                                "3": p3["duplex"]["d2h_bytes_per_batch"]},
    }
    log(f"phase5 vs phase3 {json.dumps(side)}")
    return launches


def head_batch(np, inp: str, fasta: str, families: int = 2048):
    """The first `families` duplex families of a molecular BAM, encoded as
    the duplex stage encodes them, with their extension windows:
    (batch, ref_ext)."""
    import itertools

    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
    from bsseqconsensusreads_tpu_torch.ops.encode import encode_duplex_families
    from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore
    from bsseqconsensusreads_tpu_torch.pipeline.calling import stream_mi_groups

    with BamReader(inp) as r, FastaFile(fasta) as fa:
        names = [n for n, _ in r.header.references]
        groups = list(itertools.islice(
            stream_mi_groups(r, strip_suffix=True, grouping="coordinate"), families))
        batch, _left, _skipped = encode_duplex_families(groups, fa.fetch, names)
    store = RefStore.from_fasta(fasta)
    rid_map = store.contig_indices(names)
    rid = np.array([m.ref_id for m in batch.meta], np.int64)
    valid = (rid >= 0) & (rid < len(rid_map))
    mapped = np.where(valid, rid_map[np.where(valid, rid, 0)], -1)
    ws = np.array([m.window_start for m in batch.meta], np.int64)
    starts, limits = store.window_offsets(mapped, ws)
    ref_ext = store.host_windows_ext(starts, store.window_origins(mapped), limits,
                                     batch.bases.shape[-1] + 4)
    return batch, ref_ext


def profiled_device_ms(torch, fn, repeats: int) -> float | str:
    """Device time per call of fn: the summed durations of every kernel
    the card ran in a torch.profiler trace of `repeats` calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(spans) / repeats / 1e3 if spans else "not measured"


def phase5c(np, torch, work: str, fasta: str) -> None:
    """The head through duplex --methyl both on the card over the wire and
    unpacked and on the CPU with both methyl engines: the same bedMethyl
    and CX bytes and Phase 3's head BAM. Then one batch: the card's
    epilogue planes against the numpy twin's and the CPU's, and the
    epilogue's device time per batch."""
    from bsseqconsensusreads_tpu_torch.methyl.context import (
        methyl_epilogue,
        methyl_epilogue_host,
    )
    from bsseqconsensusreads_tpu_torch.models.duplex import duplex_call_pipeline
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams

    inp = os.path.join(work, "mol_head_cuda_native_unpacked.bam")
    want_bam = sha256(os.path.join(work, "dup_head_cuda_native_unpacked.bam"))
    shas = {}
    for dev, transport, engine in (("cuda", "wire", "device"), ("cuda", "unpacked", "device"),
                                   ("cpu", "unpacked", "device"), ("cpu", "unpacked", "host")):
        out = os.path.join(work, f"methyl_head_{dev}_{transport}_{engine}.bam")
        report, st, wall = run_duplex_cli(methyl_argv(inp, out, fasta, dev, transport, engine))
        shas[dev, transport, engine] = (sha256(report["bed"]), sha256(report["cx"]))
        log(f"phase5c head {dev} {transport} {engine}: {wall:.2f} s, sites {report['sites']}, "
            f"methyl {st.get('methyl_seconds', 0.0)} s, bed/cx sha256 "
            f"{json.dumps(shas[dev, transport, engine])}")
        check(sha256(out) == want_bam, f"phase5c {dev} {transport} {engine}: the BAM "
              "differs from phase 3's head duplex BAM")
    check(len(set(shas.values())) == 1,
          "phase5c: the methylation files differ across card/CPU, transports or engines")
    log("phase5c head: bedMethyl and CX identical across card wire, card unpacked, "
        "CPU unpacked and the host engine")

    batch, ref_ext = head_batch(np, inp, fasta)
    dev = torch.device("cuda")
    tens = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        batch.bases, batch.quals.astype(np.int16), batch.cover, batch.ref, batch.convert_mask,
        batch.extend_eligible, ref_ext)]
    bases, quals, cover, ref, cm, el, ext = tens
    params = ConsensusParams(min_reads=0)
    cons = duplex_call_pipeline(bases, quals, cover, ref, cm, el, params=params)["base"]
    card = methyl_epilogue(bases, quals, cover, cm, cons, ext, 0).cpu().numpy()
    host = methyl_epilogue_host(batch.bases, batch.quals, batch.cover, batch.convert_mask,
                                cons.cpu().numpy(), ref_ext, 0)
    cpu = methyl_epilogue(*(t.cpu() for t in (bases, quals, cover, cm, cons, ext)), 0).numpy()
    f, w = batch.bases.shape[0], batch.bases.shape[-1]
    differ = int((card != host).sum())
    log(f"phase5c one batch [{f}, 4, {w}]: card planes vs numpy twin: {differ} bytes differ, "
        f"vs torch on the CPU: {int((card != cpu).sum())}; sites {int((card[:, 0] != 0).sum())}")
    check(differ == 0 and np.array_equal(card, cpu),
          "phase5c: the card's epilogue planes differ from the numpy twin's")

    def epilogue():
        return methyl_epilogue(bases, quals, cover, cm, cons, ext, 0)

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    events_ms = time_ms(torch, epilogue, 20, flush)
    prof_ms = profiled_device_ms(torch, epilogue, 20)
    nbytes = f * 4 * w * (1 + 2 + 1) + f * 4 + f * 2 * w + f * (w + 4) + f * 2 * w
    log(f"phase5c epilogue per batch [{f}, 4, {w}]: events {events_ms:.6f} ms, device time "
        f"(torch.profiler, every kernel) {prof_ms} ms, byte bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms ({nbytes} bytes)")


def phase5d(work: str, fasta: str, small: str, batch_families: int = 64) -> None:
    """A checkpointed `run` with methyl 'both' on the head, SIGKILLed once
    the duplex stage has made >= 2 batches durable, resumed in a new
    process: bedMethyl, CX and target SHA-equal to an uninterrupted run,
    and the resumed stage spilled at least one run."""
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline

    cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta),
                          genome_fasta_file_name=os.path.basename(fasta),
                          checkpoint_every=1, batch_families=batch_families, methyl="both")
    t0 = time.monotonic()
    whole, _results, whole_stats = run_pipeline(cfg, small, outdir=os.path.join(work, "mck_whole"))
    check_unarmed_stats(whole_stats, "phase5d")
    want = {k: sha256(whole + k) for k in ("", ".bedmethyl", ".CX_report.txt")}
    log(f"phase5d uninterrupted: {time.monotonic() - t0:.2f} s, duplex batches "
        f"{whole_stats['duplex'].batches}, spill runs "
        f"{whole_stats['duplex'].metrics.counters.get('methyl_spill_runs', 0)}, "
        f"sha256 {json.dumps(want)}")

    outdir = os.path.join(work, "mck_crash")
    target = os.path.join(outdir, "grouped_head_consensus_duplex_unfiltered.bam")
    cmd = [sys.executable, "-c", RESUME_CHILD, fasta, small, outdir, str(batch_families), "both"]
    at_kill = kill_mid_stage(cmd, target, "phase5d")
    with open(target + ".bedmethyl.methyl.runs.json") as fh:
        runs = json.load(fh)["runs"]
    log(f"phase5d at the kill: {at_kill['batches_done']} duplex batches durable, methyl runs "
        f"up to {[r['upto'] for r in runs]}")
    env = {**os.environ, "PYTHONPATH": REPO}
    t0 = time.monotonic()
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"phase5d: the resumed run failed: {res.stderr[-2000:]}")
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    got = {k: sha256(doc["target"] + k) for k in ("", ".bedmethyl", ".CX_report.txt")}
    spills = doc["counters"]["duplex"].get("methyl_spill_runs", 0)
    log(f"phase5d resume: {time.monotonic() - t0:.2f} s, resumed batches {doc['batches']}, "
        f"spill runs {spills}, rules {json.dumps(doc['rules'])}, sha256 {json.dumps(got)}")
    check(got == want, "phase5d: the resumed run's target or methylation files differ")
    check(spills >= 1, "phase5d: the resumed duplex stage spilled no methyl run")
    check(doc["batches"]["duplex"] < whole_stats["duplex"].batches,
          "phase5d: the resumed duplex stage did not skip its durable batches")


# ---------------------------------------------------------------- phase 6


#: the rules `run` must drive on a raw BAM with a filter, in order
RAW_RULES = ("group_reads_by_umi", "call_consensus_molecular_tpu", "call_duplex_tpu",
             "filter_consensus_duplex")
RAW_FILTER = {"min_reads": [2, 1, 1]}


def strip_tag(blob: bytes, key: bytes) -> bytes:
    """An encoded record blob (with its block_size prefix) with the tag
    `key` cut out of its tag region, block_size fixed."""
    import struct

    from bsseqconsensusreads_tpu_torch.io.bam import skip_tag, tag_region_offset

    off, n = tag_region_offset(blob), len(blob)
    while off < n:
        end = skip_tag(blob, off)
        if blob[off:off + 2] == key:
            body = blob[4:off] + blob[end:]
            return struct.pack("<i", len(body)) + body
        off = end
    return blob


def record_multiset(path: str, key: bytes, limit: int | None = None) -> tuple[list, list]:
    """(header lines apart from @PG, the sorted encoded records with the
    tag `key` set aside — of the families below `limit` when given) of a
    BAM."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    with BamReader(path) as r:
        lines = [ln for ln in r.header.text.splitlines() if not ln.startswith("@PG")]
        return lines, sorted(strip_tag(b, key) for b in r.raw_records()
                             if limit is None or family_of(b) < limit)


def mi_partition(path: str) -> tuple[int, int, int, int]:
    """Over a grouped BAM whose qnames are the generator's
    f'f{fam}:{strand}:{ti}': (records, MIs, (family, strand) pairs,
    records whose MI is not f'{fam}/{strand}'). The partition holds when
    every MI is one (family, strand) and every pair one MI: then MIs ==
    pairs and the two maps agree, which the caller checks."""
    from bsseqconsensusreads_tpu_torch.io import native
    from bsseqconsensusreads_tpu_torch.pipeline import ingest

    native.lib()
    pair_of_mi: dict = {}
    mi_of_pair: dict = {}
    n = differ = clash = 0
    for rec in ingest.columnar_records(path):
        n += 1
        fam, strand, _ti = rec.qname.split(":")
        pair = f"{fam[1:]}/{strand}"
        mi = str(rec.get_tag("MI"))
        differ += mi != pair
        if pair_of_mi.setdefault(mi, pair) != pair or mi_of_pair.setdefault(pair, mi) != mi:
            clash += 1
    check(clash == 0, f"{path}: {clash} records break the MI partition")
    return n, len(pair_of_mi), len(mi_of_pair), differ


def cli_io(argv: list[str]) -> tuple[str, str]:
    """cli.main(argv) (exit 0 required) with its stdout and stderr."""
    import contextlib
    import io

    from bsseqconsensusreads_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    check(rc == 0, f"{argv[0]} exited {rc}")
    return out.getvalue(), err.getvalue()


def phase6(np, torch, work: str, inputs, phase3_summaries: dict, families: int,
           cpu_families: int) -> dict:
    """The raw-BAM entry: 6a `run` on the raw BAM's families below
    `families` (an eighth of --families: a depth cut for the run's time
    limit; the main path: grouping, both consensus stages, the consensus
    filter), 6b the
    raw head through `run` on the card and the CPU with the `group`,
    `sort` and `metrics` subcommands, 6c `duplex --passthrough` on the
    head with leftover records. Returns the kernels' launches on 6a."""
    fasta, _big, _small, genome = inputs
    t0 = time.monotonic()
    launches = phase6a(torch, work, genome, phase3_summaries, families)
    t1 = time.monotonic()
    phase6b(work, fasta, cpu_families + len(DEEP_HEAD))
    t2 = time.monotonic()
    phase6c(work, fasta)
    log(f"phase6 seconds: 6a {t1 - t0:.1f}, 6b {t2 - t1:.1f}, 6c {time.monotonic() - t2:.1f}")
    return launches


def phase6a(torch, work: str, genome: str, phase3_summaries: dict, families: int) -> dict:
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, reconstruct
    from bsseqconsensusreads_tpu_torch.pipeline import stages

    t0 = time.monotonic()
    raw = family_subset(os.path.join(work, "raw.bam"), os.path.join(work, "cut", "raw.bam"),
                        families)
    log(f"phase6a input: the raw families below {families} ({time.monotonic() - t0:.1f} s)")
    outdir = os.path.join(work, "raw_run")
    bodies = {"run_group": "group", "run_molecular": "molecular", "run_duplex": "duplex",
              "run_filter_duplex": "filter"}
    originals = {name: getattr(stages.PipelineBuilder, name) for name in bodies}
    per_rule: dict = {}

    def observed(name):
        """The rule body under torch.profiler (the card's activity) and
        PeakMemory, with its launches and wall."""
        def body(self, rule, *args, **kw):
            before = dict(cuda_vote.LAUNCHES)
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            t0 = time.monotonic()
            with PeakMemory(torch) as mem, prof:
                originals[name](self, rule, *args, **kw)
            per_rule[bodies[name]] = (time.monotonic() - t0, prof, mem,
                                      {k: v - before[k] for k, v in cuda_vote.LAUNCHES.items()})
        return body

    cfg = FrameworkConfig(genome_dir=os.path.dirname(genome),
                          genome_fasta_file_name=os.path.basename(genome), filter=RAW_FILTER)
    # the main path: counts set to 0 just before, read just after; the
    # qual tables are built again inside it (first use on this device)
    reconstruct._CACHE.clear()
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    try:
        for name in originals:
            setattr(stages.PipelineBuilder, name, observed(name))
        t0 = time.monotonic()
        target, results, stats = stages.run_pipeline(cfg, raw, outdir=outdir)
        run_wall = time.monotonic() - t0
        check_unarmed_stats(stats, "phase6a")
    finally:
        for name, fn in originals.items():
            setattr(stages.PipelineBuilder, name, fn)
    launches = dict(cuda_vote.LAUNCHES)
    rules = {r.name: r.seconds for r in results}
    log(f"phase6a run: {run_wall:.3f} s; rule seconds {json.dumps(rules)}")
    check(tuple(r.name for r in results) == RAW_RULES and all(r.ran for r in results),
          f"phase6a: run drove {[(r.name, r.ran) for r in results]}")
    gs, fs = stats["group"].as_dict(), stats["filter"].as_dict()
    for rule, (wall, prof, mem, counts) in per_rule.items():
        busy = device_busy_s(torch, prof)
        row = {"rule": rule, "wall_s": wall, "device_busy_s": busy,
               "device_idle_share": 1.0 - busy / wall,
               "peak_host_rss_gib": mem.host_gib, "host_rss_at_start_gib": mem.host_start_gib,
               "peak_device_allocated_gib": mem.device_gib, "launches": counts}
        if rule in ("molecular", "duplex"):
            row.update(stage_summary(rule, stats[rule], wall))
            row["phase3_families_per_s"] = phase3_summaries[rule]["families_per_s"]
            check(counts["seg_vote"] > 0, f"phase6a {rule}: seg_vote never launched")
            check(row["route_batches_wire"] > 0 and row["route_batches_single"] == 0,
                  f"phase6a {rule}: transport 'auto' on the card did not take the wire")
        elif rule == "group":
            row.update({"records_in": gs["records_in"],
                        "records_per_s": gs["records_in"] / wall, "stats": gs})
        else:
            row.update({"records_in": fs["records_in"],
                        "records_per_s": fs["records_in"] / wall, "stats": fs})
        log(f"phase6a rule {json.dumps(row)}")
    check(launches["vote_finalize"] > 0, "phase6a: vote_finalize never launched")
    check(gs["molecules"] == families, f"phase6a: {gs['molecules']} molecules, want {families}")
    drops = {k: v for k, v in gs.items() if k.startswith("dropped_") and v}
    check(not drops and gs["accepted"] == gs["templates"] == gs["records_in"] // 2,
          f"phase6a: grouping dropped templates {drops}")
    check(stats["molecular"].metrics.counters.get("deep_skipped_families", 0) == 0,
          "phase6a: deep families were skipped")

    grouped = os.path.join(outdir, "raw_umigrouped.bam")
    t0 = time.monotonic()
    n, mis, pairs, differ = mi_partition(grouped)
    log(f"phase6a MI partition of the grouped intermediate: {n} records, {mis} MIs, "
        f"{pairs} (family, strand) pairs, {differ} records whose MI is not "
        f"'<family>/<strand>' ({time.monotonic() - t0:.1f} s)")
    check(n == gs["records_in"] and mis == pairs == 2 * families,
          "phase6a: the MIs do not partition the records by family and strand")

    unfiltered = os.path.join(outdir, "raw_consensus_duplex_unfiltered.bam")
    t0 = time.monotonic()
    ref = os.path.join(work, "run", "grouped_consensus_duplex_unfiltered.bam")
    lines, got = record_multiset(unfiltered, b"RX")
    ref_lines, want = record_multiset(ref, b"RX", limit=families)
    same = got == want
    log(f"phase6a unfiltered target vs phase 4a's target (its families below {families}), "
        f"RX and @PG aside: {len(got)} "
        f"records, sorted multisets equal={same}, header lines equal={lines == ref_lines} "
        f"({time.monotonic() - t0:.1f} s)")
    check(same and len(got) > 0, "phase6a: the raw run's consensus records differ from 4a's")
    check(lines == ref_lines, f"phase6a: headers differ beyond @PG: {lines} vs {ref_lines}")

    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    with BamReader(target) as r:
        kept = sum(1 for _ in r.raw_records())
    log(f"phase6a filtered target {os.path.basename(target)}: {kept} records; "
        f"FilterStats {json.dumps(fs)}")
    check(target == os.path.join(outdir, "raw_consensus_duplex_filtered.bam"),
          f"phase6a target {target}")
    check(fs["records_in"] == len(got) and fs["kept_records"] == kept > 0
          and fs["kept_records"] + fs["dropped_records"] == fs["records_in"],
          "phase6a: the filter's counts do not reconcile")
    return launches


def phase6b(work: str, fasta: str, n_head: int) -> None:
    """The raw head through `run` (grouped, filtered) on the card and on
    the CPU: grouped intermediate, unfiltered and filtered targets
    SHA-equal; `metrics --compact` on both grouped heads the same JSON;
    `group` and `sort --order coordinate|name|template-coordinate` through
    cli.main: the same records as the runs' grouping, SHA-equal sorts of
    the card's and the CPU's grouped heads."""
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline

    small = os.path.join(work, "raw_head.bam")
    names = {"grouped": "raw_head_umigrouped.bam",
             "unfiltered": "raw_head_consensus_duplex_unfiltered.bam",
             "filtered": "raw_head_consensus_duplex_filtered.bam"}
    outs = {}
    for backend in ("cuda", "cpu"):
        cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta),
                              genome_fasta_file_name=os.path.basename(fasta),
                              backend=backend, filter=RAW_FILTER)
        outdir = os.path.join(work, f"raw_head_{backend}")
        t0 = time.monotonic()
        target, results, stats = run_pipeline(cfg, small, outdir=outdir)
        check_unarmed_stats(stats, "phase6b")
        outs[backend] = {k: os.path.join(outdir, v) for k, v in names.items()}
        log(f"phase6b head run {backend}: {time.monotonic() - t0:.2f} s, rules "
            f"{json.dumps([[r.name, round(r.seconds, 3)] for r in results])}, group "
            f"{json.dumps(stats['group'].as_dict())}, filter {json.dumps(stats['filter'].as_dict())}")
        check(tuple(r.name for r in results) == RAW_RULES and target == outs[backend]["filtered"],
              f"phase6b {backend}: rules {[r.name for r in results]}, target {target}")
        check(stats["group"].molecules == n_head, f"phase6b {backend}: molecules")
    for key in names:
        a, b = sha256(outs["cuda"][key]), sha256(outs["cpu"][key])
        log(f"phase6b head {key}: card vs cpu byte-identical={a == b} (sha256 {a})")
        check(a == b, f"phase6b: the card's {key} head BAM differs from the CPU's")

    docs = [cli_io(["metrics", "-i", outs[b]["grouped"], "--compact"])[0] for b in outs]
    doc = json.loads(docs[0])
    log(f"phase6b metrics --compact: card-run and cpu-run heads print the same JSON="
        f"{docs[0] == docs[1]}: {docs[0].strip()[:400]}")
    check(docs[0] == docs[1] and doc["molecules"] == n_head == doc["duplexes"],
          "phase6b: metrics differ or miscount")

    grouped_cli = os.path.join(work, "raw_head_group_cli.bam")
    _o, err = cli_io(["group", "-i", small, "-o", grouped_cli])
    same, nbytes, h_cli, h_run = same_records(grouped_cli, outs["cuda"]["grouped"])
    log(f"phase6b group: {err.strip()}; records identical to the runs' grouping={same} "
        f"({nbytes} bytes), header lines apart from @PG that differ: "
        f"{json.dumps(header_difference(h_cli, h_run))}")
    check(same, "phase6b: `group` wrote other records than run's grouping rule")
    for order in ("coordinate", "name", "template-coordinate"):
        sorted_outs = {}
        for src, path in (("cuda", outs["cuda"]["grouped"]), ("cpu", outs["cpu"]["grouped"]),
                          ("group", grouped_cli)):
            out = os.path.join(work, f"raw_head_sorted_{order}_{src}.bam")
            _o, err = cli_io(["sort", "-i", path, "-o", out, "--order", order])
            sorted_outs[src] = out
        a, b = sha256(sorted_outs["cuda"]), sha256(sorted_outs["cpu"])
        same = same_records(sorted_outs["group"], sorted_outs["cuda"])[0]
        log(f"phase6b sort --order {order}: {err.strip()}; card-run vs cpu-run grouped head "
            f"byte-identical={a == b}, the `group` output's sort the same records={same}")
        check(a == b and same, f"phase6b: sort --order {order} differs")


def phase6c(work: str, fasta: str) -> None:
    """duplex --passthrough on the head's molecular BAM with leftover
    records appended (utils.testing.passthrough_leftovers: flag 0 and 1
    records, a duplicated 83, a softclipped 163, an indel read, a
    hard-clipped read), coordinate-sorted, on the card and on the CPU:
    SHA-equal BAMs, leftover_records printed."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter
    from bsseqconsensusreads_tpu_torch.pipeline.record_ops import coordinate_sort
    from bsseqconsensusreads_tpu_torch.utils.testing import passthrough_leftovers

    with BamReader(os.path.join(work, "mol_head_cuda_native_unpacked.bam")) as r:
        header = r.header
        recs = list(r)
    extra = passthrough_leftovers(recs)
    check(len(extra) == 6, f"phase6c: {len(extra)} leftover records made")
    src = os.path.join(work, "leftover_head.bam")
    with BamWriter(src, header) as w:
        w.write_all(coordinate_sort(recs + extra))
    shas, lefts = {}, {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(work, f"passthrough_head_{dev}.bam")
        t0 = time.monotonic()
        _o, err = cli_io(["duplex", "-i", src, "-o", out, "--reference", fasta, "--mode", "self",
                          "--passthrough", "--device", dev])
        st = json.loads(err.strip().splitlines()[-1])
        shas[dev], lefts[dev] = sha256(out), st["leftover_records"]
        with BamReader(out) as r:
            passed = sorted(q.rsplit(":", 1)[1] for q in (x.qname for x in r)
                            if q.rsplit(":", 1)[-1] in ("flag0", "flag1", "dup83", "softclip163",
                                                        "indel83", "hardclip163"))
        log(f"phase6c duplex --passthrough {dev}: {time.monotonic() - t0:.2f} s, "
            f"leftover_records {st['leftover_records']}, written through {passed}, "
            f"sha256 {shas[dev]}")
        check(passed == ["dup83", "flag0", "flag1", "softclip163"],
              f"phase6c {dev}: passthrough wrote {passed}")
    check(shas["cuda"] == shas["cpu"] and lefts["cuda"] == lefts["cpu"] == 5,
          "phase6c: the card's passthrough BAM differs from the CPU's")


# ---------------------------------------------------------------- phase 7


INLINE_CHILD = r"""
import json, os, sys, time
from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline
fasta, bam, outdir = sys.argv[1:4]
cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta), genome_fasta_file_name=os.path.basename(fasta))
t0 = time.monotonic()
target, results, stats = run_pipeline(cfg, bam, outdir=outdir)
print(json.dumps({"target": target, "wall": time.monotonic() - t0,
                  "rules": {r.name: r.seconds for r in results},
                  "stats": {k: s.as_dict() for k, s in stats.items()}}))
"""

FAILPOINT_CHILD = r"""
import json, os, sys
from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline
fasta, bam, outdir, over = sys.argv[1:5]
cfg = FrameworkConfig(genome_dir=os.path.dirname(fasta), genome_fasta_file_name=os.path.basename(fasta),
                      **json.loads(over))
target, results, stats = run_pipeline(cfg, bam, outdir=outdir)
print(json.dumps({"target": target}))
"""

#: Phase 7c's schedules: (name, schedule, env, config overrides, predicted
#: (retried, recovered, degraded, stalled) summed over the stages, fires).
#: Every drill run (and its unarmed reference) votes 64 families per batch,
#: so batches 2 and 3 are device batches in both stages at any head size.
DRILL_BATCH = 64
DRILL_SPILL = 200  # sort buffer records: both stages spill at any head size
DRILL = (
    ("dispatch_raise", "dispatch_kernel=raise:RuntimeError:times=1@batch=2", {}, {},
     (1, 1, 0, 0), 1),
    # the stall fires twice per stage: on the abandoned worker and again
    # on the inline re-dispatch (the schedule has no times=)
    ("fetch_stall", "fetch_out=stall:3s@batch=3", {"BSSEQ_TPU_STALL_TIMEOUT_S": "1"}, {},
     (0, 0, 0, 2), 4),
    ("hostpool_raise", "hostpool_task=raise:times=1", {}, {}, (1, 1, 0, 0), 1),
    ("extsort_spill", "extsort_spill=io_error:times=1", {},
     {"sort_buffer_records": DRILL_SPILL}, (1, 1, 0, 0), 1),
    ("ckpt_shard_write", "ckpt_shard_write=io_error:times=1", {}, {"checkpoint_every": 1},
     (0, 0, 0, 0), 1),
    ("bucket_spill", "bucket_spill=io_error:times=1", {},
     {"sort_engine": "bucket", "sort_buffer_records": DRILL_SPILL}, (1, 1, 0, 0), 1),
    ("dispatch_degrade", "dispatch_kernel=raise:times=3@batch=2", {"BSSEQ_TPU_RETRY_MAX": "3"},
     {}, (1, 0, 1, 0), 3),
)


def phase7(np, torch, work: str, inputs, cpu_families: int, cut: int) -> dict:
    """The batch engine: 7a the fused rule at Phase 3's families below
    half of `cut`, 7b the inline path in a child process at the families
    below `cut` (a quarter of --families; both depth cuts for the run's
    time limit), 7c the failpoint drill and 7d the
    input guard at the head's families (its deep families set aside, so
    the drill's batch indices are device batches at any --cpu-families).
    Returns the kernels' launches on 7a's main path."""
    fasta, big, small, genome = inputs
    t0 = time.monotonic()
    cut_big = family_subset(big, os.path.join(work, "cut7", "grouped.bam"), cut)
    cut_7a = family_subset(cut_big, os.path.join(work, "cut7a", "grouped.bam"), cut // 2)
    log(f"phase7 inputs: phase 3's families below {cut} and {cut // 2} "
        f"({time.monotonic() - t0:.1f} s)")
    launches = phase7a(torch, work, genome, cut_7a, cut // 2)
    phase7b(work, genome, cut_big, cut)
    n_head = cpu_families + len(DEEP_HEAD)
    deep = {n_head * (i + 1) // (len(DEEP_HEAD) + 1) for i in range(len(DEEP_HEAD))}
    drill = os.path.join(work, "drill_head.bam")
    n = head_subset(small, drill, lambda fam: fam not in deep)
    log(f"phase7 drill head: {n} records of the head's {n_head - len(deep)} normal families")
    phase7c(work, fasta, drill)
    bad = os.path.join(work, "bad_head.bam")
    n = head_subset(small, bad, lambda fam: fam < 400 and fam not in deep, corrupt_every=211)
    phase7d(work, fasta, bad, n)
    return launches


def phase7a(torch, work: str, genome: str, big: str, cut: int) -> dict:
    """`run` with sort_engine 'bucket' and stream_interstage on `big`,
    Phase 3's families below `cut`: one fused rule whose target and molecular
    intermediate must equal 4a's records of those families (@PG aside),
    under torch.profiler and the memory sampler, the kernels' counts set
    to 0 just before and read just after (a main path)."""
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, reconstruct
    from bsseqconsensusreads_tpu_torch.pipeline import stages

    outdir = os.path.join(work, "run_fused")
    cfg = FrameworkConfig(genome_dir=os.path.dirname(genome),
                          genome_fasta_file_name=os.path.basename(genome),
                          sort_engine="bucket", stream_interstage=True)
    reconstruct._CACHE.clear()
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    t0 = time.monotonic()
    with PeakMemory(torch) as mem, prof:
        target, results, stats = stages.run_pipeline(cfg, big, outdir=outdir)
    wall = time.monotonic() - t0
    launches = dict(cuda_vote.LAUNCHES)
    busy = device_busy_s(torch, prof)
    check_unarmed_stats(stats, "phase7a")
    rules = {r.name: r.seconds for r in results}
    check(list(rules) == ["call_consensus_molecular_duplex_fused"],
          f"phase7a: run drove {list(rules)}, not the fused rule")
    run4a = {ln.split()[1]: float(ln.split("(")[1].split("s)")[0]) for ln in RUN4A["rules"]}
    mol, dup = stats["molecular"], stats["duplex"]
    log(f"phase7a fused run on {cut} families: {wall:.3f} s (4a's run {RUN4A['wall']:.3f} s "
        f"on all); rule seconds "
        f"{json.dumps(rules)} beside 4a's {json.dumps(run4a)} (sum "
        f"{sum(run4a.values()):.3f}); bucket_count "
        f"{mol.metrics.counters.get('bucket_count', 0)}; peak host RSS {mem.host_gib:.3f} GiB "
        f"(at start {mem.host_start_gib:.3f}), peak device {mem.device_gib:.4f} GiB; device "
        f"busy {busy:.4f} s, idle share "
        f"{1.0 - busy / wall if busy > 0 else 'not measured'}; launches {json.dumps(launches)}")
    for stage, st in stats.items():
        log(f"phase7a stage {stage}: families {st.families}, families/s "
            f"{st.families / wall:.1f} over the fused rule, "
            f"{json.dumps(pool_fields(st.metrics.counters))}, sort_write "
            f"{st.metrics.seconds.get('sort_write', 0.0):.3f} s, bucket parts "
            f"{json.dumps({k: round(v, 3) for k, v in st.metrics.seconds.items() if 'bucket' in k})}")
    check(mol.metrics.counters.get("bucket_count", 0) > 1, "phase7a: no bucket plan")
    check(launches["seg_vote"] > 0, "phase7a: seg_vote never launched")
    inter = os.path.join(outdir, "grouped_consensus_unfiltered_aunamerged_aligned.bam")
    for name, path, ref in (("intermediate", inter, os.path.join(
            RUN4A["outdir"], "grouped_consensus_unfiltered_aunamerged_aligned.bam")),
                            ("target", target, RUN4A["doc"]["target"])):
        same, n, hdiff = same_family_records(path, ref, cut)
        log(f"phase7a {name} vs 4a's (its families below {cut}): {n} records "
            f"identical={same}, header lines that differ apart from @PG: {json.dumps(hdiff)}")
        check(same and not hdiff["only_run"] and not hdiff["only_phase3"],
              f"phase7a {name}: differs from 4a's")
    return launches


def phase7b(work: str, genome: str, big: str, cut: int) -> None:
    """The same default `run` inline (BSSEQ_TPU_HOST_WORKERS=0,
    BSSEQ_TPU_OVERLAP_THREADS=0) in a child process on 7a's input (the
    families below `cut`: a depth cut for the run's time limit): its
    target must equal 4a's records of those families; its per-stage
    families/s beside 4a's are the pools' measured effect on this card."""
    outdir = os.path.join(work, "run_inline")
    env = {**os.environ, "PYTHONPATH": REPO, "BSSEQ_TPU_HOST_WORKERS": "0",
           "BSSEQ_TPU_OVERLAP_THREADS": "0"}
    res = subprocess.run([sys.executable, "-c", INLINE_CHILD, genome, big, outdir], env=env,
                         capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"phase7b: the inline run failed: {res.stderr[-2000:]}")
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    same, n, hdiff = same_family_records(doc["target"], RUN4A["doc"]["target"], cut)
    log(f"phase7b inline run on the families below {cut}: {doc['wall']:.3f} s (4a "
        f"{RUN4A['wall']:.3f} s on all), rule seconds {json.dumps(doc['rules'])}; target "
        f"records identical to 4a's of those families={same} ({n} records), header lines "
        f"that differ apart from @PG: {json.dumps(hdiff)}")
    check(same and not hdiff["only_run"] and not hdiff["only_phase3"],
          "phase7b: the inline target differs from 4a's")
    for stage, st in doc["stats"].items():
        check_unarmed(st, f"phase7b {stage}")
        pooled = RUN4A["doc"]["stats"][stage]
        log(f"phase7b {stage}: families/s inline {st['families_per_second']} vs pools "
            f"{pooled['families_per_second']} (x{pooled['families_per_second'] / st['families_per_second']:.3f}); "
            f"inline {json.dumps(pool_fields(st))}, pools {json.dumps(pool_fields(pooled))}; "
            f"phase seconds inline / pools: " + json.dumps({
                k: [round(st.get(f'{k}_seconds', 0.0), 3), round(pooled.get(f'{k}_seconds', 0.0), 3)]
                for k in HOST_PHASES + DEVICE_PHASES + ("stall",)}))


def phase7c(work: str, fasta: str, small: str) -> None:
    """The failpoint drill on the card at the head: each schedule armed
    alone; every run's target SHA-equal to the unarmed run's, with the
    recovery counters and fires the schedule predicts; then
    bucket_finalize=exit:9 in a checkpointed child process, resumed."""
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.faults import failpoints
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline

    def cfg(**over):
        return FrameworkConfig(genome_dir=os.path.dirname(fasta),
                               genome_fasta_file_name=os.path.basename(fasta),
                               batch_families=DRILL_BATCH, **over)

    t0 = time.monotonic()
    before = cuda_vote.LAUNCHES["seg_vote"]
    plain, _r, stats = run_pipeline(cfg(), small, outdir=os.path.join(work, "drill_plain"))
    plain_launches = cuda_vote.LAUNCHES["seg_vote"] - before
    check_unarmed_stats(stats, "phase7c unarmed")
    want = sha256(plain)
    log(f"phase7c unarmed head run: {time.monotonic() - t0:.2f} s, sha256 {want}, batches "
        f"{ {k: s.batches for k, s in stats.items()} }, seg_vote launches {plain_launches}")
    for name, spec, env, over, predicted, fires in DRILL:
        saved = {k: os.environ.get(k) for k in (*env, "BSSEQ_TPU_RETRY_BACKOFF_S")}
        os.environ.update(env)
        failpoints.arm(spec)
        t0 = time.monotonic()
        before = cuda_vote.LAUNCHES["seg_vote"]
        try:
            target, _r, stats = run_pipeline(cfg(**over), small,
                                             outdir=os.path.join(work, f"drill_{name}"))
            fired = failpoints.fired_counts()
            launched = cuda_vote.LAUNCHES["seg_vote"] - before
        finally:
            failpoints.disarm()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        got = tuple(sum(s.counter(k) for s in stats.values()) for k in RECOVERY)
        site = spec.split("=")[0]
        log(f"phase7c {name} [{spec}] {json.dumps(env)} {json.dumps(over)}: "
            f"{time.monotonic() - t0:.2f} s, batches "
            f"{ {k: s.batches for k, s in stats.items()} }, sha256 equal {sha256(target) == want}, "
            f"counters {dict(zip(RECOVERY, got))} (predicted {dict(zip(RECOVERY, predicted))}), "
            f"fires {fired.get(site, 0)} (predicted {fires}), seg_vote launches {launched}")
        check(sha256(target) == want, f"phase7c {name}: the target differs from the unarmed run")
        check(got == predicted and fired.get(site, 0) == fires,
              f"phase7c {name}: counters {got} / fires {fired} not as predicted")
        if got[2]:
            # the failed attempts raised before their launch, and the
            # degraded batch voted on the card: the unarmed run's launches
            check(launched == plain_launches, f"phase7c {name}: {launched} seg_vote launches, "
                  f"the unarmed run {plain_launches}: the degraded batch left the card")
    # a bucket finalize killed mid-stream, then resumed
    outdir = os.path.join(work, "drill_bucket_kill")
    over = json.dumps({"sort_engine": "bucket", "checkpoint_every": 1,
                       "batch_families": DRILL_BATCH})
    env = {**os.environ, "PYTHONPATH": REPO, "BSSEQ_TPU_FAILPOINTS": "bucket_finalize=exit:9@hit=2"}
    cmd = [sys.executable, "-c", FAILPOINT_CHILD, fasta, small, outdir, over]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    runs = [d for d in os.listdir(outdir) if d.endswith(".bucketruns")]
    log(f"phase7c bucket_finalize=exit:9: child rc {res.returncode}, bucket run dirs left {runs}")
    check(res.returncode == 9 and runs, f"phase7c: the bucket finalize kill did not land: "
          f"{res.stderr[-2000:]}")
    env.pop("BSSEQ_TPU_FAILPOINTS")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"phase7c: the resumed run failed: {res.stderr[-2000:]}")
    target = json.loads(res.stdout.strip().splitlines()[-1])["target"]
    log(f"phase7c bucket_finalize resume: sha256 equal {sha256(target) == want}")
    check(sha256(target) == want, "phase7c: the resumed bucket run differs from the unarmed run")


def head_subset(src: str, out: str, keep, corrupt_every: int = 0) -> int:
    """The records of `src` whose family (MI `<family>/<strand>`) `keep`
    accepts, written to `out`; with `corrupt_every`, a qual of 120 in
    every corrupt_every-th record (the input guard's drill). Returns the
    records written."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter

    n = 0
    with BamReader(src) as r, BamWriter(out, r.header) as w:
        for rec in r:
            if not keep(int(rec.get_tag("MI").split("/")[0])):
                continue
            if corrupt_every and n % corrupt_every == 5:
                q = bytearray(rec.qual)
                q[len(q) // 2] = 120
                rec.qual = bytes(q)
            w.write(rec)
            n += 1
    return n


def phase7d(work: str, fasta: str, bad: str, n: int) -> None:
    """The input guard on the card and the CPU: `molecular` on `bad`, n
    head records with out-of-range quals — strict exits 3 with the same
    reason on both; under quarantine the output and the sidecar are
    SHA-equal card vs CPU, and the counters reconcile with the sidecar's
    records."""
    import contextlib
    import io

    from bsseqconsensusreads_tpu_torch import cli
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    saved = os.environ.get("BSSEQ_TPU_INPUT_POLICY")
    outs = {}
    try:
        for policy in ("strict", "quarantine"):
            for device in ("cuda", "cpu"):
                os.environ["BSSEQ_TPU_INPUT_POLICY"] = policy
                out = os.path.join(work, f"guard_{policy}_{device}.bam")
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    rc = cli.main(["molecular", "-i", bad, "-o", out, "--mode", "self",
                                   "--device", device])
                lines = err.getvalue().splitlines()
                sidecar = bad + ".quarantined.bam"
                doc = {"rc": rc, "lines": [ln for ln in lines if "input error" in ln]}
                if rc == 0:
                    st = json.loads(lines[-1])
                    with BamReader(sidecar) as r:
                        quarantined = sum(1 for _ in r)
                    doc.update(out=sha256(out), sidecar=sha256(sidecar), stats={
                        k: st.get(k, 0) for k in ("records_seen", "records_in",
                                                  "records_quarantined",
                                                  "families_quarantined",
                                                  "family_records_quarantined",
                                                  "consensus_out")},
                        sidecar_records=quarantined)
                    os.remove(sidecar)
                outs[(policy, device)] = doc
                log(f"phase7d {policy} {device}: {json.dumps(doc)}")
    finally:
        if saved is None:
            os.environ.pop("BSSEQ_TPU_INPUT_POLICY", None)
        else:
            os.environ["BSSEQ_TPU_INPUT_POLICY"] = saved
    s_card, s_cpu = outs[("strict", "cuda")], outs[("strict", "cpu")]
    check(s_card["rc"] == s_cpu["rc"] == 3 and len(s_card["lines"]) == 1
          and s_card["lines"] == s_cpu["lines"]
          and "input error [qual-out-of-range]" in s_card["lines"][0],
          "phase7d: strict did not exit 3 with the same reason on the card and the CPU")
    q_card, q_cpu = outs[("quarantine", "cuda")], outs[("quarantine", "cpu")]
    check(q_card["rc"] == q_cpu["rc"] == 0, "phase7d: quarantine failed")
    check(q_card == q_cpu, "phase7d: quarantine differs between the card and the CPU")
    st = q_card["stats"]
    check(st["records_seen"] == n == st["records_in"] + st["records_quarantined"]
          and st["records_quarantined"] > 0
          and q_card["sidecar_records"] == st["records_quarantined"]
          + st["family_records_quarantined"],
          f"phase7d: the counters do not reconcile with the sidecar ({n} records in)")


# ---------------------------------------------------------------- phase 8


#: Phase 8's share of reads with one 1-3 bp insertion or deletion: the
#: order of a 150 bp Illumina library's per-read indel rate plus PCR
#: stutter (utils.testing.indel_read places most in homopolymers)
INDEL_RATE = 0.02


def indel_families(families: int) -> set:
    """The families of the Phase 3 mixture (1 template per strand for 70%
    of them, else 2) with at least one indel read at INDEL_RATE: the
    generator's own per-read decision (utils.testing.has_indel)."""
    from bsseqconsensusreads_tpu_torch.utils.testing import has_indel

    out = set()
    for fam in range(families):
        t = 1 if fam % 10 < 7 else 2
        if any(has_indel(fam, ti, flag, INDEL_RATE)
               for ti in range(t) for flag in (99, 147, 163, 83)):
            out.add(fam)
    return out


def scan_indel_reads(path: str) -> tuple[int, int]:
    """(keep == 2 reads, families) over every family of `path` in the C
    molecular-encode scan under indel_policy 'align' (the reads the
    encode hands to the banded aligner)."""
    import numpy as np

    from bsseqconsensusreads_tpu_torch.pipeline import ingest

    n = fams = 0
    stream = ingest.GroupedColumnarStream(path, scan_policy="align", grouping="coordinate")
    for g in stream.iter_groups():
        n += int(np.count_nonzero(g.scan["keep"][g.start:g.start + g.n] == 2))
        fams += 1
    return n, fams


def records_by_family(path: str) -> dict:
    """{family: [encoded records in file order]} of a consensus BAM."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    out: dict = {}
    with BamReader(path) as r:
        for b in r.raw_records():
            out.setdefault(family_of(b), []).append(b)
    return out


def record_depths(blobs: list) -> dict:
    """{(qname, flag): cD} of encoded consensus records."""
    from bsseqconsensusreads_tpu_torch.io.bam import decode_record

    return {(rec.qname, rec.flag): int(rec.get_tag("cD"))
            for rec in (decode_record(b[4:]) for b in blobs)}


def banded_launches(torch, n: int, l: int) -> tuple[int, float, float]:
    """(kernel launches, events ms, profiler device ms) of one
    banded_scores call of (N, L) on the card (its uploads included), on
    seeded reads of the window's anchor."""
    import numpy as np

    from bsseqconsensusreads_tpu_torch.ops import banded

    rng = np.random.default_rng(8)
    ref = rng.integers(0, 4, size=(n, l + 48)).astype(np.int8)
    reads = ref[:, 8:8 + l].copy()
    offsets = np.full(n, 8, np.int32)
    args = (reads, ref, offsets)  # numpy in, as the encode calls it
    banded.banded_scores(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    banded.banded_scores(*args)
    end.record()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        banded.banded_scores(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    return len(kernels), start.elapsed_time(end), busy


def phase8(np, torch, work: str, inputs, families: int, cpu_families: int) -> dict:
    """Indel recovery: 8a `run` with indel_policy 'align' on the card at
    the indel input's first `families` families (a depth cut of
    --families for the run's time limit) with INDEL_RATE indel reads (a
    main path), 8b the `molecular` stage with --indel-policy drop on the
    same input, 8c the indel head with align on the card and the CPU.
    Returns 8a's launches."""
    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.ops import banded, cuda_vote, reconstruct
    from bsseqconsensusreads_tpu_torch.pipeline import stages

    fasta, _big, _small, genome = inputs
    t0 = time.monotonic()
    big = family_subset(os.path.join(work, "indel.bam"), os.path.join(work, "cut8", "indel.bam"),
                        families)
    want_keep2, n_groups = scan_indel_reads(big)
    with_indel = indel_families(families)
    log(f"phase8 input: {families} families, {n_groups} strand families; the C scan's "
        f"keep == 2 reads {want_keep2}; {len(with_indel)} families carry an indel read "
        f"({time.monotonic() - t0:.1f} s)")

    # 8a: `run` with align, the counts set to 0 just before and read just after
    outdir = os.path.join(work, "run_align")
    cfg = FrameworkConfig(genome_dir=os.path.dirname(genome),
                          genome_fasta_file_name=os.path.basename(genome), indel_policy="align")
    reconstruct._CACHE.clear()
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    banded.CALLS.clear()
    # no torch.profiler here: the DP's ~900,000 small launches make its
    # trace cost minutes to read back (the idle share is Phase 3's, 9a's)
    t0 = time.monotonic()
    with PeakMemory(torch) as mem:
        target, results, stats = stages.run_pipeline(cfg, big, outdir=outdir)
    wall = time.monotonic() - t0
    launches = dict(cuda_vote.LAUNCHES)
    calls = list(banded.CALLS)
    check_unarmed_stats(stats, "phase8a")
    mol = stats["molecular"]
    rows = {}
    for stage, st in stats.items():
        rows[stage] = {**stage_summary(stage, st, st.wall_seconds),
                       "indel_aligned": st.indel_aligned, "indel_dropped": st.indel_dropped}
        log(f"phase8a stage {json.dumps(rows[stage])}")
    dp_s = sum(c["dp_s"] for c in calls)
    tb_s = sum(c["traceback_s"] for c in calls)
    log(f"phase8a run (align): {wall:.3f} s, rules {json.dumps({r.name: r.seconds for r in results})}; "
        f"indel_aligned {mol.indel_aligned}, indel_dropped {mol.indel_dropped}; peak host RSS "
        f"{mem.host_gib:.3f} GiB, device {mem.device_gib:.4f} GiB; idle share not measured; "
        f"launches {json.dumps(launches)}")
    check(launches["seg_vote"] > 0, "phase8a: seg_vote never launched")
    check(mol.indel_aligned > 0 and mol.indel_dropped > 0,
          "phase8a: the aligner placed or refused no read")
    check(mol.indel_aligned + mol.indel_dropped == want_keep2,
          f"phase8a: aligned {mol.indel_aligned} + refused {mol.indel_dropped} != the C "
          f"scan's {want_keep2} indel reads")
    shapes = sorted({(c["n"], c["l"]) for c in calls})
    log(f"phase8a banded_scores: {len(calls)} calls, (N, L) from {shapes[0]} to {shapes[-1]}, "
        f"mean N {sum(c['n'] for c in calls) / max(len(calls), 1):.1f}; DP (loop + fetch) "
        f"{dp_s:.3f} s, host traceback {tb_s:.3f} s: worker-seconds of the host pool, which "
        f"encodes a chunk ahead and so overlaps the dispatch, not a share of the wall; over "
        f"the molecular wall {mol.wall_seconds:.3f} s: DP worker-seconds / wall "
        f"{dp_s / mol.wall_seconds:.4f}, with the traceback {(dp_s + tb_s) / mol.wall_seconds:.4f} "
        f"(the end-to-end cost is 8b's align / drop families/s)")
    log("phase8a banded_scores calls [N, L, DP ms, traceback ms]: " + json.dumps(
        [[c["n"], c["l"], round(c["dp_s"] * 1e3, 3), round(c["traceback_s"] * 1e3, 3)]
         for c in calls]))
    per_call = {}
    for n, l in sorted({max(shapes), (int(np.median([c['n'] for c in calls])), shapes[-1][1])}):
        k, ev_ms, prof_ms = banded_launches(torch, n, l)
        per_call[f"{n}x{l}"] = {"launches": k, "events_ms": ev_ms, "profiler_busy_ms": prof_ms}
    log(f"phase8a banded_scores per call on the card: {json.dumps(per_call)}")

    # 8b: the molecular stage with --indel-policy drop on the same input
    drop = os.path.join(work, "indel_drop_molecular.bam")
    t0 = time.monotonic()
    _out, err = cli_io(["molecular", "-i", big, "-o", drop, "--mode", "self",
                        "--indel-policy", "drop"])
    drop_wall = time.monotonic() - t0
    dstats = json.loads(err.strip().splitlines()[-1])
    check_unarmed(dstats, "phase8b")
    log(f"phase8b molecular (drop): {drop_wall:.3f} s, families/s "
        f"{dstats['families_per_second']} (align in 8a: {rows['molecular']['families_per_s']:.1f}, "
        f"x{rows['molecular']['families_per_s'] / dstats['families_per_second']:.3f}); "
        f"indel_aligned {dstats['indel_aligned']}, indel_dropped {dstats['indel_dropped']}")
    check(dstats["indel_aligned"] == dstats["indel_dropped"] == 0,
          "phase8b: the drop policy aligned or counted indel reads")
    # a family whose reads all carry an indel is skipped at the encode under
    # drop; under align it is placed, and skipped at the emit (no read)
    # only when the aligner refused all of its reads
    log(f"phase8 skipped families: align {mol.skipped_families}, drop "
        f"{dstats['skipped_families']}")
    check(mol.skipped_families <= dstats["skipped_families"],
          "phase8: align skipped more families than drop")

    # the gates, family by family
    t0 = time.monotonic()
    inter = os.path.join(outdir, "indel_consensus_unfiltered_aunamerged_aligned.bam")
    a, d = records_by_family(inter), records_by_family(drop)
    same = differ = deeper = shallower = 0
    for fam in sorted(set(a) | set(d)):
        if fam not in with_indel:
            ok = a.get(fam) == d.get(fam)
            same += ok
            differ += not ok
            continue
        got, want = record_depths(a.get(fam, [])), record_depths(d.get(fam, []))
        for key, cd in want.items():
            if got.get(key, -1) < cd:
                shallower += 1
            elif got[key] > cd:
                deeper += 1
    log(f"phase8 align vs drop, family by family: {same} families without an indel read "
        f"byte-equal, {differ} differ; indel families' records with cD deeper under align "
        f"{deeper}, shallower {shallower} ({time.monotonic() - t0:.1f} s)")
    check(differ == 0 and same > 0, "phase8: families without an indel read differ")
    check(shallower == 0 and deeper > 0, "phase8: align lost depth, or added none")

    # 8c: the indel head (with its deep families) with align, card vs CPU
    head = os.path.join(work, "indel_head.bam")
    shas = {}
    for stage, inp in (("molecular", head),
                       ("duplex", os.path.join(work, "mol_indel_head_cuda.bam"))):
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{stage[:3]}_indel_head_{dev}.bam")
            st, _counts, swall = run_stage(stage, inp, out, fasta, dev, transport="unpacked",
                                           indel_policy="align")
            shas[stage, dev] = sha256(out)
            log(f"phase8c head {stage} {dev}: {swall:.2f} s, indel_aligned {st.indel_aligned}, "
                f"indel_dropped {st.indel_dropped}, deep_routed_families "
                f"{st.metrics.counters.get('deep_routed_families', 0)}, sha256 {shas[stage, dev]}")
            if stage == "molecular":
                check(st.indel_aligned > 0, f"phase8c {dev}: no indel read aligned")
                check_deep_head(st, f"indel {dev}")
        check(shas[stage, "cuda"] == shas[stage, "cpu"],
              f"phase8c {stage}: the card's BAM differs from the CPU's")
    log("phase8c head: card and CPU BAMs SHA-equal in both stages")
    return launches


# ---------------------------------------------------------------- phase 9


#: one card, two mesh slots (each its own stream): the sharded code on a
#: one-card machine, where mesh='auto' resolves to None
MESH_DEVICES = ["cuda:0", "cuda:0"]


def mesh_stage(torch, stage, inp, out, fasta, transport, mesh, tag, ref_summary):
    """One stage on `mesh` through the port's entry points, under
    torch.profiler, the kernels' counts (and the per-slot tags) set to 0
    just before and read just after; returns (summary, launches)."""
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    cuda_vote.TAGGED_LAUNCHES.clear()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with PeakMemory(torch) as mem:
        stats, counts, wall = run_stage(stage, inp, out, fasta, "cuda", prof,
                                        transport=transport, mesh=mesh)
    busy = device_busy_s(torch, prof)
    route = "wire_mc" if transport == "wire" else "sharded"
    c = stats.metrics.counters
    summary = {
        **stage_summary(stage, stats, wall), "transport": transport,
        "mesh": repr(mesh), "route": route,
        f"route_batches_{route}": c.get(f"route_batches_{route}", 0),
        "launches_per_slot": {f"{k}@{t}": v for (k, t), v in
                              sorted(cuda_vote.TAGGED_LAUNCHES.items())},
        "device_busy_s": busy if busy > 0 else "not measured",
        "device_idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
        "peak_host_rss_gib": mem.host_gib, "peak_device_allocated_gib": mem.device_gib,
        "launches": counts, "sha256": sha256(out),
        "phase3": {k: ref_summary[k] for k in ("families_per_s", "stall_s", "device_idle_share")},
    }
    log(f"{tag} stage {json.dumps(summary)}")
    others = {k for k, v in c.items() if k.startswith("route_batches_") and v} - {
        f"route_batches_{route}"}
    check(summary[f"route_batches_{route}"] > 0 and not others,
          f"{tag} {stage}: the device batches did not all take the {route} route ({others})")
    check(counts["seg_vote"] > 0, f"{tag} {stage}: seg_vote never launched")
    # sharded: every batch on every data slot; round-robin: batch k on slot k mod n
    n = mesh.shape["data"]
    used = n if route == "sharded" else min(n, summary[f"route_batches_{route}"])
    slots = {t for (k, t) in cuda_vote.TAGGED_LAUNCHES if k == "seg_vote"}
    check(slots == {f"{d},0" for d in range(used)},
          f"{tag} {stage}: seg_vote launched on slots {slots}")
    return summary, counts


def phase9(np, torch, work: str, inputs, phase3_summaries, cpu_families: int,
           cut: int) -> dict:
    """The multi-device layer on one card: 9a Phase 3's families below `cut`
    (a depth cut for the run's time limit) through both stages on
    make_mesh(n_data=2) over MESH_DEVICES, sharded (unpacked) and
    round-robin (wire), each BAM equal to Phase 3's or 3w's records of
    those families (a main path); 9b the head's deep families on make_mesh(1, 2); 9c two
    processes through init_distributed, each voting its share of the
    head; 9d the head's duplex stage with methyl on make_mesh(n_data=2).
    Returns the launches of 9a and 9b."""
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.parallel.mesh import make_mesh

    fasta, big, small, genome = inputs
    p3, p3w = phase3_summaries
    launches: dict = {}
    t0 = time.monotonic()
    cut_big = family_subset(big, os.path.join(work, "cut9", "grouped.bam"), cut)
    log(f"phase9a input: phase 3's families below {cut} ({time.monotonic() - t0:.1f} s)")
    mesh = make_mesh(n_data=2, devices=MESH_DEVICES)
    for transport, ref_mol, ref_dup, refs in (("unpacked", "molecular.bam", "duplex.bam", p3),
                                              ("wire", "molecular_wire.bam", "duplex_wire.bam", p3w)):
        mol = os.path.join(work, f"mesh_molecular_{transport}.bam")
        for stage, inp, out, ref in (
                ("molecular", cut_big, mol, ref_mol),
                ("duplex", mol, os.path.join(work, f"mesh_duplex_{transport}.bam"), ref_dup)):
            summary, counts = mesh_stage(torch, stage, inp, out, genome, transport, mesh,
                                         f"phase9a {transport}", refs[stage])
            same, n, hdiff = same_family_records(out, os.path.join(work, ref), cut)
            log(f"phase9a {transport} {stage} vs {ref}'s families below {cut}: {n} records "
                f"identical={same}, header lines that differ apart from @PG: {json.dumps(hdiff)}")
            check(same and not hdiff["only_run"] and not hdiff["only_phase3"],
                  f"phase9a {transport} {stage}: the mesh wrote other records than {ref}")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v

    # 9b: the head's deep families, their template axis over two slots
    deep_mesh = make_mesh(n_data=1, n_reads=2, devices=MESH_DEVICES)
    out = os.path.join(work, "mesh_deep_head.bam")
    cuda_vote.TAGGED_LAUNCHES.clear()
    st, counts, wall = run_stage("molecular", small, out, fasta, "cuda", transport="unpacked",
                                 mesh=deep_mesh)
    check_deep_head(st, "mesh (1, 2)")
    ref = os.path.join(work, "mol_head_cuda_native_unpacked.bam")
    deep = deep_families(cpu_families)
    a, b = records_by_family(out), records_by_family(ref)
    qual_cells = qual_differ = qual_max = other = 0
    from bsseqconsensusreads_tpu_torch.io.bam import decode_record

    for fam in sorted(set(a) | set(b)):
        if fam not in deep:
            other += a.get(fam) != b.get(fam)
            continue
        for x, y in zip(a.get(fam, []), b.get(fam, []), strict=True):
            rx, ry = decode_record(x[4:]), decode_record(y[4:])
            check((rx.qname, rx.flag, rx.pos, rx.seq, rx.cigar, rx.tags)
                  == (ry.qname, ry.flag, ry.pos, ry.seq, ry.cigar, ry.tags),
                  f"phase9b: deep family {fam}'s base, depth or errors differ from one device")
            dq = np.abs(np.frombuffer(rx.qual, np.uint8).astype(int)
                        - np.frombuffer(ry.qual, np.uint8).astype(int))
            qual_cells += dq.size
            qual_differ += int((dq > 0).sum())
            qual_max = max(qual_max, int(dq.max(initial=0)))
    log(f"phase9b head on mesh (1, 2): {wall:.2f} s; deep families {sorted(deep)}: "
        f"{qual_differ} of {qual_cells} quals differ from one device, max {qual_max}; "
        f"other families differing {other}; launches {json.dumps(counts)}, per slot "
        f"{json.dumps({f'{k}@{t}': v for (k, t), v in sorted(cuda_vote.TAGGED_LAUNCHES.items())})}")
    check(other == 0, "phase9b: families off the deep route differ from one device")
    check(qual_max <= 1, f"phase9b: a deep family's qual differs by {qual_max}")
    check(counts["seg_vote_partials"] > 0 and counts["vote_finalize"] > 0,
          "phase9b: the deep mesh route did not launch the partials mode and vote_finalize")
    check({t for (k, t) in cuda_vote.TAGGED_LAUNCHES if k == "seg_vote_partials"} == {"0,0", "0,1"},
          "phase9b: the partials did not launch on both reads slots")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    phase9c(work, small, ref)
    phase9d(work, fasta)
    return launches


def phase9d(work: str, fasta: str, device: str = "cuda", mesh_devices=MESH_DEVICES) -> None:
    """The head's duplex stage with methyl 'both' (the device engine) on a
    two-slot sharded mesh: each data slot runs the methyl epilogue with
    its duplex launch. The BAM must equal Phase 3's head duplex BAM, the
    bedMethyl and CX 5c's."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
    from bsseqconsensusreads_tpu_torch.methyl.tally import MethylAccumulator
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore
    from bsseqconsensusreads_tpu_torch.parallel.mesh import make_mesh
    from bsseqconsensusreads_tpu_torch.pipeline import calling, stages
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream

    inp = os.path.join(work, "mol_head_cuda_native_unpacked.bam")
    out = os.path.join(work, "mesh_methyl_head.bam")
    ref5c = os.path.join(work, "methyl_head_cuda_unpacked_device.bam")
    t0 = time.monotonic()
    acc = MethylAccumulator(RefStore.from_fasta(fasta), out + ".bedmethyl",
                            out + ".CX_report.txt")
    stats = calling.StageStats(stage="duplex")
    cuda_vote.TAGGED_LAUNCHES.clear()
    with BamReader(inp) as reader, FastaFile(fasta) as fa:
        batches = calling.call_duplex_batches(
            stages.duplex_ingest_stream(inp, reader, stats, ingest_choice="native"),
            fa.fetch, [n for n, _ in reader.header.references], ConsensusParams(min_reads=0),
            mode="self", batch_families=2048, grouping="coordinate", stats=stats,
            device=device, emit="native", transport="unpacked",
            mesh=make_mesh(n_data=2, devices=mesh_devices), methyl=acc, methyl_engine="device",
        )
        write_batch_stream(batches, out, reader.header, "self", sort_engine="native",
                           metrics=stats.metrics)
    report = acc.finalize()
    wall = time.monotonic() - t0
    check_unarmed(stats.metrics.counters, "phase9d")
    c = stats.metrics.counters
    slots = sorted({t for (_k, t) in cuda_vote.TAGGED_LAUNCHES})
    log(f"phase9d head duplex with methyl on mesh (2, 1): {wall:.2f} s, sites "
        f"{report['sites']}, route_batches_sharded {c.get('route_batches_sharded', 0)}, "
        f"methyl {stats.metrics.seconds.get('methyl', 0.0):.4f} s, launches per slot "
        f"{json.dumps({f'{k}@{t}': v for (k, t), v in sorted(cuda_vote.TAGGED_LAUNCHES.items())})}")
    check(c.get("route_batches_sharded", 0) == stats.batches > 0,
          "phase9d: the head's batches did not take the sharded route")
    if device == "cuda":
        check(slots == ["0,0", "1,0"], f"phase9d: launches on slots {slots}")
    check(sha256(out) == sha256(os.path.join(work, "dup_head_cuda_native_unpacked.bam")),
          "phase9d: the BAM differs from phase 3's head duplex BAM")
    for suffix in (".bedmethyl", ".CX_report.txt"):
        check(sha256(out + suffix) == sha256(ref5c + suffix),
              f"phase9d: the {suffix} differs from 5c's")
    log("phase9d: BAM, bedMethyl and CX equal to the one-device runs")


def deep_families(cpu_families: int) -> set:
    """The head's DEEP_HEAD family indices (write_inputs)."""
    n_head = cpu_families + len(DEEP_HEAD)
    return {n_head * (i + 1) // (len(DEEP_HEAD) + 1) for i in range(len(DEEP_HEAD))}


def phase9c(work: str, small: str, ref: str) -> None:
    """Two processes on the card (init_distributed over gloo, one mesh
    slot each): each votes its local_family_count share of the head's
    strand families; the merged records equal the one-process run's
    (Phase 3's head)."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    t0 = time.monotonic()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--mesh-child",
         f"{rank},{port},{small},{work}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {rank: err[-1500:] for rank, (p, (_o, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0}
    check(not failed, f"phase9c processes failed: {json.dumps(failed)}")
    for rank, (out, _err) in enumerate(outs):
        log(f"phase9c process {rank}: {out.strip().splitlines()[-1]}")
    _lines, merged = record_multiset(os.path.join(work, "mesh_share_0.bam"), b"")
    _lines, part = record_multiset(os.path.join(work, "mesh_share_1.bam"), b"")
    _lines, want = record_multiset(ref, b"")
    same = sorted(merged + part) == want
    log(f"phase9c two processes: {len(merged)} + {len(part)} records, merged equal to the "
        f"one-process run's={same} ({time.monotonic() - t0:.1f} s)")
    check(same, "phase9c: the two processes' merged records differ from one process")


class FamilyShare:
    """Groups [lo, hi) of a native grouped stream (the C grouping and
    encode scan), as a stream pipeline.calling.stream_mi_groups takes."""

    def __init__(self, stream, lo: int, hi: int):
        self.stream, self.lo, self.hi = stream, lo, hi
        self.grouping, self.strip_suffix = stream.grouping, stream.strip_suffix
        self.flush_margin = stream.flush_margin

    def iter_groups(self, stats=None):
        for i, g in enumerate(self.stream.iter_groups(stats)):
            if self.lo <= i < self.hi:
                yield g


def mesh_child(arg: str) -> int:
    """One process of Phase 9c: join the two-process job (gloo, the
    rendezvous only), take this process's local_family_count share of the
    head's strand families and vote it on its mesh slot (the molecular
    stage, native engines, 'self')."""
    import numpy as np

    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.parallel import multihost
    from bsseqconsensusreads_tpu_torch.parallel.mesh import pad_families
    from bsseqconsensusreads_tpu_torch.pipeline import calling, ingest
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream

    rank, port, small, work = arg.split(",")
    rank = int(rank)
    t0 = time.monotonic()
    multihost.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = multihost.multihost_family_mesh(devices=["cuda:0"])
    check(mesh.shape == {"data": 2, "reads": 1} and mesh.local_data() == [rank],
          f"process {rank}: mesh {mesh!r}")
    grouped = lambda: ingest.GroupedColumnarStream(small, scan_policy="drop",  # noqa: E731
                                                   grouping="coordinate")
    n_groups = sum(1 for _ in grouped().iter_groups())
    _pads, n_pad = pad_families((np.zeros(n_groups),), n_groups, mesh.shape["data"])
    count, first = multihost.local_family_count(n_pad, mesh)
    out = os.path.join(work, f"mesh_share_{rank}.bam")
    stats = calling.StageStats(stage="molecular")
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    with BamReader(small) as reader:
        batches = calling.call_molecular_batches(
            FamilyShare(grouped(), first, first + count), ConsensusParams(min_reads=1),
            mode="self", batch_families=2048, grouping="coordinate", stats=stats,
            device="cuda", emit="native", transport="unpacked", mesh=mesh)
        write_batch_stream(batches, out, reader.header, "self", sort_engine="native")
    check(cuda_vote.LAUNCHES["seg_vote"] > 0, f"process {rank}: seg_vote never launched")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "groups": [first, first + count], "of": n_groups,
                      "families": stats.families, "records_out": stats.consensus_out,
                      "launches": dict(cuda_vote.LAUNCHES),
                      "wall_s": time.monotonic() - t0}))
    return 0


# ---------------------------------------------------------------- bounds


# ---------------------------------------------------------------- phase 10


#: 10a's tenants: Phase 3's families split by family into this many BAMs
SERVE_TENANTS = 4
#: the serve engine's device batch (the `serve` subcommand's default)
SERVE_BATCH = 512
#: 10b/10c's head-size input: the families of Phase 3's input below this
SERVE_HEAD = 2_000


def split_by_family(src: str, paths: list, per: int) -> None:
    """Write `src`'s records of the families below per * len(paths) to
    paths[family // per] (each a contiguous family range, in input order,
    under src's header): one pass over the encoded records."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter

    with BamReader(src) as r:
        writers = [BamWriter(p, r.header, level=1) for p in paths]
        bufs: list[list] = [[] for _ in paths]
        try:
            for b in r.raw_records():
                k = family_of(b) // per
                if k >= len(paths):
                    continue
                bufs[k].append(b)
                if len(bufs[k]) >= 65_536:
                    writers[k].write_raw_many(bufs[k])
                    bufs[k] = []
            for w, buf in zip(writers, bufs):
                w.write_raw_many(buf)
        finally:
            for w in writers:
                w.close()


def records_by_tenant(path: str, per: int, n: int) -> list:
    """The sorted encoded records of `path` in each of the first n family
    ranges of `per` families."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    out: list[list] = [[] for _ in range(n)]
    with BamReader(path) as r:
        for b in r.raw_records():
            k = family_of(b) // per
            if k < n:
                out[k].append(b)
    return [sorted(x) for x in out]


def sorted_records(path: str) -> list:
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    with BamReader(path) as r:
        return sorted(r.raw_records())


def phase10(np, torch, work: str, inputs, families: int) -> dict:
    """The serving tier: 10a the in-process engine on Phase 3's families
    below `families` (a depth cut of --families for the run's time limit)
    in SERVE_TENANTS tenants (a main path), 10b `serve` in a child process
    over unix and tcp, 10c `route` over two replicas with one killed.
    Returns 10a's launches."""
    fasta, big, small, genome = inputs
    launches = phase10a(torch, work, big, families)
    head = family_subset(big, os.path.join(work, "serve", "head.bam"), SERVE_HEAD)
    ref = phase10b(work, head)
    phase10c(work, head, ref)
    return launches


def phase10a(torch, work: str, big: str, families: int) -> dict:
    from bsseqconsensusreads_tpu_torch.faults import failpoints
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.serve import ServeEngine
    from bsseqconsensusreads_tpu_torch.utils import compilecache

    d = os.path.join(work, "serve")
    os.makedirs(d, exist_ok=True)
    per = families // SERVE_TENANTS
    tenants = [os.path.join(d, f"tenant{k}.bam") for k in range(SERVE_TENANTS)]
    t0 = time.monotonic()
    split_by_family(big, tenants, per)
    log(f"phase10a input: {SERVE_TENANTS} tenants of {per} families split from Phase 3's input "
        f"in {time.monotonic() - t0:.1f} s")
    engine = ServeEngine(device="cuda", mode="self", batch_families=SERVE_BATCH, max_active=4)
    t0 = time.monotonic()
    engine.warmup()
    log(f"phase10a warmup: {time.monotonic() - t0:.2f} s, seg_vote launches "
        f"{cuda_vote.LAUNCHES['seg_vote']} (before the counts are set to 0)")
    outs = [os.path.join(d, f"served{k}.bam") for k in range(SERVE_TENANTS)]
    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    cuda_vote.SEG_VOTE_SHAPES.clear()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with PeakMemory(torch) as mem, prof:
        t0 = time.monotonic()
        jobs = [engine.submit({"input": p, "output": o}) for p, o in zip(tenants, outs)]
        engine.start()
        states = [engine.wait(j.id, timeout=900)["state"] for j in jobs]
        wall = time.monotonic() - t0
        drained = engine.drain(timeout=60)
    counts = dict(cuda_vote.LAUNCHES)
    shapes = [[list(k), v] for k, v in cuda_vote.SEG_VOTE_SHAPES.most_common()]
    busy = device_busy_s(torch, prof)
    counters = engine.scheduler.counters()
    fams = sum(j.families for j in jobs)
    summary = {
        "tenants": SERVE_TENANTS, "families": fams, "wall_s": wall,
        "families_per_s": fams / wall,
        "job_latency_s": {j.id: j.latency_s for j in jobs},
        "job_families": {j.id: j.families for j in jobs},
        "serve_batches": counters.get("serve_batches", 0),
        "batches_shared_jobs": counters.get("batches_shared_jobs", 0),
        "launches": counts, "device_busy_s": busy if busy > 0 else "not measured",
        "device_idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
        "compile_cache": {"enabled": compilecache.enabled(),
                          **dict(zip(("hit", "miss"), compilecache.counts()))},
        "engine_phases_s": dict(engine.scheduler.stats.metrics.seconds),
        "peak_host_rss_gib": mem.host_gib, "peak_device_allocated_gib": mem.device_gib,
        **pool_fields(counters),
    }
    log(f"phase10a serve {json.dumps(summary)}")
    log(f"phase10a seg_vote shapes: {json.dumps(shapes)}")
    check(states == ["done"] * SERVE_TENANTS, f"phase10a: job states {states}")
    check(summary["batches_shared_jobs"] > 0, "phase10a: no device batch held two tenants")
    check(counts["seg_vote"] > 0, "phase10a: seg_vote never launched")
    check(drained, "phase10a: drain(timeout=60) did not return True")
    check(failpoints.fired_total() == 0, "phase10a: a failpoint fired on an unarmed run")
    check_unarmed(counters, "phase10a")
    t0 = time.monotonic()
    want = records_by_tenant(os.path.join(work, "molecular.bam"), per, SERVE_TENANTS)
    for k, out in enumerate(outs):
        got = sorted_records(out)
        log(f"phase10a tenant {k}: {len(got)} records, equal to Phase 3's records of its "
            f"families: {got == want[k]}")
        check(got == want[k], f"phase10a tenant {k}: records differ from Phase 3's")
    solo = os.path.join(d, "standalone0.bam")
    t1 = time.monotonic()
    cli_io(["molecular", "-i", tenants[0], "-o", solo, "--mode", "self", "--batching",
            "sequential", "--batch-families", str(SERVE_BATCH)])
    same = sha256(solo) == sha256(outs[0])
    log(f"phase10a tenant 0 vs a standalone `molecular --batching sequential` on the card "
        f"({time.monotonic() - t1:.1f} s): sha256-equal={same}; the gates took "
        f"{time.monotonic() - t0:.1f} s")
    check(same, "phase10a: tenant 0 differs from the standalone molecular stage")
    return counts


def wait_ready_file(path: str, proc, timeout: float) -> list:
    """The addresses a serve or route child wrote to its ready file."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise SmokeFailure(f"{path}: the child exited {proc.returncode} before it was ready: "
                               f"{proc.stderr.read().decode()[-2000:]}")
        check(time.monotonic() < deadline, f"{path}: not ready in {timeout} s")
        time.sleep(0.1)
    with open(path) as fh:
        return fh.read().split()


def child_env(**extra) -> dict:
    return {**os.environ, "PYTHONPATH": REPO, **extra}


def phase10b(work: str, head: str) -> str:
    """`serve` in a child process on the card: `submit --wait` over its unix
    and tcp addresses (the bytes of `molecular --batching sequential` on
    the card and on the CPU), a bogus u32 length refused, and SIGTERM with
    two jobs admitted: exit 0, both done. Returns the reference SHA."""
    import signal
    import struct

    from bsseqconsensusreads_tpu_torch.serve import transport

    d = os.path.join(work, "serve")
    refs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(d, f"head_ref_{dev}.bam")
        t0 = time.monotonic()
        cli_io(["molecular", "-i", head, "-o", out, "--batching", "sequential",
                "--batch-families", str(SERVE_BATCH), "--device", dev])
        refs[dev] = sha256(out)
        log(f"phase10b standalone molecular on {dev}: {time.monotonic() - t0:.2f} s, "
            f"sha256 {refs[dev]}")
    check(refs["cuda"] == refs["cpu"], "phase10b: the standalone references differ card vs CPU")
    ready = os.path.join(d, "serve.addr")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "serve",
         "--address", f"unix:{os.path.join(d, 'serve.sock')}", "--address", "tcp:127.0.0.1:0",
         "--ready-file", ready, "--warmup", "--batch-families", str(SERVE_BATCH)],
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        addrs = wait_ready_file(ready, proc, 300)
        log(f"phase10b serve child ready in {time.monotonic() - t0:.1f} s on {addrs}")
        check(len(addrs) == 2, f"phase10b: the server bound {addrs}")
        for k, addr in enumerate(addrs):
            out = os.path.join(d, f"head_served{k}.bam")
            t1 = time.monotonic()
            cli_io(["submit", "--socket", addr, "-i", head, "-o", out, "--wait",
                    "--timeout", "300"])
            same = sha256(out) == refs["cuda"]
            log(f"phase10b submit --wait over {addr.split(':')[0]}: {time.monotonic() - t1:.2f} s, "
                f"sha256-equal to the standalone card and CPU runs: {same}")
            check(same, f"phase10b: the job over {addr} wrote other bytes")
        sock, kind = transport.connect(addrs[1], timeout=30)
        try:
            sock.sendall(struct.pack("!I", 0xFFFFFFF0))
            resp = transport.recv_message(sock, kind)
        finally:
            sock.close()
        log(f"phase10b bogus u32 length: {json.dumps(resp)}")
        check(resp.get("ok") is False and resp.get("guard") == "oversized_frame",
              "phase10b: a bogus frame length was not refused as oversized_frame")
        drained = [os.path.join(d, f"head_drained{k}.bam") for k in range(2)]
        for out in drained:
            resp = transport.request(addrs[1], {"op": "submit",
                                                "spec": {"input": head, "output": out}})
            check(resp.get("ok"), f"phase10b: submit refused {resp}")
        t1 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        err = proc.stderr.read().decode()
        log(f"phase10b SIGTERM with two jobs admitted: exit {rc} in {time.monotonic() - t1:.2f} s; "
            f"{err.strip().splitlines()[-1] if err.strip() else ''}")
        check(rc == 0, f"phase10b: serve exited {rc} on SIGTERM: {err[-2000:]}")
        same = [os.path.exists(o) and sha256(o) == refs["cuda"] for o in drained]
        log(f"phase10b drained jobs sha256-equal: {same}")
        check(all(same), "phase10b: a job admitted before SIGTERM was lost or differs")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    return refs["cuda"]


def phase10c(work: str, head: str, ref: str) -> None:
    """`route --replicas 2` on the one card with a shared, empty
    BSSEQ_TPU_COMPILE_CACHE_DIR and r0 armed to exit at its third retired
    batch: 4 jobs of the head input over tcp (affinity puts them on one
    replica), requeued when r0 dies; every output the reference bytes; one
    client submit under net_send=delay:0.2s and one under dup."""
    from bsseqconsensusreads_tpu_torch.faults import failpoints
    from bsseqconsensusreads_tpu_torch.serve import transport

    d = os.path.join(work, "fleet")
    os.makedirs(d, exist_ok=True)
    ready = os.path.join(d, "route.addr")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "route", "--replicas", "2",
         "--address", "tcp:127.0.0.1:0", "--ready-file", ready, "--rundir",
         os.path.join(d, "run"), "--warmup", "--batch-families", str(SERVE_BATCH),
         "--replica-failpoints", "r0:fleet_replica_exit=exit:9@batch=2"],
        env=child_env(BSSEQ_TPU_COMPILE_CACHE_DIR=os.path.join(d, "kernel_cache")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        (addr,) = wait_ready_file(ready, proc, 600)
        log(f"phase10c router and two replicas ready in {time.monotonic() - t0:.1f} s on {addr}")

        def replicas() -> dict:
            st = transport.request(addr, {"op": "fleet"}, timeout=60)["stats"]["replicas"]
            return {rid: {"alive": r["alive"], "generation": r["generation"],
                          "hit": r.get("counters", {}).get("compile_cache_hit", 0),
                          "miss": r.get("counters", {}).get("compile_cache_miss", 0)}
                    for rid, r in st.items()}

        boot = replicas()
        log(f"phase10c replicas at boot: {json.dumps(boot)}")
        reuse = [rid for rid, r in boot.items() if r["hit"] > 0 and r["miss"] == 0]
        check(reuse, "phase10c: no replica loaded the shared kernel builds without building")
        outs = [os.path.join(d, f"routed{k}.bam") for k in range(4)]
        ids = []
        t1 = time.monotonic()
        for out in outs:
            resp = transport.request(addr, {"op": "submit", "spec": {"input": head, "output": out}})
            check(resp.get("ok"), f"phase10c: submit refused {resp}")
            ids.append(resp["job"]["id"])
        states = [transport.request(addr, {"op": "wait", "job": j, "timeout": 300},
                                    timeout=330)["job"]["state"] for j in ids]
        counters = transport.request(addr, {"op": "fleet"})["stats"]["counters"]
        same = [sha256(o) == ref for o in outs]
        log(f"phase10c 4 jobs with r0 killed at its third batch: {time.monotonic() - t1:.1f} s, "
            f"states {states}, router {json.dumps(counters)}, sha256-equal to 10b: {same}")
        check(states == ["done"] * 4, f"phase10c: job states {states}")
        check(counters["jobs_requeued"] >= 1, "phase10c: the router requeued nothing")
        check(counters["jobs_routed"] == 4 + counters["jobs_requeued"],
              "phase10c: placements do not reconcile (routed != 4 jobs + requeues)")
        check(all(same), "phase10c: a routed job wrote other bytes")
        for schedule in ("net_send=delay:0.2s", "net_send=dup@peer=tcp:"):
            out = os.path.join(d, f"chaos_{schedule.split(':')[0].split('=')[1]}.bam")
            failpoints.arm(schedule)
            try:
                t1 = time.monotonic()
                cli_io(["submit", "--socket", addr, "-i", head, "-o", out, "--wait",
                        "--timeout", "300"])
            finally:
                failpoints.disarm()
            same = sha256(out) == ref
            log(f"phase10c client submit under {schedule}: {time.monotonic() - t1:.2f} s, "
                f"sha256-equal: {same}")
            check(same, f"phase10c: the submit under {schedule} wrote other bytes")
        counters = transport.request(addr, {"op": "fleet"})["stats"]["counters"]
        check(counters["jobs_routed"] == 6 + counters["jobs_requeued"],
              f"phase10c: the duplicated submit was admitted twice: {counters}")
        after = replicas()
        log(f"phase10c replicas after the kill: {json.dumps(after)} (router {json.dumps(counters)})")
        check(after["r0"]["generation"] >= 1 and after["r0"]["hit"] > 0
              and after["r0"]["miss"] == 0,
              "phase10c: the respawned r0 did not load the shared kernel builds")
        resp = transport.request(addr, {"op": "drain", "timeout": 300, "sent_s": time.time()},
                                 timeout=330)
        rc = proc.wait(timeout=300)
        log(f"phase10c drain: {json.dumps(resp)}, router exit {rc}")
        check(resp.get("drained") and rc == 0, "phase10c: the fleet did not drain")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def bounds_child(np, torch, work: str) -> None:
    """In a process started with CUDA_LAUNCH_BLOCKING=1: every Phase 2
    seg_vote case (the main paths' shapes, the edge and the deep ones)
    through the bounds-checked debug build against the release build
    (every output equal), then the head's molecular and duplex stages on
    the debug build (the release build's bytes)."""
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    dev = torch.device("cuda")
    for name, b, q, off, params in kernel_cases(np, torch, dev):
        outs = []
        for debug in (False, True):
            cuda_vote.use_bounds_checked_build(debug)
            outs.append(cuda_vote.seg_vote(b, q, off, params, with_ll=True))
            torch.cuda.synchronize()
        same = all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
        log(f"bounds case {name} {list(b.shape)} x {off.numel() - 1}: no trap, "
            f"debug == release: {same}")
        check(same, f"bounds {name}: the debug build's outputs differ")
    cuda_vote.use_bounds_checked_build(True)
    fasta = os.path.join(work, "genome.fa")
    for stage, inp, ref in (
        ("molecular", os.path.join(work, "grouped_head.bam"), "mol_head_cuda_native_unpacked.bam"),
        ("duplex", os.path.join(work, "mol_head_cuda_native_unpacked.bam"),
         "dup_head_cuda_native_unpacked.bam"),
    ):
        out = os.path.join(work, f"bounds_{stage}.bam")
        _stats, counts, wall = run_stage(stage, inp, out, fasta, "cuda", engine="native",
                                         transport="unpacked")
        same = sha256(out) == sha256(os.path.join(work, ref))
        log(f"bounds head {stage}: {wall:.2f} s, seg_vote launches {counts['seg_vote']}, "
            f"shapes {json.dumps([[list(k), v] for k, v in cuda_vote.SEG_VOTE_SHAPES.items()])}, "
            f"no trap, release bytes: {same}")
        check(same and counts["seg_vote"] > 0, f"bounds head {stage}: other bytes or no launch")


def phase_bounds(work: str) -> None:
    """The bounds-checked build in a child process under
    CUDA_LAUNCH_BLOCKING=1 (bounds_child); its lines are logged here."""
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_LAUNCH_BLOCKING": "1"}
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--bounds-check", work],
        env=env, capture_output=True, text=True, timeout=900,
    )
    for ln in res.stdout.splitlines():
        log(f"phase2b {ln}")
    log(f"phase2b bounds-checked build under CUDA_LAUNCH_BLOCKING=1: rc {res.returncode} "
        f"in {time.monotonic() - t0:.1f} s")
    check(res.returncode == 0, f"the bounds-checked build failed: {res.stderr[-3000:]}")


def engine_ab(np, torch, families: int) -> None:
    """The host engines in turns on the card — Python, native, native,
    Python — each through both stages on the same --families input, in
    one process: families/s and the host phases of every turn."""
    with tempfile.TemporaryDirectory(prefix="bsseq_ab_") as work:
        t0 = time.monotonic()
        fasta, big, _small = write_inputs(np, work, families, 0)
        log(f"ab input: {families} families written in {time.monotonic() - t0:.1f} s")
        rates = {"python": [], "native": []}
        for turn, engine in enumerate(("python", "native", "native", "python")):
            mol = os.path.join(work, f"mol_{turn}.bam")
            for stage, inp, out in (("molecular", big, mol),
                                    ("duplex", mol, os.path.join(work, f"dup_{turn}.bam"))):
                stats, _counts, wall = run_stage(stage, inp, out, fasta, "cuda", engine=engine,
                                                 transport="unpacked")
                row = {"turn": turn, "engine": engine, **stage_summary(stage, stats, wall),
                       "sha256": sha256(out)}
                log(f"ab stage {json.dumps(row)}")
                rates[engine].append((stage, row["families_per_s"], row["sha256"]))
        for stage in ("molecular", "duplex"):
            shas = {sha for eng in rates.values() for st, _r, sha in eng if st == stage}
            check(len(shas) == 1, f"ab {stage}: the engines wrote different bytes")
            mean = {eng: sum(r for st, r, _ in v if st == stage) / 2 for eng, v in rates.items()}
            log(f"ab {stage}: families/s python {mean['python']:.1f} native {mean['native']:.1f} "
                f"({mean['native'] / mean['python']:.2f}x)")


def build_all(log_ptxas: bool = True) -> None:
    """nvcc for csrc/vote.cu and g++ for each host library, all started
    together; seconds and the library paths."""
    from concurrent.futures import ThreadPoolExecutor

    from bsseqconsensusreads_tpu_torch.io import _nativelib
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    def timed_build(name, fn):
        t0 = time.monotonic()
        path = fn()
        return name, time.monotonic() - t0, path

    jobs = [("vote.cu (nvcc)", lambda: cuda_vote.build(verbose=log_ptxas)),
            ("vote.cu bounds-checked (nvcc)", lambda: cuda_vote.build(debug=True))]
    jobs += [(f"{name} (g++)", lambda name=name: _nativelib.build(name))
             for name in _nativelib.LIBRARIES]
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = [f.result() for f in [pool.submit(timed_build, n, fn) for n, fn in jobs]]
    for name, dt, path in done:
        log(f"phase1 build {name}: {dt:.1f} s -> {path}")
    log(f"phase1 builds, all at once: {time.monotonic() - t0:.1f} s")


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", type=int, default=200_000)
    ap.add_argument("--cpu-families", type=int, default=2_000)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 0-2 only: build and hold each kernel against its plain version")
    ap.add_argument("--engine-ab", action="store_true",
                    help="phases 0-1, then the Python and native host engines in turns "
                    "at --families")
    ap.add_argument("--bounds-check", metavar="WORKDIR", default="",
                    help="(run by the full run, under CUDA_LAUNCH_BLOCKING=1) the Phase 2 "
                    "cases and the head stages in WORKDIR on the bounds-checked build")
    ap.add_argument("--write-raw", metavar="WORKDIR", default="",
                    help="(run by the full run, beside Phase 3's input writing) Phase 6's "
                    "raw inputs of --families and --cpu-families in WORKDIR")
    ap.add_argument("--write-indel", metavar="WORKDIR", default="",
                    help="(run by the full run, beside Phase 3's input writing) Phase 8's "
                    "indel inputs of --families and --cpu-families in WORKDIR")
    ap.add_argument("--mesh-child", metavar="RANK,PORT,HEAD,WORKDIR", default="",
                    help="(run by the full run) one of Phase 9c's two processes")
    ap.add_argument("--phases", default="4,5,6,7,8,9,10",
                    help="the phases after Phase 3 to run (a short check of one phase: "
                    "--phases 10); the default, all of them, is the full run")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    except ImportError as exc:
        print(f"chip_smoke: the port is not next to this script ({exc})", file=sys.stderr)
        return 2
    if args.write_raw:
        write_inputs(np, args.write_raw, args.families, args.cpu_families, raw=True)
        return 0
    if args.write_indel:
        write_inputs(np, args.write_indel, args.families, args.cpu_families, indel=True)
        return 0
    if args.mesh_child:
        try:
            return mesh_child(args.mesh_child)
        except SmokeFailure as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1

    try:
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        log(f"phase0 card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
        dev = torch.device("cuda")

        build_all(log_ptxas=not args.bounds_check)
        if args.bounds_check:
            bounds_child(np, torch, args.bounds_check)
        elif args.engine_ab:
            engine_ab(np, torch, args.families)
        else:
            seg_rows, fin_rows, part_rows = phase2(np, torch, dev, args.repeats)
            if not args.kernels_only:
                case_shapes = {(*r["shape"], r["segments"]) for r in seg_rows}
                with tempfile.TemporaryDirectory(prefix="bsseq_smoke_") as work:
                    marks = [("start", time.monotonic())]
                    launches, summaries, inputs = phase3(
                        np, torch, work, args.families, args.cpu_families, case_shapes)
                    marks.append(("3", time.monotonic()))
                    log(f"phase 3 seconds: {marks[1][1] - marks[0][1]:.1f} (phases 0-2 before it: "
                        f"{marks[0][1] - T_START:.1f})")
                    phase_bounds(work)
                    marks.append(("2b", time.monotonic()))
                    for tag, more in (
                        ("4", lambda: phase4(np, torch, work, inputs, summaries[0], case_shapes)),
                        ("5", lambda: phase5(np, torch, work, inputs, summaries,
                                             args.families // 4)),
                        ("6", lambda: phase6(np, torch, work, inputs, summaries[0],
                                             args.families // 8, args.cpu_families)),
                        ("7", lambda: phase7(np, torch, work, inputs, args.cpu_families,
                                             args.families // 4)),
                        ("8", lambda: phase8(np, torch, work, inputs, args.families // 4,
                                             args.cpu_families)),
                        ("9", lambda: phase9(np, torch, work, inputs, summaries,
                                             args.cpu_families, args.families // 4)),
                        ("10", lambda: phase10(np, torch, work, inputs, args.families // 4)),
                    ):
                        if tag not in phases:
                            continue
                        for k, v in more().items():
                            launches[k] = launches.get(k, 0) + v
                        marks.append((tag, time.monotonic()))
                        log(f"phase {tag} seconds: {marks[-1][1] - marks[-2][1]:.1f} "
                            f"(since phase 3 began: {marks[-1][1] - marks[0][1]:.1f})")
                    log("phase seconds (3 with its inputs and the head): " + ", ".join(
                        f"{tag} {t - prev:.1f}" for (_p, prev), (tag, t) in zip(marks, marks[1:])))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    if args.engine_ab or args.kernels_only or args.bounds_check:
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
        }}))
        return 0

    def summary(rows):
        return [{k: r[k] for k in ("case", "ms", "spread", "profiler_ms", "bound_ms",
                                   "bound_share", "profiler_bound_share", "plain_ms",
                                   "library_ms")} for r in rows]

    kernels = []
    for name, line, rows, head in (
        ("seg_vote", 277, seg_rows, "molecular_packed_w192"),
        ("seg_vote_partials", 277, part_rows, "partials_k2_t2560_w192"),
        ("vote_finalize", 217, fin_rows, "vote_finalize_4096x192"),
    ):
        top = next(r for r in rows if r["case"] == head)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bsseqconsensusreads_tpu_torch/csrc/vote.cu",
            "replaces": f"bsseqconsensusreads_tpu/ops/pallas_vote.py:{line}",
            "launches": launches.get(name, 0),
            "max_abs_err": max(r.get("qual_max_abs", r.get("max_abs_err")) for r in rows),
            "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "bound_share": top["bound_share"],
            "profiler_bound_share": top["profiler_bound_share"],
            "launch_floor_ms": top["launch_floor_ms"], "shape": head, "cases": summary(rows),
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
