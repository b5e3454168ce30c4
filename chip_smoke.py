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
     qual, depth and errors equal. Times: CUDA events around each launch,
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
        200,000-family molecular BAM and the human-scale genome, transport
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

Prints the kernel table as one JSON line (launches: the main paths of
Phases 3, 3w, 4a, 5a and 5b together), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check exits non-zero.
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


def phase2(np, torch, dev, repeats: int) -> tuple[list[dict], list[dict]]:
    from bsseqconsensusreads_tpu_torch.models.molecular import vote_contrib
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
    return seg_rows, fin_rows


# ---------------------------------------------------------------- phase 3


#: the identity head's deep families: templates per strand of three of
#: its families — two on the deep route (pipeline/calling.py _split_deep,
#: above MAX_TEMPLATES 4,096) and one past DEEP_TEMPLATE_CAP 16,384
DEEP_HEAD = (4097, 5000, 16385)


def write_inputs(np, workdir: str, families: int, cpu_families: int):
    """The grouped BAM of `families` families, the head BAM of
    `cpu_families` families of the same mixture plus the DEEP_HEAD
    families spread among them, and the genome FASTA."""
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
    big = os.path.join(workdir, "grouped.bam")
    small = os.path.join(workdir, "grouped_head.bam")
    n_head = cpu_families + len(DEEP_HEAD)
    deep = {n_head * (i + 1) // (len(DEEP_HEAD) + 1): t for i, t in enumerate(DEEP_HEAD)}
    for path, n, tmpl in ((big, families, lambda fam: 1 if fam % 10 < 7 else 2),
                          (small, n_head, lambda fam: deep.get(fam, 1 if fam % 10 < 7 else 2))):
        with BamWriter(path, header, engine="native") as w:
            for rec in stream_duplex_families(
                codes, n, read_len=read_len, frag_extra=30, templates_for=tmpl,
                qual_for=lambda fam, ti, flag: qual_pool[(fam + ti * 13 + flag) & 63],
                mutate=mutate, bisulfite=True,
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
              engine: str = "native", *, transport: str):
    """One stage through the port's entry points, every host engine
    (ingest, emit, sort) named `engine` and the device transport named
    `transport` ('unpacked' or 'wire'; the duplex stage gets the FASTA as
    its refstore); returns (StageStats, per-kernel launches in this stage,
    wall seconds). With `prof`, a torch.profiler that records the card's
    activity, the stage runs under it."""
    import contextlib

    with prof if prof is not None else contextlib.nullcontext():
        return _run_stage(stage, inp, out, fasta, device, engine, transport)


def _run_stage(stage: str, inp: str, out: str, fasta: str, device: str, engine: str,
               transport: str):
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
                stages.molecular_ingest_stream(inp, reader, stats, ingest_choice=engine),
                ConsensusParams(min_reads=1), mode="self",
                batch_families=2048, grouping="coordinate", stats=stats,
                device=device, emit=engine, transport=transport,
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
                    refstore=fasta,
                )
                write_batch_stream(batches, out, reader.header, "self",
                                   sort_engine=engine, metrics=stats.metrics)
    wall = time.monotonic() - t0
    return stats, dict(cuda_vote.LAUNCHES), wall


HOST_PHASES = ("ingest", "encode", "host_vote", "rawize", "emit", "sort_write")
DEVICE_PHASES = ("kernel", "device_wait", "fetch")


def stage_summary(stage: str, stats, wall: float) -> dict:
    """families/s, the seconds of every phase of one stage run, the route
    its device batches took, the bytes each way per device batch and the
    wire's resolved qual modes."""
    m = stats.metrics.seconds
    c = stats.metrics.counters
    device_batches = c.get("route_batches_wire", 0) + c.get("route_batches_single", 0)
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
    # are; its data contig, the data genome, is appended after
    with ThreadPoolExecutor(1) as pool:
        t0 = time.monotonic()
        fillers = pool.submit(write_genome_fillers, np, work)
        fasta, big, small = write_inputs(np, work, families, cpu_families)
        log(f"phase3 input: {families} families written in {time.monotonic() - t0:.1f} s")
        genome = write_human_genome(np, fasta, *fillers.result())
    log(f"phase3 human-scale genome: {os.path.getsize(genome)} bytes, "
        f"{len(GRCH38_LENGTHS) + 1} contigs, written in {time.monotonic() - t0:.1f} s "
        "(beside the inputs)")

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
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue().splitlines()


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
    return reports[0], lines[-1], wall


def methyl_argv(inp: str, out: str, fasta: str, device: str, transport: str,
                engine: str = "auto") -> list[str]:
    """The duplex subcommand with --methyl both, at Phase 3's stage
    settings (mode self, 2048 families per batch, grouping coordinate)."""
    return ["duplex", "-i", inp, "-o", out, "--reference", fasta, "--mode", "self",
            "--batch-families", "2048", "--grouping", "coordinate", "--device", device,
            "--transport", transport, "--methyl", "both", "--methyl-engine", engine]


def phase5(np, torch, work: str, inputs, phase3_summaries) -> dict:
    """Methylation, fused into the duplex stage: 5a/5b at full size over
    the wire and unpacked (the main paths), 5c the head on the card and
    the CPU with both methyl engines and one batch's planes against the
    numpy twin, 5d a SIGKILLed checkpointed `run` with methyl resumed.
    Returns the kernels' launches on 5a and 5b."""
    fasta, _big, small, genome = inputs
    launches = phase5ab(torch, work, genome, phase3_summaries)
    phase5c(np, torch, work, fasta)
    phase5d(work, fasta, small)
    return launches


def phase5ab(torch, work: str, genome: str, phase3_summaries) -> dict:
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    p3, p3w = phase3_summaries
    mol = os.path.join(work, "molecular.bam")
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
        same = row["sha256"]["bam"] == sha256(os.path.join(work, ref_bam))
        log(f"phase{tag} duplex BAM vs phase 3's {ref_bam}: byte-identical={same}")
        check(same, f"phase{tag}: methyl changed the consensus BAM")
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


# ---------------------------------------------------------------- bounds


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
    args = ap.parse_args()

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
            seg_rows, fin_rows = phase2(np, torch, dev, args.repeats)
            if not args.kernels_only:
                case_shapes = {(*r["shape"], r["segments"]) for r in seg_rows}
                with tempfile.TemporaryDirectory(prefix="bsseq_smoke_") as work:
                    launches, summaries, inputs = phase3(
                        np, torch, work, args.families, args.cpu_families, case_shapes)
                    phase_bounds(work)
                    for k, v in phase4(np, torch, work, inputs, summaries[0],
                                       case_shapes).items():
                        launches[k] = launches.get(k, 0) + v
                    for k, v in phase5(np, torch, work, inputs, summaries).items():
                        launches[k] = launches.get(k, 0) + v
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
        ("vote_finalize", 217, fin_rows, "vote_finalize_4096x192"),
    ):
        top = next(r for r in rows if r["case"] == head)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "bsseqconsensusreads_tpu_torch/csrc/vote.cu",
            "replaces": f"bsseqconsensusreads_tpu/ops/pallas_vote.py:{line}",
            "launches": launches.get(name, 0),
            "max_abs_err": max(r["qual_max_abs"] for r in rows), "ms": top["ms"],
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
