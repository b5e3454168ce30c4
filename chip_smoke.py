#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bsseqconsensusreads_tpu_torch) on one
NVIDIA card: builds the hand-written vote kernels, holds each against its
plain PyTorch version at the main path's shapes, then drives the
molecular -> duplex consensus path end to end and checks what comes out.

    python3 chip_smoke.py                 # the full run (one card)
    python3 chip_smoke.py --families 2000 # a shorter main-path run

Phases:
  0. the card: `nvidia-smi --query-gpu=name,power.limit` and the device
     name; no CUDA device -> exit 2 with no result.
  1. build csrc/vote.cu with nvcc for sm_90a (ptxas report + seconds).
  2. each kernel against its plain version on the card at main-path shapes:
     CUDA-event times (L2 flushed before every launch), the byte bound at
     3.35 TB/s, mismatch counts under the port's contract — log-likelihood
     sums bit-identical, base/depth/errors equal outside the tie band, qual
     within 1 — and one PyTorch library call over the same contributions
     (torch.segment_reduce) as a yardstick the port never calls.
  3. end to end: a grouped BAM of --families families (the JAX package's
     tools/scale_rehearsal.py mixture: read length 150, fragment 180, 2 Mb
     genome, 70% one template per strand and the rest two, RTA3-binned
     quals, ~1.3% substitutions), the molecular stage (mode 'self',
     grouping 'coordinate', 2048 families per batch), write_batch_stream,
     the duplex stage, write_batch_stream — with the kernels' launch counts
     set to 0 before and read after each stage, and each stage under
     torch.profiler (the card's activity only) for its device busy
     seconds and idle share. Then the first
     --cpu-families families through both stages on the card and with
     device='cpu', stage by stage on identical input, and the qual tables
     built on the card against the CPU-built ones.

Prints the kernel table as one JSON line, the nvidia-smi line, and last
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
    flush, with CUDA events around the launch alone."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / repeats


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
    """The seg_vote shapes of the main path, as (name, bases, quals,
    offsets) on the card (quals already co-called where the path co-calls)."""
    from bsseqconsensusreads_tpu_torch.models.molecular import overlap_cocall

    rng = np.random.default_rng(2024)
    cases = []
    for w in (192, 4096):
        f, n = 2048, 8192  # families, pow2 row bucket
        lens = 1 + rng.multinomial(n - f, np.full(f, 1.0 / f))
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        b, q = random_rows(np, rng, n, 2, w, 150)
        bt, qt = overlap_cocall(
            torch.from_numpy(b).to(dev), torch.from_numpy(q).to(dev).to(torch.int16)
        )
        cases.append((f"molecular_packed_w{w}", bt.contiguous(), qt.contiguous(),
                      torch.from_numpy(offsets).to(dev)))
    f = 2048  # duplex: 4 rows per family, 2-row segments, 1 plane
    b, q = random_rows(np, rng, 4 * f, 1, 192, 150)
    cases.append(("duplex_packed_w192", torch.from_numpy(b).to(dev),
                  torch.from_numpy(q).to(dev).to(torch.int16),
                  torch.arange(0, 4 * f + 1, 2, dtype=torch.int32, device=dev)))
    b, q = random_rows(np, rng, 512 * 2, 1, 512, 512)  # the qual-table build
    cases.append(("padded_g512_t2_w512", torch.from_numpy(b).to(dev),
                  torch.from_numpy(q).to(dev).to(torch.int16),
                  torch.arange(0, 1025, 2, dtype=torch.int32, device=dev)))
    b, q = random_rows(np, rng, 2048 * 8, 2, 192, 150)  # G = 2048 x 2 planes
    cases.append(("padded_g4096_t8_w192", torch.from_numpy(b).to(dev),
                  torch.from_numpy(q).to(dev).to(torch.int16),
                  torch.arange(0, 2048 * 8 + 1, 8, dtype=torch.int32, device=dev)))
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


def phase2(np, torch, dev, repeats: int) -> list[dict]:
    from bsseqconsensusreads_tpu_torch.models.molecular import vote_contrib
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote, phred

    params = ConsensusParams()
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > L2
    table = phred.log_table(params.error_rate_post_umi, dev)
    rows = []
    for name, b, q, off in kernel_cases(np, torch, dev):
        got = cuda_vote.seg_vote(b, q, off, params, with_ll=True)
        want = cuda_vote.seg_vote_plain(b, q, off, params, with_ll=True)
        torch.cuda.synchronize()
        res = compare_vote(np, torch, got, want)
        ms = time_ms(torch, lambda: cuda_vote.seg_vote(b, q, off, params), repeats, flush)
        plain_ms = time_ms(torch, lambda: cuda_vote.seg_vote_plain(b, q, off, params),
                           max(2, repeats // 10), flush)
        lib_ms = None
        if hasattr(torch, "segment_reduce"):
            contrib = vote_contrib(b, q, table, params.min_input_base_quality)[0]
            contrib = contrib.reshape(b.shape[0], -1)
            lengths = (off[1:] - off[:-1]).to(torch.int64)
            lib_ms = time_ms(
                torch, lambda: torch.segment_reduce(contrib, "sum", lengths=lengths),
                repeats, flush,
            )
            del contrib
        bytes_ms, ops_ms = seg_vote_bound_ms(b, off)
        row = {
            "case": name, "shape": list(b.shape), "segments": off.numel() - 1,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **res,
        }
        log(f"phase2 seg_vote {json.dumps(row)}")
        check(res["ll_bits_differ"] == 0, f"{name}: log-likelihood sums differ from the plain version")
        for k in ("base", "depth", "errors"):
            check(res[f"{k}_differ_outside_tie"] == 0, f"{name}: {k} differs outside the tie band")
        check(res["qual_max_abs"] <= 1, f"{name}: a qual differs by more than 1")
        rows.append(row)

    # vote_finalize on ll [4096, 192, 4] from a molecular vote
    b, q = random_rows(np, np.random.default_rng(7), 4096 * 4, 1, 192, 150)
    off = torch.arange(0, 4096 * 4 + 1, 4, dtype=torch.int32, device=dev)
    vote = cuda_vote.seg_vote_plain(
        torch.from_numpy(b).to(dev), torch.from_numpy(q).to(dev).to(torch.int16),
        off, params, with_ll=True,
    )
    ll = vote["ll"].reshape(4096, 192, 4).contiguous()
    depth = vote["depth"].reshape(4096, 192).to(torch.int32)
    kb, kq = cuda_vote.vote_finalize(ll, depth, params)
    pb, pq = cuda_vote.vote_finalize_plain(ll, depth, params)
    srt = np.sort(ll.cpu().numpy(), axis=-1)
    tie = (srt[..., 3] - srt[..., 2]) <= TIE_TOL
    dbase = kb.cpu().numpy() != pb.cpu().numpy()
    dq = np.abs(kq.cpu().numpy().astype(int) - pq.cpu().numpy().astype(int))
    ms = time_ms(torch, lambda: cuda_vote.vote_finalize(ll, depth, params), repeats, flush)
    plain_ms = time_ms(torch, lambda: cuda_vote.vote_finalize_plain(ll, depth, params),
                       max(2, repeats // 10), flush)
    cols = 4096 * 192
    bytes_ms = cols * (16 + 4 + 2) / HBM_BYTES_PER_S * 1e3
    ops_ms = cols * 25 / FP32_OPS_PER_S * 1e3
    row = {
        "case": "vote_finalize_4096x192", "shape": [4096, 192, 4], "ms": ms,
        "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "base_differ_outside_tie": int((dbase & ~tie).sum()),
        "base_differ": int(dbase.sum()), "qual_differ": int((dq > 0).sum()),
        "qual_max_abs": int(dq.max()), "tie_columns": int(tie.sum()),
    }
    log(f"phase2 vote_finalize {json.dumps(row)}")
    check(row["base_differ_outside_tie"] == 0, "vote_finalize: base differs outside the tie band")
    check(row["qual_max_abs"] <= 1, "vote_finalize: a qual differs by more than 1")
    rows.append(row)
    return rows


# ---------------------------------------------------------------- phase 3


def write_inputs(np, workdir: str, families: int, cpu_families: int):
    """The grouped BAM of `families` families and the one of its first
    `cpu_families` families, plus the genome FASTA."""
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
    with BamWriter(big, header) as wb, BamWriter(small, header) as ws:
        for rec in stream_duplex_families(
            codes, families, read_len=read_len, frag_extra=30,
            templates_for=lambda fam: 1 if fam % 10 < 7 else 2,
            qual_for=lambda fam, ti, flag: qual_pool[(fam + ti * 13 + flag) & 63],
            mutate=mutate, bisulfite=True,
        ):
            wb.write(rec)
            if int(rec.get_tag("MI").split("/")[0]) < cpu_families:
                ws.write(rec)
    return fasta, big, small


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


def run_stage(stage: str, inp: str, out: str, fasta: str, device: str, prof=None):
    """One stage through the port's entry points; returns (StageStats,
    per-kernel launches in this stage, wall seconds). With `prof`, a
    torch.profiler that records the card's activity, the stage runs under
    it."""
    import contextlib

    with prof if prof is not None else contextlib.nullcontext():
        return _run_stage(stage, inp, out, fasta, device)


def _run_stage(stage: str, inp: str, out: str, fasta: str, device: str):
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote
    from bsseqconsensusreads_tpu_torch.pipeline import calling
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream

    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    stats = calling.StageStats(stage=stage)
    t0 = time.monotonic()
    with BamReader(inp) as reader:
        if stage == "molecular":
            batches = calling.call_molecular_batches(
                reader, ConsensusParams(min_reads=1), mode="self",
                batch_families=2048, grouping="coordinate", stats=stats,
                device=device,
            )
            write_batch_stream(batches, out, reader.header, "self")
        else:
            with FastaFile(fasta) as fa:
                names = [n for n, _ in reader.header.references]
                batches = calling.call_duplex_batches(
                    reader, fa.fetch, names, ConsensusParams(min_reads=0),
                    mode="self", batch_families=2048, grouping="coordinate",
                    stats=stats, device=device,
                )
                write_batch_stream(batches, out, reader.header, "self")
    wall = time.monotonic() - t0
    return stats, dict(cuda_vote.LAUNCHES), wall


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def diff_records(a_path: str, b_path: str) -> tuple[int, int, str]:
    """(records, differing records, first difference) between two BAMs;
    raises unless every difference is a qual byte off by one."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader

    n = ndiff = 0
    first = ""
    with BamReader(a_path) as ra, BamReader(b_path) as rb:
        for ra_rec, rb_rec in zip(ra, rb, strict=True):
            n += 1
            qa, qb = ra_rec.qual or b"", rb_rec.qual or b""
            same_rest = (
                ra_rec.qname == rb_rec.qname and ra_rec.flag == rb_rec.flag
                and ra_rec.pos == rb_rec.pos and ra_rec.seq == rb_rec.seq
                and ra_rec.cigar == rb_rec.cigar and len(qa) == len(qb)
            )
            if same_rest and qa == qb and ra_rec.tags == rb_rec.tags:
                continue
            ndiff += 1
            if not first:
                first = f"{ra_rec.qname} flag {ra_rec.flag} pos {ra_rec.pos}"
            check(same_rest, f"record {ra_rec.qname} differs beyond its quals")
            check(
                all(abs(x - y) <= 1 for x, y in zip(qa, qb)),
                f"record {ra_rec.qname}: a qual differs by more than 1",
            )
    return n, ndiff, first


def phase3(np, torch, families: int, cpu_families: int) -> dict:
    with tempfile.TemporaryDirectory(prefix="bsseq_smoke_") as work:
        return _phase3(np, torch, work, families, cpu_families)


def _phase3(np, torch, work: str, families: int, cpu_families: int) -> dict:
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
    from bsseqconsensusreads_tpu_torch.ops import reconstruct

    t0 = time.monotonic()
    fasta, big, small = write_inputs(np, work, families, cpu_families)
    log(f"phase3 input: {families} families written in {time.monotonic() - t0:.1f} s")

    # the main path: the kernels' counts cover exactly these two stages, and
    # the qual tables are built inside them (first use on this device)
    reconstruct._CACHE.clear()
    launches = {}
    for stage, inp, out in (
        ("molecular", big, os.path.join(work, "molecular.bam")),
        ("duplex", os.path.join(work, "molecular.bam"), os.path.join(work, "duplex.bam")),
    ):
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        stats, counts, wall = run_stage(stage, inp, out, fasta, "cuda", prof)
        busy = device_busy_s(torch, prof)
        m = stats.metrics.seconds
        summary = {
            "stage": stage, "families": stats.families,
            "families_per_s": stats.families / wall, "wall_s": wall,
            "records_in": stats.records_in, "records_out": stats.consensus_out,
            "batches": stats.batches, "skipped_families": stats.skipped_families,
            "kernel_s": m.get("kernel", 0.0), "device_wait_s": m.get("device_wait", 0.0),
            "fetch_s": m.get("fetch", 0.0), "host_vote_s": m.get("host_vote", 0.0),
            "encode_s": m.get("encode", 0.0), "ingest_s": m.get("ingest", 0.0),
            "emit_s": m.get("emit", 0.0), "rawize_s": m.get("rawize", 0.0),
            "device_busy_s": busy if busy > 0 else "not measured",
            "device_idle_share": 1.0 - busy / wall if busy > 0 else "not measured",
            "launches": counts, "sha256": sha256(out),
        }
        log(f"phase3 stage {json.dumps(summary)}")
        check(stats.families > 0 and stats.consensus_out > 0, f"{stage}: no output")
        check(counts["seg_vote"] > 0, f"{stage}: seg_vote never launched")
        if stage == "molecular":
            check(counts["vote_finalize"] > 0, "molecular: vote_finalize never launched")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # card vs CPU, stage by stage on identical input
    for stage, inp in (("molecular", small), ("duplex", os.path.join(work, "mol_head_cuda.bam"))):
        outs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(work, f"{stage[:3]}_head_{dev}.bam")
            run_stage(stage, inp, out, fasta, dev)
            outs[dev] = out
        n, ndiff, first = diff_records(outs["cuda"], outs["cpu"])
        same = sha256(outs["cuda"]) == sha256(outs["cpu"])
        log(f"phase3 card-vs-cpu {stage}: {n} records, {ndiff} differ, "
            f"byte-identical={same}" + (f", first: {first}" if first else ""))
        check(n > 0, f"{stage}: the card-vs-CPU comparison saw no records")

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
        dq = np.abs(a.astype(np.int32) - b.astype(np.int32))
        over = int((dq > 1).sum())
        log(f"phase3 qual table {name}: {d} entries differ, {over} by more than 1")
        if d:
            idx = np.argwhere(a != b)[:10].tolist()
            log(f"phase3 qual table {name}: differing entries {idx}")
        check(over == 0, f"qual table {name}: {over} entries differ by more than 1")
    return launches


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", type=int, default=20_000)
    ap.add_argument("--cpu-families", type=int, default=2_000)
    ap.add_argument("--repeats", type=int, default=20)
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

        t0 = time.monotonic()
        cuda_vote.build(verbose=True)
        log(f"phase1 build: {time.monotonic() - t0:.1f} s -> {cuda_vote.LIBRARY}")

        rows = phase2(np, torch, dev, args.repeats)
        launches = phase3(np, torch, args.families, args.cpu_families)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    seg = next(r for r in rows if r["case"] == "molecular_packed_w192")
    fin = next(r for r in rows if r["case"].startswith("vote_finalize"))
    kernels = [
        {
            "name": "seg_vote", "route": "cuda",
            "source": "bsseqconsensusreads_tpu_torch/csrc/vote.cu",
            "replaces": "bsseqconsensusreads_tpu/ops/pallas_vote.py:277",
            "launches": launches.get("seg_vote", 0),
            "max_abs_err": max(r["qual_max_abs"] for r in rows[:-1]), "ms": seg["ms"],
            "plain_ms": seg["plain_ms"], "bound_ms": seg["bound_ms"],
            "bound_by": seg["bound_by"], "library_ms": seg["library_ms"],
            "shape": seg["case"], "cases": rows[:-1],
        },
        {
            "name": "vote_finalize", "route": "cuda",
            "source": "bsseqconsensusreads_tpu_torch/csrc/vote.cu",
            "replaces": "bsseqconsensusreads_tpu/ops/pallas_vote.py:217",
            "launches": launches.get("vote_finalize", 0),
            "max_abs_err": fin["qual_max_abs"], "ms": fin["ms"],
            "plain_ms": fin["plain_ms"], "bound_ms": fin["bound_ms"],
            "bound_by": fin["bound_by"], "library_ms": fin["library_ms"],
            "shape": fin["case"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
