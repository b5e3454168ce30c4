"""Command-line interface: `python -m bsseqconsensusreads_tpu_torch <cmd>`.

Subcommands of the JAX package's CLI, with the same flag names, on the
card:

* run       — the whole pipeline for one sample (pipeline.stages
              run_pipeline): config, the workflow DAG with mtime reruns,
              intra-stage checkpoints, aligner self | none | bwameth
* molecular — the molecular consensus stage (fgbio
              CallMolecularConsensusReads equivalent, main.snake.py:54)
* duplex    — the fused duplex stage (the reference's convert -> extend ->
              sort -> callduplex chain, main.snake.py:121-164)
* sam-to-fastq / zipper / filter-mapped — the standalone record ops the
              bwameth path runs (Picard SamToFastq, fgbio ZipperBams,
              samtools view -F 4)
* sort      — fgbio SortBam / samtools sort equivalent (external merge,
              bounded memory): --order coordinate | name |
              template-coordinate
* group     — fgbio GroupReadsByUmi equivalent (pipeline.group_umi): RX ->
              MI with /A|/B duplex suffixes; GroupStats JSON on stderr
* metrics   — fgbio CollectDuplexSeqMetrics equivalent (pipeline.metrics)
              over an MI-grouped BAM, read through the native columnar
              decoder (a failed build raises NativeLibraryError: no Python
              fallback); JSON on stdout
* filter-consensus — fgbio FilterConsensusReads equivalent
              (pipeline.filter); FilterStats JSON on stderr
* serve     — the resident engine (serve/): jobs over unix / TCP
              addresses share device batches, each job's bytes those of
              a standalone `molecular --batching sequential`; SIGTERM
              drains
* route     — N serve replicas of this package behind one router
              (placement, requeue on a replica's death, drain)
* submit / serve-ctl — the protocol's client and operator halves

With BSSEQ_TPU_STATS set (a path, or '-' for stderr) run, molecular,
duplex, serve and route write the JAX package's run ledger
(utils.observe); BSSEQ_TPU_COMPILE_CACHE_DIR points the kernel builds at a
shared directory (utils.compilecache).

`run` takes a grouped BAM or a raw aligned one (RX, no MI): with the
default group_umis 'auto' the latter is grouped first. duplex
--passthrough writes the stage's leftover records through with the
reference's convert-stage treatment (Python ingest; refuses --ingest
native and --chemistry none).

--device cuda|cpu picks where the vote runs (default cuda, or the
config's `backend` on `run`; with no card the command fails rather than
falling back). --transport auto|wire|unpacked picks how molecular and
duplex batches cross to the device: one packed wire each way (duplex:
with the --reference genome uploaded to the device once) or the plain
tensors; 'auto' is the wire on the card and unpacked on the CPU. Same
bytes either way. --ingest and --emit pick the host engines: the port's C++
libraries (built from csrc/host at first use; a failed build fails the
command) or the Python twins, with byte-identical output. --methyl
bedmethyl|cx|both on duplex and run extracts methylation in the duplex
stage and writes <output>.bedmethyl / <output>.CX_report.txt (or at
--methyl-out); duplex then prints one {"methyl": report} line on stderr.
molecular and duplex write their StageStats as one JSON line on stderr;
run prints {target, stats} on stdout and one [ran|skip] line per rule on
stderr.

The batch engine of the JAX package's accelerator defaults: 2 overlap
workers on the card (BSSEQ_TPU_OVERLAP_THREADS; 0 on the CPU), each on
its own CUDA stream, and min(4, cores-1) host workers
(BSSEQ_TPU_HOST_WORKERS) for encode, rawize and emit; the bytes are the
same for any count. --failpoints on molecular, duplex and run (or
BSSEQ_TPU_FAILPOINTS) arms a fault-injection schedule
(faults.failpoints); faults are retried (BSSEQ_TPU_RETRY_MAX,
BSSEQ_TPU_RETRY_BACKOFF_S) and a batch that keeps failing degrades to the
plain PyTorch version on the CPU, counted and printed; a CUDA, kernel
build or host library error is never retried. The input guard
(BSSEQ_TPU_INPUT_POLICY strict|quarantine|lenient|off, default strict)
runs on molecular, duplex and run: under strict, bad input exits 3 with
one `input error [<reason>]: ...` line and no traceback.
"""

from __future__ import annotations

import argparse
import json
import sys

from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.utils import observe


def _add_params(p: argparse.ArgumentParser, min_reads_default: int) -> None:
    p.add_argument("--error-rate-pre-umi", type=float, default=45.0)
    p.add_argument("--error-rate-post-umi", type=float, default=30.0)
    p.add_argument("--min-input-base-quality", type=int, default=0)
    p.add_argument("--min-consensus-base-quality", type=int, default=0)
    p.add_argument("--min-reads", type=int, default=min_reads_default)
    p.add_argument(
        "--no-consensus-call-overlapping-bases",
        action="store_true",
        help="disable R1/R2 overlap co-calling",
    )
    p.add_argument("--batch-families", type=int, default=512)
    p.add_argument("--max-window", type=int, default=4096)
    p.add_argument(
        "--ingest", choices=("auto", "native", "python"), default="auto",
        help="record ingest engine: the C++ columnar decoder (with C-side "
        "grouping + encode digest on coordinate input) or pure-Python "
        "BamReader — byte-identical output either way",
    )
    p.add_argument(
        "--grouping",
        choices=("gather", "adjacent", "coordinate"),
        default="coordinate",
        help="MI-group streaming strategy (coordinate = bounded memory on sorted input)",
    )
    p.add_argument(
        "--emit",
        choices=("auto", "native", "python"),
        default="auto",
        help="record emission: native C++ batch serializer vs per-record "
        "Python objects (auto = native)",
    )
    p.add_argument(
        "--transport", choices=("auto", "wire", "unpacked"), default="auto",
        help="device transport: ONE packed u32 array per direction (+ the "
        "device-resident genome on duplex) or plain tensors — byte-identical "
        "output either way; 'auto' = wire on the card, unpacked on the CPU",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the vote runs: the card (default) or the plain "
        "PyTorch versions on the host",
    )
    _add_failpoints(p)


def _add_failpoints(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--failpoints", default="",
        help="fault-injection schedule, e.g. "
        "'dispatch_kernel=raise:RuntimeError@batch=7;"
        "extsort_spill=io_error:p=0.01:seed=42' (overrides BSSEQ_TPU_FAILPOINTS)",
    )


def _arm_failpoints(args) -> None:
    """Arm --failpoints; a bad schedule prints its error and arms
    nothing, as in the JAX CLI."""
    if getattr(args, "failpoints", ""):
        from bsseqconsensusreads_tpu_torch.faults import failpoints
        from bsseqconsensusreads_tpu_torch.utils.observe import stderr_line

        try:
            failpoints.arm(args.failpoints)
        except failpoints.FailpointError as exc:
            stderr_line(f"--failpoints: {exc}")


def _params(args) -> ConsensusParams:
    return ConsensusParams(
        error_rate_pre_umi=args.error_rate_pre_umi,
        error_rate_post_umi=args.error_rate_post_umi,
        min_input_base_quality=args.min_input_base_quality,
        min_consensus_base_quality=args.min_consensus_base_quality,
        consensus_call_overlapping_bases=not args.no_consensus_call_overlapping_bases,
        min_reads=args.min_reads,
    )


def cmd_molecular(args) -> int:
    from bsseqconsensusreads_tpu_torch.faults import guard as _guard
    from bsseqconsensusreads_tpu_torch.pipeline.calling import (
        StageStats,
        call_molecular_batches,
    )
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
    from bsseqconsensusreads_tpu_torch.pipeline.stages import (
        molecular_ingest_stream,
        open_guarded_reader,
    )

    _arm_failpoints(args)
    observe.open_ledger(component="molecular-cli")
    stats = StageStats(stage="molecular")
    g = _guard.Guard.from_env(stats)
    try:
        with open_guarded_reader(args.input, g) as reader:
            batches = call_molecular_batches(
                molecular_ingest_stream(
                    args.input, reader, stats,
                    ingest_choice=args.ingest, grouping=args.grouping, guard=g,
                    indel_policy=args.indel_policy,
                ),
                params=_params(args),
                mode=args.mode,
                batch_families=args.batch_families,
                max_window=args.max_window,
                grouping=args.grouping,
                stats=stats,
                batching=args.batching,
                device=args.device,
                emit=args.emit,
                transport=args.transport,
                indel_policy=args.indel_policy,
                guard=g,
            )
            write_batch_stream(batches, args.output, reader.header, args.mode,
                               metrics=stats.metrics)
    finally:
        g.close()
    observe.emit_stage_stats({"molecular": stats})
    observe.flush_sinks()
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_duplex(args) -> int:
    from bsseqconsensusreads_tpu_torch.faults import guard as _guard
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
    from bsseqconsensusreads_tpu_torch.pipeline.calling import (
        StageStats,
        call_duplex_batches,
    )
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
    from bsseqconsensusreads_tpu_torch.pipeline.stages import (
        duplex_ingest_stream,
        open_guarded_reader,
    )

    _arm_failpoints(args)
    observe.open_ledger(component="duplex-cli")
    stats = StageStats(stage="duplex")
    methyl_acc = None
    store = args.reference  # the FASTA path; loaded only if the wire engages
    if args.methyl != "off":
        from bsseqconsensusreads_tpu_torch.methyl.tally import MethylAccumulator
        from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore
        from bsseqconsensusreads_tpu_torch.pipeline.stages import methyl_paths

        with stats.metrics.timed("genome_load"), stats.metrics.timed("genome_load.read"):
            store = RefStore.from_fasta(args.reference)
        methyl_acc = MethylAccumulator(
            store, *methyl_paths(args.methyl, args.methyl_out or args.output),
            metrics=stats.metrics, engine=args.emit,
        )
    g = _guard.Guard.from_env(stats)
    with FastaFile(args.reference) as fasta, open_guarded_reader(args.input, g) as reader:
        names = [n for n, _ in reader.header.references]
        batches = call_duplex_batches(
            duplex_ingest_stream(
                args.input, reader, stats,
                ingest_choice=args.ingest, grouping=args.grouping,
                passthrough=args.passthrough, guard=g,
            ),
            fasta.fetch,
            names,
            params=_params(args),
            mode=args.mode,
            batch_families=args.batch_families,
            max_window=args.max_window,
            grouping=args.grouping,
            stats=stats,
            pos0=args.pos0,
            device=args.device,
            emit=args.emit,
            chemistry=args.chemistry,
            transport=args.transport,
            refstore=store,
            methyl=methyl_acc,
            methyl_engine=args.methyl_engine,
            passthrough=args.passthrough,
            guard=g,
        )
        try:
            write_batch_stream(batches, args.output, reader.header, args.mode,
                               metrics=stats.metrics)
        finally:
            g.close()
    if methyl_acc is not None:
        report = methyl_acc.finalize()
        print(json.dumps({"methyl": report}), file=sys.stderr)
    observe.emit_stage_stats({"duplex": stats})
    observe.flush_sinks()
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_run(args) -> int:
    import os

    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline
    from bsseqconsensusreads_tpu_torch.utils.observe import stderr_line

    _arm_failpoints(args)
    cfg = FrameworkConfig.from_yaml(args.config) if args.config else FrameworkConfig()
    if args.device:
        cfg.backend = args.device
    if args.aligner:
        cfg.aligner = args.aligner
    if args.reference:
        cfg.genome_dir = os.path.dirname(args.reference) or "."
        cfg.genome_fasta_file_name = os.path.basename(args.reference)
    if args.chemistry:
        cfg.chemistry = args.chemistry
    if args.methyl:
        cfg.methyl = args.methyl
    if args.methyl_out:
        cfg.methyl_out = args.methyl_out
    if args.single_strand:
        cfg.single_strand = True
    if args.sort_engine:
        cfg.sort_engine = args.sort_engine
    if args.sort_buckets:
        cfg.sort_buckets = args.sort_buckets
    if args.stream_interstage:
        cfg.stream_interstage = True
    target, results, stats = run_pipeline(cfg, args.bam, outdir=args.outdir, force=args.force)
    for r in results:
        status = "ran" if r.ran else "skip"
        stderr_line(f"[{status}] {r.name} ({r.seconds:.2f}s) {r.reason}")
    print(json.dumps({"target": target, "stats": {k: s.as_dict() for k, s in stats.items()}}))
    return 0


def cmd_sort(args) -> int:
    """`fgbio SortBam` / `samtools sort` equivalent (main.snake.py:106,152):
    external-merge sort in bounded memory, order from --order."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import sorted_write
    from bsseqconsensusreads_tpu_torch.pipeline.record_ops import (
        coordinate_key,
        name_key,
        template_coordinate_key,
    )

    key, so, ss = {
        "coordinate": (coordinate_key, "coordinate", None),
        "name": (name_key, "queryname", None),
        # fgbio SortBam -s TemplateCoordinate declares the sub-sort
        "template-coordinate": (template_coordinate_key, "unsorted", "template-coordinate"),
    }[args.order]
    with BamReader(args.input) as reader:
        header = reader.header.with_sort_order(so, ss)
        n = sorted_write(reader, key, args.output, header)
    print(json.dumps({"records": n, "order": args.order}), file=sys.stderr)
    return 0


def cmd_group(args) -> int:
    """`fgbio GroupReadsByUmi` equivalent (the step producing the
    reference's input contract, README.md:51-55): MI molecule ids from RX
    UMIs, /A|/B duplex strand suffixes under -s paired, bounded memory via
    two external passes."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter
    from bsseqconsensusreads_tpu_torch.pipeline.group_umi import (
        GroupStats,
        group_reads_by_umi_raw,
        grouped_header,
    )

    stats = GroupStats()
    with BamReader(args.input) as reader:
        with BamWriter(args.output, grouped_header(reader.header)) as w:
            w.write_raw_many(
                group_reads_by_umi_raw(
                    reader, reader.header,
                    strategy=args.strategy, edits=args.edits,
                    raw_tag=args.raw_tag, min_map_q=args.min_map_q,
                    stats=stats,
                )
            )
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_metrics(args) -> int:
    """`fgbio CollectDuplexSeqMetrics` equivalent (pipeline.metrics):
    family-size histograms and duplex yield from an MI-grouped BAM, one
    streaming pass over the native columnar views (they carry the qname
    and MI this reads), JSON on stdout. The native library is required:
    a failed build raises io._nativelib.NativeLibraryError."""
    from bsseqconsensusreads_tpu_torch.io import native
    from bsseqconsensusreads_tpu_torch.pipeline import ingest
    from bsseqconsensusreads_tpu_torch.pipeline.metrics import duplex_seq_metrics

    native.lib()
    m = duplex_seq_metrics(ingest.columnar_records(args.input))
    print(json.dumps(m.as_dict(), indent=None if args.compact else 1))
    return 0


def cmd_filter_consensus(args) -> int:
    """`fgbio FilterConsensusReads` equivalent (pipeline.filter): the
    filtered variant the reference's dead rule hints at
    (main.snake.py:70-80) — read-level drops on depth/error rate,
    per-base masking, template-atomic. Each record is decoded and
    encoded again before the blob filter, as the JAX package's CLI
    writes it, so input from any writer leaves with that CLI's bytes."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter, encode_record
    from bsseqconsensusreads_tpu_torch.pipeline.filter import (
        FilterParams,
        FilterStats,
        filter_consensus_raw,
        filtered_header,
        probe_strand_tag_support,
    )

    params = FilterParams(
        min_reads=tuple(args.min_reads),
        max_read_error_rate=args.max_read_error_rate,
        max_base_error_rate=args.max_base_error_rate,
        min_base_quality=args.min_base_quality,
        max_no_call_fraction=args.max_no_call_fraction,
        min_mean_base_quality=args.min_mean_base_quality,
        require_single_strand_agreement=args.require_single_strand_agreement,
    )
    stats = FilterStats()
    probe_strand_tag_support(args.input, params)  # fail before any write
    with BamReader(args.input) as reader:
        with BamWriter(args.output, filtered_header(reader.header)) as w:
            blobs = (encode_record(rec) for rec in reader)
            w.write_raw_many(filter_consensus_raw(blobs, params, stats=stats))
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_zipper(args) -> int:
    """`fgbio ZipperBams --unmapped UNALIGNED --sort Coordinate` equivalent
    (main.snake.py:106): graft consensus tags from the unaligned BAM onto
    the aligned records, coordinate-sorted, bounded memory."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter
    from bsseqconsensusreads_tpu_torch.pipeline.record_ops import zipper_bams_stream

    with BamReader(args.input) as aligned, BamReader(args.unmapped) as unaligned:
        n = 0
        header = aligned.header.with_sort_order("coordinate")
        with BamWriter(args.output, header) as w:
            for rec in zipper_bams_stream(aligned, unaligned, header):
                w.write(rec)
                n += 1
    print(json.dumps({"records": n}), file=sys.stderr)
    return 0


def cmd_sam_to_fastq(args) -> int:
    """`picard SamToFastq` equivalent (main.snake.py:67,176): paired
    gzipped FASTQs written in step. Records stream through the external
    name sort first, so mates are adjacent even on coordinate-sorted
    input."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.io.fastq import sam_to_fastq
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import external_sort
    from bsseqconsensusreads_tpu_torch.pipeline.record_ops import name_key

    with BamReader(args.input) as reader:
        n1, n2 = sam_to_fastq(
            external_sort(reader, name_key, reader.header), args.fq1, args.fq2,
        )
    print(json.dumps({"r1": n1, "r2": n2}), file=sys.stderr)
    return 0


def cmd_filter_mapped(args) -> int:
    """`samtools view -h -b -F 4` equivalent (main.snake.py:118)."""
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter
    from bsseqconsensusreads_tpu_torch.pipeline.record_ops import filter_mapped

    with BamReader(args.input) as reader:
        n = 0
        with BamWriter(args.output, reader.header) as w:
            for rec in filter_mapped(reader):
                w.write(rec)
                n += 1
    print(json.dumps({"records": n}), file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """The resident consensus engine (serve/): the card's kernels, tables
    and pools stay warm across jobs submitted over unix / TCP addresses
    (`submit`); families from different jobs share device batches and are
    demultiplexed at retire, so each job's output is byte-identical to a
    standalone `molecular --batching sequential` run. SIGTERM/SIGINT
    drain: admitted jobs finish, then the process exits 0."""
    import signal

    from bsseqconsensusreads_tpu_torch.serve.server import ServeEngine, ServeServer

    if not args.socket and not args.address:
        observe.stderr_line("serve: need --socket and/or --address")
        return 2
    _arm_failpoints(args)
    observe.open_ledger(component="serve")
    observe.install_flight_signal()  # SIGUSR1 -> dump the recent events
    engine = ServeEngine(
        params=_params(args),
        mode=args.mode,
        batch_families=args.batch_families,
        max_window=args.max_window,
        grouping=args.grouping,
        indel_policy=args.indel_policy,
        device=args.device,
        transport=args.transport,
        max_active=args.max_active,
        stride=args.stride,
        idle_wait_s=args.idle_flush_ms / 1000.0,
        max_pending=args.max_pending,
    )
    if args.warmup:
        engine.warmup()
    engine.start()
    server = ServeServer(
        engine,
        args.socket or None,
        addresses=args.address or None,
        ready_file=args.ready_file or None,
    )
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: server.request_drain())
    server.serve_forever()
    observe.emit_stage_stats({"serve-cli": engine.scheduler.stats})
    observe.flush_sinks()
    states: dict[str, int] = {}
    for j in engine.queue.jobs():
        states[j.state] = states.get(j.state, 0) + 1
    observe.stderr_line(json.dumps({"jobs": states, **engine.scheduler.counters()}))
    return 0


def cmd_route(args) -> int:
    """The fleet router (serve/router + serve/fleet): N serve replicas of
    this package (spawned on kernel-assigned TCP ports, or attached with
    --replica-address) behind the same serve protocol one replica speaks.
    Placement is input-fingerprint affinity first, queue depth otherwise;
    a replica dying mid-job has its unfinished jobs requeued to survivors
    (byte-identical: jobs are idempotent) and is respawned, loading the
    shared kernel builds (BSSEQ_TPU_COMPILE_CACHE_DIR). SIGTERM/SIGINT
    drain the whole fleet."""
    import os
    import signal

    from bsseqconsensusreads_tpu_torch.serve.fleet import ReplicaSet
    from bsseqconsensusreads_tpu_torch.serve.router import Router, RouterServer

    if not args.socket and not args.address:
        observe.stderr_line("route: need --socket and/or --address")
        return 2
    _arm_failpoints(args)
    observe.open_ledger(component="route")
    observe.install_flight_signal()
    serve_args = [
        "--batch-families", str(args.batch_families),
        "--max-active", str(args.max_active),
        "--stride", str(args.stride),
        "--idle-flush-ms", str(args.idle_flush_ms),
        "--max-pending", str(args.max_pending),
        "--min-reads", str(args.min_reads),
        "--device", args.device,
    ]
    if args.warmup:
        serve_args.append("--warmup")
    fail_once: dict[str, str] = {}
    for term in args.replica_failpoints:
        rid, sep, schedule = term.partition(":")
        if not sep or not rid or not schedule:
            observe.stderr_line(f"route: bad --replica-failpoints {term!r} (want rid:schedule)")
            return 2
        fail_once[rid] = schedule
    fleet = ReplicaSet(
        n=args.replicas,
        host=args.replica_host,
        rundir=args.rundir or None,
        serve_args=serve_args,
        attach_addresses=args.replica_address or None,
        compile_cache_dir=os.environ.get("BSSEQ_TPU_COMPILE_CACHE_DIR") or None,
        fail_once=fail_once,
    )
    router = Router(fleet, affinity=not args.no_affinity, respawn=not args.no_respawn)
    try:
        router.launch()
    except Exception as exc:  # a dead fleet at boot is an exit, not a hang
        observe.stderr_line(f"route: fleet failed to start: {exc}")
        fleet.stop(drain_timeout=5.0)
        return 2
    server = RouterServer(
        router,
        args.socket or None,
        addresses=args.address or None,
        ready_file=args.ready_file or None,
    )
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: server.request_drain())
    server.serve_forever()
    observe.flush_sinks()
    observe.stderr_line(json.dumps(router.counters))
    return 0


def cmd_submit(args) -> int:
    """Client half of the serve protocol: submit one BAM job to a running
    serve engine or router; --wait blocks until the job retires and exits
    non-zero if it failed. An `overloaded` refusal is retried after its
    retry_after_s hint until --timeout."""
    import time

    from bsseqconsensusreads_tpu_torch.serve.server import request

    spec = {
        "input": args.input,
        "output": args.output,
        "policy": args.policy or None,
        "grouping": args.grouping or None,
        "ingest": args.ingest,
        "chemistry": args.chemistry or None,
    }
    try:
        deadline = time.monotonic() + args.timeout
        while True:
            resp = request(args.socket, {"op": "submit", "spec": spec})
            if resp.get("ok") or resp.get("guard") != "overloaded":
                break
            delay = min(2.0, max(0.05, float(resp.get("retry_after_s") or 0.1)))
            if time.monotonic() + delay >= deadline:
                break
            time.sleep(delay)
        if not resp.get("ok"):
            observe.stderr_line(f"submit refused: {resp.get('error')}")
            return 3
        job = resp["job"]
        if args.wait:
            resp = request(
                args.socket,
                {"op": "wait", "job": job["id"], "timeout": args.timeout},
                timeout=args.timeout + 30.0,
            )
            job = resp.get("job", job)
    except OSError as exc:
        observe.stderr_line(f"submit: cannot reach {args.socket}: {exc}")
        return 2
    print(json.dumps(job))
    if args.wait:
        return 0 if job.get("state") == "done" else 1
    return 0


def cmd_serve_ctl(args) -> int:
    """Operator half of the serve protocol: ping / stats / status / drain /
    preempt against a running engine or router."""
    import time

    from bsseqconsensusreads_tpu_torch.serve.server import request

    payload: dict = {"op": args.op}
    if args.op == "status":
        if not args.job:
            observe.stderr_line("serve-ctl status needs --job")
            return 2
        payload["job"] = args.job
    if args.op == "drain":
        payload["timeout"] = args.timeout
        payload["sent_s"] = time.time()
    if args.op == "preempt":
        if not args.replica:
            observe.stderr_line("serve-ctl preempt needs --replica")
            return 2
        payload["replica"] = args.replica
    try:
        resp = request(args.socket, payload, timeout=args.timeout + 30.0)
    except OSError as exc:
        observe.stderr_line(f"serve-ctl: cannot reach {args.socket}: {exc}")
        return 2
    print(json.dumps(resp))
    return 0 if resp.get("ok") else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="bsseqconsensusreads_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run the full pipeline for one sample")
    p.add_argument("--config", default="", help="YAML config (reference-compatible; needs PyYAML)")
    p.add_argument("--bam", required=True,
                   help="GroupReadsByUmi output BAM, or a raw aligned BAM (RX, no MI: "
                   "grouped first under group_umis 'auto')")
    p.add_argument("--outdir", default="output")
    p.add_argument("--aligner", choices=("self", "bwameth", "none"), default="")
    p.add_argument("--reference", default="", help="genome FASTA (overrides config)")
    p.add_argument("--force", action="store_true")
    p.add_argument(
        "--chemistry", choices=("bisulfite", "emseq", "none"), default="",
        help="library chemistry (overrides config; see `duplex --help`)",
    )
    p.add_argument(
        "--methyl", choices=("off", "bedmethyl", "cx", "both"), default="",
        help="methylation extraction in the duplex stage (overrides config; "
        "see `duplex --help`)",
    )
    p.add_argument("--methyl-out", default="", help="base path for the methylation outputs")
    p.add_argument(
        "--single-strand", action="store_true",
        help="molecular emit without duplex pairing: stop after the "
        "molecular consensus stage",
    )
    p.add_argument(
        "--sort-engine", choices=("auto", "native", "python", "bucket"), default="",
        help="raw coordinate-sort engine for stage outputs (overrides "
        "config; 'bucket' routes records into coordinate buckets and "
        "concatenates them, no merge tail; same bytes)",
    )
    p.add_argument("--sort-buckets", type=int, default=0,
                   help="bucket count for --sort-engine bucket")
    p.add_argument(
        "--stream-interstage", action="store_true",
        help="fuse the molecular and duplex stages into one rule that "
        "streams the sorted molecular records straight into the duplex "
        "stage (needs --sort-engine bucket; otherwise falls back loudly "
        "to the two-pass path)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="",
        help="where the consensus stages run (overrides the config's "
        "backend; default: the card)",
    )
    _add_failpoints(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("molecular", help="molecular consensus stage only")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--mode", choices=("unaligned", "self"), default="unaligned")
    p.add_argument(
        "--batching",
        choices=("bucketed", "sequential"),
        default="bucketed",
        help="molecular chunk composition: depth-homogeneous buckets "
        "(bounded pad waste) vs input order",
    )
    p.add_argument(
        "--indel-policy", choices=("drop", "align"), default="drop",
        help="indel reads: 'drop' = reference parity "
        "(tools/1.convert_AG_to_CT.py:79-80), 'align' = recover them via "
        "the banded intra-family aligner (above-parity)",
    )
    _add_params(p, min_reads_default=1)
    p.set_defaults(fn=cmd_molecular)

    p = sub.add_parser("duplex", help="fused duplex stage only")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--reference", required=True, help="genome FASTA")
    p.add_argument("--mode", choices=("unaligned", "self"), default="unaligned")
    p.add_argument(
        "--pos0", choices=("skip", "shift"), default="skip",
        help="conversion prepend for reads at reference position 0: "
        "'skip' (default, documented deviation) or 'shift' = exact "
        "reference parity incl. the one-base register shift "
        "(tools/1.convert_AG_to_CT.py:87-92)",
    )
    p.add_argument(
        "--chemistry", choices=("bisulfite", "emseq", "none"),
        default="bisulfite",
        help="library chemistry: bisulfite/emseq run the conversion-aware "
        "engine (identical C->T readout; emseq is provenance), 'none' "
        "declares an unconverted plain duplex library — the convert "
        "transform is disabled, same engine otherwise",
    )
    p.add_argument(
        "--methyl", choices=("off", "bedmethyl", "cx", "both"), default="off",
        help="methylation extraction: a per-column classify-and-count "
        "epilogue on the duplex batch, written as bedMethyl and/or a CX "
        "cytosine report next to the output",
    )
    p.add_argument(
        "--methyl-out", default="",
        help="base path for the methylation outputs (default: the output BAM's path)",
    )
    p.add_argument(
        "--methyl-engine", choices=("auto", "device", "host"), default="auto",
        help="where the epilogue runs: on the vote's device, inside the "
        "dispatch (auto = device), or the numpy twin on the host",
    )
    p.add_argument(
        "--passthrough", action="store_true",
        help="reference-parity emission of off-vocabulary records (the "
        "convert-stage treatment of tools/1.convert_AG_to_CT.py applied "
        "to leftovers; default drops them, counted in stats)",
    )
    _add_params(p, min_reads_default=0)
    p.set_defaults(fn=cmd_duplex)

    p = sub.add_parser("sort", help="SortBam equivalent (external-merge, bounded memory)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--order", choices=("coordinate", "name", "template-coordinate"),
        default="coordinate",
        help="template-coordinate = fgbio SortBam -s TemplateCoordinate "
        "(main.snake.py:152); name = samtools sort -n",
    )
    p.set_defaults(fn=cmd_sort)

    p = sub.add_parser("group", help="GroupReadsByUmi equivalent (RX -> MI, duplex /A|/B)")
    p.add_argument("-i", "--input", required=True, help="aligned BAM with RX tags")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "-s", "--strategy", choices=("identity", "edit", "adjacency", "paired"),
        default="paired",
        help="paired = duplex: strand-canonicalized UMI pairs, MI gets "
        "/A|/B suffixes (the reference's input contract, README.md:51-55)",
    )
    p.add_argument("-e", "--edits", type=int, default=1,
                   help="max UMI mismatches merged within a position group")
    p.add_argument("-t", "--raw-tag", default="RX")
    p.add_argument("-m", "--min-map-q", type=int, default=1)
    p.set_defaults(fn=cmd_group)

    p = sub.add_parser(
        "metrics", help="CollectDuplexSeqMetrics equivalent (family sizes, duplex yield)"
    )
    p.add_argument("-i", "--input", required=True, help="MI-grouped BAM")
    p.add_argument("--compact", action="store_true", help="one-line JSON")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "filter-consensus",
        help="FilterConsensusReads equivalent (depth/error filters + masking)",
    )
    p.add_argument("-i", "--input", required=True, help="consensus BAM")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "-M", "--min-reads", type=int, nargs="+", default=[1],
        help="M [A B]: total / larger-strand / smaller-strand depth floors",
    )
    p.add_argument("-E", "--max-read-error-rate", type=float, default=0.025)
    p.add_argument("-e", "--max-base-error-rate", type=float, default=0.1)
    p.add_argument("-N", "--min-base-quality", type=int, default=1)
    p.add_argument("-n", "--max-no-call-fraction", type=float, default=0.1)
    p.add_argument("-q", "--min-mean-base-quality", type=float, default=None)
    p.add_argument(
        "-s", "--require-single-strand-agreement", action="store_true",
        help="mask duplex bases where the two single-strand calls "
        "disagree (consumes the ac/bc tags this framework's duplex "
        "output carries)",
    )
    p.set_defaults(fn=cmd_filter_consensus)

    p = sub.add_parser("zipper", help="ZipperBams equivalent (tag graft + coordinate sort)")
    p.add_argument("-i", "--input", required=True, help="aligned BAM")
    p.add_argument("--unmapped", required=True, help="unaligned BAM with tags")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_zipper)

    p = sub.add_parser("sam-to-fastq", help="SamToFastq equivalent")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--fq1", required=True)
    p.add_argument("--fq2", required=True)
    p.set_defaults(fn=cmd_sam_to_fastq)

    p = sub.add_parser("filter-mapped", help="samtools view -F 4 equivalent")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_filter_mapped)

    p = sub.add_parser(
        "serve",
        help="resident consensus engine: warm kernels across jobs, cross-job "
        "continuous batching, unix-socket/TCP submit protocol",
    )
    p.add_argument("--socket", default="",
                   help="unix socket path (optional when --address is given)")
    p.add_argument(
        "--address", action="append", default=[],
        help="additional listen address (repeatable): unix:<path> or tcp:host:port "
        "(port 0 = kernel-assigned; TLS via BSSEQ_TPU_SERVE_TLS_CERT/KEY)",
    )
    p.add_argument("--ready-file", default="",
                   help="write resolved bound addresses here once listening "
                   "(the fleet supervisor's ready protocol)")
    p.add_argument("--mode", choices=("unaligned", "self"), default="unaligned")
    p.add_argument("--indel-policy", choices=("drop", "align"), default="drop")
    p.add_argument("--max-active", type=int, default=4,
                   help="jobs ingesting concurrently (each holds one reader thread)")
    p.add_argument("--stride", type=int, default=8,
                   help="families pulled per job per round-robin pass")
    p.add_argument("--idle-flush-ms", type=float, default=20.0,
                   help="idle wait before a partial chunk is flushed to the device "
                   "(continuous batching: latency under low load)")
    p.add_argument("--max-pending", type=int, default=64,
                   help="bounded admission queue depth (submits beyond it block)")
    p.add_argument("--warmup", action="store_true",
                   help="build and launch the kernels on a synthetic family before "
                   "accepting jobs")
    _add_params(p, min_reads_default=1)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "route",
        help="fleet router: N serve replicas behind affinity placement, "
        "drain/handoff, shared kernel build cache",
    )
    p.add_argument("--socket", default="", help="router unix socket path")
    p.add_argument("--address", action="append", default=[],
                   help="router listen address (repeatable): unix:<path> or tcp:host:port")
    p.add_argument("--ready-file", default="",
                   help="write the router's bound addresses here once listening")
    p.add_argument("--replicas", type=int, default=2, help="serve replicas to spawn on this host")
    p.add_argument("--replica-host", default="127.0.0.1")
    p.add_argument("--replica-address", action="append", default=[],
                   help="attach to an already-running replica at tcp:host:port instead "
                   "of spawning (repeatable)")
    p.add_argument("--replica-failpoints", action="append", default=[],
                   help="rid:schedule — arm BSSEQ_TPU_FAILPOINTS in ONE replica's first "
                   "life (r0:fleet_replica_exit=exit:9@batch=1)")
    p.add_argument("--no-respawn", action="store_true",
                   help="do not restart dead replicas (requeue-only handoff)")
    p.add_argument("--no-affinity", action="store_true", help="place purely by queue depth")
    p.add_argument("--rundir", default="",
                   help="supervision scratch dir (ready files; default under TMPDIR)")
    p.add_argument("--batch-families", type=int, default=64)
    p.add_argument("--max-active", type=int, default=4)
    p.add_argument("--stride", type=int, default=8)
    p.add_argument("--idle-flush-ms", type=float, default=20.0)
    p.add_argument("--max-pending", type=int, default=64)
    p.add_argument("--min-reads", type=int, default=1)
    p.add_argument("--warmup", action="store_true",
                   help="each replica builds and launches the kernels before accepting jobs")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the replicas' vote runs (default: the card)")
    _add_failpoints(p)
    p.set_defaults(fn=cmd_route)

    p = sub.add_parser(
        "submit", help="submit one BAM job to a running serve engine or router "
        "(--socket accepts unix paths and tcp:host:port)")
    p.add_argument("--socket", required=True)
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--policy", choices=("strict", "quarantine", "lenient", "off"), default="",
                   help="input guard policy for THIS job's ingest (default: the server's "
                   "BSSEQ_TPU_INPUT_POLICY)")
    p.add_argument("--grouping", choices=("gather", "adjacent", "coordinate"), default="",
                   help="MI-group streaming strategy (default: the server's)")
    p.add_argument("--ingest", choices=("auto", "native", "python"), default="python")
    p.add_argument("--chemistry", choices=("bisulfite", "emseq", "none"), default="",
                   help="THIS job's library chemistry (admission validation and "
                   "provenance: the molecular stage is chemistry-invariant)")
    p.add_argument("--wait", action="store_true", help="block until done")
    p.add_argument("--timeout", type=float, default=600.0)
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("serve-ctl",
                       help="ping/stats/status/drain/preempt a running serve engine or router")
    p.add_argument("op", choices=("ping", "stats", "status", "drain", "preempt"))
    p.add_argument("--socket", required=True)
    p.add_argument("--job", default="")
    p.add_argument("--replica", default="",
                   help="replica id for `preempt`: drain one router replica — migrate "
                   "its jobs to survivors, then reap it")
    p.add_argument("--timeout", type=float, default=600.0)
    p.set_defaults(fn=cmd_serve_ctl)

    args = ap.parse_args(argv)
    from bsseqconsensusreads_tpu_torch.faults.guard import GuardError
    from bsseqconsensusreads_tpu_torch.utils import compilecache

    compilecache.maybe_enable()  # BSSEQ_TPU_COMPILE_CACHE_DIR, if set
    try:
        return args.fn(args)
    except GuardError as e:
        # a typed input failure (strict policy, a refused checkpoint
        # resume): its message already carries record #N / block @voffset,
        # and a traceback would read as a crash; the flight ring is dumped
        # to the ledger first (nothing without a sink)
        observe.flight_dump(f"guard_error:{e.reason}")
        print(f"bsseqconsensusreads_tpu_torch: input error [{e.reason}]: {e}",
              file=sys.stderr, flush=True)
        return 3
