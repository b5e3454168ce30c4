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
"""

from __future__ import annotations

import argparse
import json
import sys

from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams


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
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.pipeline.calling import (
        StageStats,
        call_molecular_batches,
    )
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
    from bsseqconsensusreads_tpu_torch.pipeline.stages import molecular_ingest_stream

    stats = StageStats(stage="molecular")
    with BamReader(args.input) as reader:
        batches = call_molecular_batches(
            molecular_ingest_stream(
                args.input, reader, stats,
                ingest_choice=args.ingest, grouping=args.grouping,
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
        )
        write_batch_stream(batches, args.output, reader.header, args.mode,
                           metrics=stats.metrics)
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_duplex(args) -> int:
    from bsseqconsensusreads_tpu_torch.io.bam import BamReader
    from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
    from bsseqconsensusreads_tpu_torch.pipeline.calling import (
        StageStats,
        call_duplex_batches,
    )
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
    from bsseqconsensusreads_tpu_torch.pipeline.stages import duplex_ingest_stream

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
    with FastaFile(args.reference) as fasta, BamReader(args.input) as reader:
        names = [n for n, _ in reader.header.references]
        batches = call_duplex_batches(
            duplex_ingest_stream(
                args.input, reader, stats,
                ingest_choice=args.ingest, grouping=args.grouping,
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
        )
        write_batch_stream(batches, args.output, reader.header, args.mode,
                           metrics=stats.metrics)
    if methyl_acc is not None:
        report = methyl_acc.finalize()
        print(json.dumps({"methyl": report}), file=sys.stderr)
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def cmd_run(args) -> int:
    import os

    from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline
    from bsseqconsensusreads_tpu_torch.utils.observe import stderr_line

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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="bsseqconsensusreads_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run the full pipeline for one sample")
    p.add_argument("--config", default="", help="YAML config (reference-compatible; needs PyYAML)")
    p.add_argument("--bam", required=True, help="GroupReadsByUmi output BAM")
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
        "config; 'bucket' is not ported yet and is refused)",
    )
    p.add_argument("--sort-buckets", type=int, default=0,
                   help="bucket count for --sort-engine bucket")
    p.add_argument(
        "--stream-interstage", action="store_true",
        help="stream molecular records straight into the duplex stage "
        "(needs the bucket engine: falls back loudly to the two-pass path)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="",
        help="where the consensus stages run (overrides the config's "
        "backend; default: the card)",
    )
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
    _add_params(p, min_reads_default=0)
    p.set_defaults(fn=cmd_duplex)

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

    args = ap.parse_args(argv)
    return args.fn(args)
