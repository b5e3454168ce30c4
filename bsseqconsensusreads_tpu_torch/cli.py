"""Command-line interface: `python -m bsseqconsensusreads_tpu_torch <cmd>`.

The molecular and duplex subcommands of the JAX package's CLI, with the
same flag names, on the card:

* molecular — the molecular consensus stage (fgbio
              CallMolecularConsensusReads equivalent, main.snake.py:54)
* duplex    — the fused duplex stage (the reference's convert -> extend ->
              sort -> callduplex chain, main.snake.py:121-164)

--device cuda|cpu picks where the vote runs (default cuda; with no card
the command fails rather than falling back). --ingest and --emit pick
the host engines: the port's C++ libraries (built from csrc/host at
first use; a failed build fails the command) or the Python twins, with
byte-identical output. Each command writes its StageStats as one JSON
line on stderr.
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
        )
        write_batch_stream(batches, args.output, reader.header, args.mode,
                           metrics=stats.metrics)
    print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="bsseqconsensusreads_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
    _add_params(p, min_reads_default=0)
    p.set_defaults(fn=cmd_duplex)

    args = ap.parse_args(argv)
    return args.fn(args)
