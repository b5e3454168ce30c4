"""The entry the window drives: one pass of the program's `run` chain
with aligner `self` — the molecular stage over the pass's grouped BAM,
its coordinate-sorted intermediate, then the duplex stage over that —
through the program's own entry points, minus process start and genome
load (the RefStore is built once in set-up).

The harness times the gaps between the batches each stage yields
around its own loop; everything else it reads is the program's
StageStats."""

from __future__ import annotations

import dataclasses
import os
import time


@dataclasses.dataclass
class PassResult:
    stats: dict  # stage -> the program's StageStats
    gaps_s: list  # seconds between consecutive batches, both stages
    mid: str
    out: str
    stage_spans: list  # (stage, t_start, t_end) on time.monotonic


def _timed_batches(batches, gaps: list):
    """Yield the stage's batches, recording the time from one batch's
    arrival to the next's (the first from the stage's start)."""
    last = time.monotonic()
    for b in batches:
        now = time.monotonic()
        gaps.append(now - last)
        last = now
        yield b


class Chain:
    """The program under test, bound to one configuration and device."""

    def __init__(self, cfg: dict, genome, device: str):
        from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore

        self.cfg = cfg
        self.device = device
        self.genome = genome
        self.store = RefStore(genome.names, codes=genome.codes, lengths=genome.lengths)
        if device != "cpu":
            self.store.device_codes(device)  # the one upload, in set-up

    def run_pass(self, inp: str, workdir: str, tag: str) -> PassResult:
        from bsseqconsensusreads_tpu_torch.io.bam import BamReader
        from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
        from bsseqconsensusreads_tpu_torch.pipeline import calling, stages
        from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream

        cfg = self.cfg
        mid = os.path.join(workdir, f"{tag}.molecular.bam")
        out = os.path.join(workdir, f"{tag}.duplex.bam")
        gaps: list = []
        spans = []
        mol = calling.StageStats(stage="molecular")
        t0 = time.monotonic()
        with BamReader(inp) as reader:
            batches = calling.call_molecular_batches(
                stages.molecular_ingest_stream(inp, reader, mol, ingest_choice="native"),
                ConsensusParams(min_reads=1), mode="self",
                batch_families=int(cfg["batch_families"]), grouping="coordinate",
                stats=mol, device=self.device, emit="native", transport="auto", mesh="auto",
            )
            write_batch_stream(_timed_batches(batches, gaps), mid, reader.header, "self",
                               workdir=workdir, sort_engine="native", metrics=mol.metrics)
        t1 = time.monotonic()
        spans.append(("molecular", t0, t1))
        dup = calling.StageStats(stage="duplex")
        with BamReader(mid) as reader:
            names = [n for n, _ in reader.header.references]
            batches = calling.call_duplex_batches(
                stages.duplex_ingest_stream(mid, reader, dup, ingest_choice="native"),
                self.genome.fetch_str, names, ConsensusParams(min_reads=0), mode="self",
                batch_families=int(cfg["batch_families"]), grouping="coordinate",
                stats=dup, device=self.device, emit="native", transport="auto",
                chemistry=cfg["chemistry"], refstore=self.store, mesh="auto",
            )
            write_batch_stream(_timed_batches(batches, gaps), out, reader.header, "self",
                               workdir=workdir, sort_engine="native", metrics=dup.metrics)
        spans.append(("duplex", t1, time.monotonic()))
        return PassResult({"molecular": mol, "duplex": dup}, gaps, mid, out, spans)


def vote_launch_counts() -> dict:
    """The program's per-kernel launch counters and seg_vote's calls by
    route, as read after a run (printed on a traced run's earlier lines)."""
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    return {**cuda_vote.LAUNCHES, **{f"route:{k}": v for k, v in cuda_vote.SEG_VOTE_ROUTES.items()}}


def reset_launch_counts() -> None:
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    for k in cuda_vote.LAUNCHES:
        cuda_vote.LAUNCHES[k] = 0
    cuda_vote.SEG_VOTE_SHAPES.clear()
    cuda_vote.SEG_VOTE_ROUTES.clear()
