"""The duplex-consensus pipeline as a workflow over file checkpoints.

The port of the JAX package's pipeline/stages.py: the stage ingest
(ingest_records and the two stage streams), PipelineBuilder and
run_pipeline. The rule chain is the reference's (main.snake.py:40-189)
with the consensus stages on the card, and the intermediate file names
are the reference's suffix chain. Three alignment modes (cfg.aligner):

* 'self'    — molecular consensus (mode 'self': window-space consensus
              keeps coordinates) written as the intermediate
              `<sample>_consensus_unfiltered_aunamerged_aligned.bam`, then
              the fused duplex stage into the coordinate-sorted target
              `<sample>_consensus_duplex_unfiltered.bam`; 2 rules.
* 'bwameth' — parity path: every reference rule has an equivalent here,
              shelling out to bwameth exactly as the reference does.
* 'none'    — stop after the molecular consensus FASTQs.

single_strand stops after the molecular stage.

Ingest engines are resolved by what the stage can take, never by what
happens to be built: 'auto' is the native columnar decoder with C-side MI
grouping and the C encode scan wherever the stage can take it, and the
Python BamReader only where it cannot (grouping 'gather', which would
pin every columnar batch for the whole file). 'native' where the stage
cannot take it raises, and a native library that does not build raises
io._nativelib.NativeLibraryError — nothing falls back to Python.

methyl 'bedmethyl' | 'cx' | 'both' runs the methylation epilogue in the
duplex stage and writes `<target>.bedmethyl` / `<target>.CX_report.txt`
(or at cfg.methyl_out as the base path) after the stage output; with
checkpoints the tally spills at the checkpoint's watermarks and resumes
with it. It refuses chemistry 'none' and single_strand, as the JAX
package does.

Config keys the port does not honour yet raise a WorkflowError in
PipelineBuilder.build(), before any stage runs, naming the ROADMAP item
(queue 1) that brings them: group_umis that would prepend UMI grouping,
filter, duplex_passthrough and sort_engine 'bucket' (item 8),
indel_policy 'align' (item 7).
stream_interstage takes the JAX package's loud fallback to the two-pass
path: the fused rule needs the bucket engine.

Left for later slices: the run ledger (observe.open_ledger,
emit_stage_stats, BSSEQ_TPU_STATS) and the traces (item 9), the input
guard's policies (item 5). The JAX package's compilecache has no
counterpart: the port compiles its kernels once per build directory.
"""

from __future__ import annotations

import os
import shlex
import subprocess

from bsseqconsensusreads_tpu_torch.config import FrameworkConfig, check_backend
from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
from bsseqconsensusreads_tpu_torch.pipeline.calling import (
    StageStats,
    call_duplex_batches,
    call_molecular_batches,
    check_route,
)
from bsseqconsensusreads_tpu_torch.pipeline.checkpoint import BatchCheckpoint
from bsseqconsensusreads_tpu_torch.pipeline.workflow import Workflow, WorkflowError
from bsseqconsensusreads_tpu_torch.utils import observe
from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

INGEST_CHOICES = ("auto", "native", "python")


def ingest_records(path: str, reader, stats: StageStats,
                   ingest_choice: str = "auto",
                   grouping: str = "coordinate",
                   strip_suffix: bool = False,
                   scan_policy: str | None = None,
                   threads: int | None = None):
    """The record stream for one consensus stage: a
    pipeline.ingest.GroupedColumnarStream over `path` (records decoded and
    grouped in C, with the stage's encode scan) or `reader`, the open
    BamReader on the same file. The chosen engine lands in stats.metrics
    as the 'ingest_native' / 'group_native' counters."""
    if ingest_choice not in INGEST_CHOICES:
        raise ValueError(f"unknown ingest {ingest_choice!r}; use auto|native|python")
    native_ok = grouping in ("coordinate", "adjacent")
    if ingest_choice == "native" and not native_ok:
        raise ValueError(
            f"ingest 'native' is incompatible with grouping {grouping!r} "
            "(it would pin every columnar batch for the whole file)"
        )
    use_native = native_ok and ingest_choice != "python"
    stats.metrics.count("ingest_native", int(use_native))
    stats.metrics.count("group_native", int(use_native))
    if not use_native:
        return reader
    from bsseqconsensusreads_tpu_torch.io import native
    from bsseqconsensusreads_tpu_torch.pipeline import ingest

    native.lib()  # build or load now: a broken library fails the stage here
    return ingest.GroupedColumnarStream(
        path, strip_suffix=strip_suffix, scan_policy=scan_policy,
        grouping=grouping, threads=threads,
    )


def molecular_ingest_stream(path: str, reader, stats: StageStats,
                            ingest_choice: str = "auto",
                            grouping: str = "coordinate",
                            threads: int | None = None):
    """The molecular stage's ingest: full-MI grouping, the C encode digest
    under the stage's indel policy ('drop')."""
    return ingest_records(path, reader, stats, ingest_choice=ingest_choice,
                          grouping=grouping, scan_policy="drop", threads=threads)


def duplex_ingest_stream(path: str, reader, stats: StageStats,
                         ingest_choice: str = "auto",
                         grouping: str = "coordinate",
                         threads: int | None = None):
    """The duplex stage's ingest: strand-suffix-stripped grouping (base
    MI) and the duplex-shaped C scan. The duplex stage reads only MI, RX
    and the cd/ce/cB consensus arrays off its records, all of which the
    columnar views carry."""
    return ingest_records(path, reader, stats, ingest_choice=ingest_choice,
                          grouping=grouping, strip_suffix=True,
                          scan_policy="duplex", threads=threads)


def sample_name(bam_path: str) -> str:
    """The reference's sample derivation (main.snake.py:38)."""
    return os.path.basename(bam_path).replace(".bam", "")


def stage_fingerprint(cfg: FrameworkConfig, stage: str, device_type: str) -> dict:
    """What a stage's checkpoint shards were computed from: a manifest
    whose fingerprint differs is discarded, never resumed. The JAX
    package's key 'vote_kernel' becomes the resolved device type — card
    and CPU may differ by one qual (PERF.md §2), so shards computed on one
    are never spliced into a run on the other."""
    fingerprint = {
        "batch_families": cfg.batch_families,
        "max_window": cfg.max_window,
        "grouping": cfg.grouping,
        # chunk composition differs between batching modes: shards
        # resumed across a mode change would splice wrong families
        "batching": cfg.batching,
        "indel_policy": cfg.indel_policy,
        "params": repr(getattr(cfg, stage)),
        "device": device_type,
    }
    if stage == "duplex":
        fingerprint["passthrough"] = cfg.duplex_passthrough
        fingerprint["chemistry"] = cfg.chemistry
        fingerprint["methyl"] = cfg.methyl
    return fingerprint


def methyl_paths(choice: str, base: str) -> tuple[str | None, str | None]:
    """(bedMethyl path, CX report path) of a methyl choice at `base`."""
    return (
        base + ".bedmethyl" if choice in ("bedmethyl", "both") else None,
        base + ".CX_report.txt" if choice in ("cx", "both") else None,
    )


def _not_ported(key: str, item: int, what: str) -> WorkflowError:
    return WorkflowError(
        f"config {key} is not ported yet (ROADMAP queue 1, item {item}: {what})"
    )


class PipelineBuilder:
    """Assembles the Workflow for one sample and collects stage stats.

    device: where the consensus stages vote — None resolves cfg.backend
    at the first stage ('cuda' raises without a card)."""

    def __init__(self, cfg: FrameworkConfig, bam_path: str, outdir: str = "output",
                 device=None):
        self.cfg = cfg
        self.bam_path = bam_path
        self.sample = sample_name(bam_path)
        self.outdir = outdir
        self.stats: dict[str, StageStats] = {}
        self.final_output: str | None = None  # set by build()
        self.molecular_grouping = cfg.grouping
        self._device = device

    @property
    def device(self):
        if self._device is None:
            self._device = resolve_device(check_backend(self.cfg.backend))
        return self._device

    def out(self, suffix: str) -> str:
        return os.path.join(self.outdir, f"{self.sample}{suffix}")

    def _out_level(self, path: str) -> int:
        """Deflate level for a stage output: intermediates — durable
        rule-boundary checkpoints re-read exactly once — write at
        cfg.intermediate_level; the workflow's final target at level 6."""
        return 6 if path == self.final_output else self.cfg.intermediate_level

    # ---- stage bodies -------------------------------------------------

    def _write_stage_output(self, batches, out_path: str, header, mode: str,
                            ck: BatchCheckpoint | None, stats: StageStats) -> None:
        """Write a consensus batch stream: straight through
        (extsort.write_batch_stream, which times its own sort, spill, merge
        and deflate as 'sort_write'), or via durable per-batch shards when
        intra-stage checkpointing is on (the stream is already offset by
        ck.batches_done) — then the finalize, with the 'self' mode's
        coordinate sort over the shards' encoded blobs, is timed whole as
        'sort_write'."""
        from bsseqconsensusreads_tpu_torch.pipeline.extsort import (
            external_sort_raw,
            external_sort_raw_to_writer,
            resolve_sort_engine,
            write_batch_stream,
        )

        sort_kw = dict(workdir=self.cfg.tmp or None,
                       buffer_records=self.cfg.sort_buffer_records)
        if ck is None:
            write_batch_stream(
                batches, out_path, header, mode, level=self._out_level(out_path),
                sort_engine=self.cfg.sort_engine, metrics=stats.metrics, **sort_kw,
            )
            return
        ck.write_batches(batches)
        with stats.metrics.timed("sort_write"):
            if mode != "self":
                ck.finalize(None)  # raw shard concatenation
            elif resolve_sort_engine(self.cfg.sort_engine) == "native":
                ck.finalize(writer_fn=lambda w: external_sort_raw_to_writer(
                    ck.iter_raw_records(), w, header, engine="native", **sort_kw,
                ))
            else:
                ck.finalize(external_sort_raw(ck.iter_raw_records(), header, **sort_kw))

    def _checkpointed(self, stage: str, rule, header) -> BatchCheckpoint | None:
        """Arm intra-stage checkpointing for one stage target, fingerprinted
        so shards from a different config or device are discarded, and
        shards from a different input refuse to resume."""
        if self.cfg.checkpoint_every <= 0:
            return None
        src = rule.inputs[0]
        st = os.stat(src)
        input_fingerprint = {
            "input": os.path.abspath(src),
            "size": st.st_size,
            "mtime": st.st_mtime,
        }
        return BatchCheckpoint(
            rule.outputs[0], header, every=self.cfg.checkpoint_every,
            fingerprint=stage_fingerprint(self.cfg, stage, self.device.type),
            input_fingerprint=input_fingerprint,
            level=self._out_level(rule.outputs[0]),
        )

    def _pg(self, header: BamHeader, stage: str) -> BamHeader:
        """@PG provenance line for one stage output, naming the port."""
        from bsseqconsensusreads_tpu_torch import __version__

        return header.with_pg(
            "bsseqconsensusreads_tpu_torch", __version__,
            f"{stage} sample={self.sample}",
        )

    def run_molecular(self, rule, mode: str) -> None:
        cfg = self.cfg
        stats = self.stats.setdefault("molecular", StageStats(stage="molecular"))
        src = rule.inputs[0]
        with BamReader(src) as reader:
            header = self._pg(reader.header, "molecular")
            ck = self._checkpointed("molecular", rule, header)
            batches = call_molecular_batches(
                molecular_ingest_stream(src, reader, stats, ingest_choice=cfg.ingest,
                                        grouping=self.molecular_grouping),
                params=cfg.molecular,
                mode=mode,
                batch_families=cfg.batch_families,
                max_window=cfg.max_window,
                grouping=self.molecular_grouping,
                stats=stats,
                batching=cfg.batching,
                device=self.device,
                emit=cfg.emit,
                skip_batches=ck.batches_done if ck else 0,
                indel_policy=cfg.indel_policy,
                transport=cfg.transport,
                base_counts=cfg.base_count_tags,
            )
            self._write_stage_output(batches, rule.outputs[0], header, mode, ck, stats)

    def _methyl_accumulator(self, rule, stats: StageStats):
        """The tally sink of the duplex stage's methyl epilogue
        (methyl.tally): outputs next to the duplex target (or at
        cfg.methyl_out as the base path), on a RefStore of the run's
        genome (its read timed as 'genome_load.read') — the store the wire
        then gathers from too, so the device windows and the tallies'
        global offsets come from one coordinate system. The merge engine
        follows cfg.emit."""
        from bsseqconsensusreads_tpu_torch.methyl.tally import MethylAccumulator
        from bsseqconsensusreads_tpu_torch.ops.refstore import RefStore

        with stats.metrics.timed("genome_load"), stats.metrics.timed("genome_load.read"):
            store = RefStore.from_fasta(self.cfg.genome_fasta)
        return MethylAccumulator(
            store, *methyl_paths(self.cfg.methyl, self.cfg.methyl_out or rule.outputs[0]),
            metrics=stats.metrics, engine=self.cfg.emit,
        )

    def run_duplex(self, rule, mode: str) -> None:
        cfg = self.cfg
        stats = self.stats.setdefault("duplex", StageStats(stage="duplex"))
        src = rule.inputs[0]
        with FastaFile(cfg.genome_fasta) as fasta, BamReader(src) as reader:
            names = [n for n, _ in reader.header.references]
            header = self._pg(reader.header, "duplex")
            if mode == "self":  # output leaves coordinate-sorted
                header = header.with_sort_order("coordinate")
            ck = self._checkpointed("duplex", rule, header)
            methyl_acc = None
            # the FASTA path: loaded into a device-resident genome only
            # when the wire transport engages (call_duplex_batches decides)
            # — or the methyl accumulator's store when extraction is on
            store = cfg.genome_fasta
            if cfg.methyl != "off":
                methyl_acc = self._methyl_accumulator(rule, stats)
                store = methyl_acc.refstore
                if ck is not None:
                    # spill at the checkpoint's committed watermarks, and
                    # restore the run chain on resume
                    methyl_acc.attach_checkpoint(ck)
            batches = call_duplex_batches(
                duplex_ingest_stream(src, reader, stats, ingest_choice=cfg.ingest,
                                     grouping=cfg.grouping),
                fasta.fetch,
                names,
                params=cfg.duplex,
                mode=mode,
                batch_families=cfg.batch_families,
                max_window=cfg.max_window,
                grouping=cfg.grouping,
                stats=stats,
                pos0=cfg.pos0,
                device=self.device,
                emit=cfg.emit,
                skip_batches=ck.batches_done if ck else 0,
                transport=cfg.transport,
                refstore=store,
                strand_tags=cfg.duplex_strand_tags,
                chemistry=cfg.chemistry,
                methyl=methyl_acc,
            )
            self._write_stage_output(batches, rule.outputs[0], header, mode, ck, stats)
            if methyl_acc is not None:
                methyl_acc.finalize()

    def _interstage_blocked(self) -> str:
        """Why the fused molecular->duplex streaming path cannot engage:
        it needs the bucket sort engine's in-plan-order bucket emit, which
        the port does not have yet (ROADMAP queue 1, item 8; the fused rule
        itself waits for it too)."""
        return "sort_engine must resolve to 'bucket'"

    def run_sam_to_fastq(self, rule) -> None:
        from bsseqconsensusreads_tpu_torch.io.fastq import sam_to_fastq

        with BamReader(rule.inputs[0]) as reader:
            sam_to_fastq(reader, rule.outputs[0], rule.outputs[1])

    def run_bwameth(self, rule) -> None:
        from bsseqconsensusreads_tpu_torch.io.sam import read_sam

        if not self.cfg.bwameth:
            raise WorkflowError(
                "aligner 'bwameth' requested but config.bwameth is not set; "
                "use aligner 'self' for the on-card path"
            )
        cmd = (
            f"{self.cfg.bwameth} --reference {shlex.quote(self.cfg.genome_fasta)} "
            f"-t 8 {shlex.quote(rule.inputs[0])} {shlex.quote(rule.inputs[1])}"
        )
        # the reference tees bwameth stderr of the FIRST alignment to
        # output/log/bwameth_results/{sample}_consensus_unfiltered.log
        # (main.snake.py:88-89) and declares no log on the final duplex
        # alignment (:186-189)
        log_fh = None
        if rule.name == "align_consensus_unfiltered":
            log_path = os.path.join(
                self.outdir, "log", "bwameth_results",
                f"{self.sample}_consensus_unfiltered.log",
            )
            os.makedirs(os.path.dirname(log_path), exist_ok=True)
            log_fh = open(log_path, "w")
        try:
            proc = subprocess.Popen(
                cmd, shell=True, stdout=subprocess.PIPE, stderr=log_fh,
                text=True,
            )
            header, records = read_sam(proc.stdout)
            with BamWriter(
                rule.outputs[0], header, level=self._out_level(rule.outputs[0])
            ) as writer:
                writer.write_all(records)
            if proc.wait() != 0:
                raise WorkflowError(f"bwameth failed: {cmd}")
        finally:
            if log_fh is not None:
                log_fh.close()

    def run_zipper(self, rule) -> None:
        from bsseqconsensusreads_tpu_torch.pipeline.record_ops import zipper_bams_stream

        with BamReader(rule.inputs[0]) as aligned, BamReader(rule.inputs[1]) as unaligned:
            header = self._pg(aligned.header, "zipper")
            merged = zipper_bams_stream(
                aligned, unaligned, header,
                workdir=self.cfg.tmp or None,
                buffer_records=self.cfg.sort_buffer_records,
            )
            with BamWriter(
                rule.outputs[0], header, level=self._out_level(rule.outputs[0])
            ) as writer:
                writer.write_all(merged)

    def run_filter_mapped(self, rule) -> None:
        from bsseqconsensusreads_tpu_torch.pipeline.record_ops import filter_mapped

        with BamReader(rule.inputs[0]) as reader:
            header = self._pg(reader.header, "filter-mapped")
            with BamWriter(
                rule.outputs[0], header, level=self._out_level(rule.outputs[0])
            ) as writer:
                writer.write_all(filter_mapped(reader))

    # ---- pipeline assembly --------------------------------------------

    def _needs_grouping(self) -> bool:
        """Whether the input needs the GroupReadsByUmi-equivalent
        pre-stage: 'auto' probes the input's first records (up to 50) —
        any MI means already-grouped input; raw-UMI tags without MI mean a
        raw aligned BAM."""
        mode = self.cfg.group_umis
        if mode == "always":
            return True
        if mode == "never":
            return False
        if mode != "auto":
            raise WorkflowError(
                f"unknown group_umis {mode!r} (want auto|always|never)"
            )
        if not os.path.exists(self.bam_path):
            return False  # let the workflow report the missing input
        tag = self.cfg.group_raw_tag
        saw_umi = False
        with BamReader(self.bam_path) as reader:
            for i, rec in enumerate(reader):
                if rec.has_tag("MI"):
                    return False  # already grouped
                saw_umi = saw_umi or rec.has_tag(tag)
                if i >= 49:  # a raw-UMI probe, robust to odd lead records
                    break
        return saw_umi

    def _check_config(self) -> None:
        """Refuse, before any stage runs, what the port cannot run: a
        value no package knows, or a key whose module is still to port
        (the error names its ROADMAP item). Nothing falls back silently."""
        cfg = self.cfg
        if cfg.aligner not in ("self", "bwameth", "none"):
            raise WorkflowError(f"unknown aligner {cfg.aligner!r} (self | bwameth | none)")
        if cfg.chemistry not in ("bisulfite", "emseq", "none"):
            raise WorkflowError(
                f"unknown chemistry {cfg.chemistry!r} (bisulfite | emseq | none)"
            )
        if cfg.methyl not in ("off", "bedmethyl", "cx", "both"):
            raise WorkflowError(
                f"unknown methyl mode {cfg.methyl!r} (off | bedmethyl | cx | both)"
            )
        if cfg.methyl != "off" and cfg.chemistry == "none":
            raise WorkflowError(
                "methyl extraction needs a converting chemistry "
                "(bisulfite or emseq), not chemistry 'none'"
            )
        if cfg.methyl != "off" and cfg.single_strand:
            raise WorkflowError(
                "methyl extraction is a duplex-stage epilogue; "
                "single_strand stops after the molecular stage"
            )
        if cfg.filter is not None:
            raise _not_ported("filter", 8, "group_umi, filter and metrics")
        if cfg.duplex_passthrough:
            raise _not_ported("duplex_passthrough", 8,
                              "record_ops host code, duplex passthrough")
        if cfg.sort_engine == "bucket":
            raise _not_ported("sort_engine: bucket", 8, "bucketemit and the bucket engine")
        try:  # an unknown transport; indel_policy 'align' (item 7)
            check_route(cfg.transport, cfg.indel_policy)
        except ValueError as exc:
            raise WorkflowError(f"config: {exc}") from None
        if self._needs_grouping():
            raise _not_ported(
                f"group_umis: {cfg.group_umis} (the input needs UMI grouping)",
                8, "group_umi",
            )

    def build(self) -> tuple[Workflow, str]:
        cfg = self.cfg
        self._check_config()
        wf = Workflow()
        consensus_input = self.bam_path
        if cfg.single_strand:
            # molecular emit without duplex pairing: 'self' leaves a
            # coordinate-sorted aligned BAM; other aligner modes leave the
            # unaligned molecular consensus
            target = self.out("_consensus_molecular_unfiltered.bam")
            mode = "self" if cfg.aligner == "self" else "unaligned"
            wf.rule(
                "call_consensus_molecular_tpu",
                [consensus_input],
                [target],
                lambda r: self.run_molecular(r, mode=mode),
            )
            self.final_output = target
            return wf, target
        if cfg.aligner == "self":
            aligned = self.out("_consensus_unfiltered_aunamerged_aligned.bam")
            target = self.out("_consensus_duplex_unfiltered.bam")
            if cfg.stream_interstage:
                # the fallback must be loud: an operator who asked for
                # fusion and got the two-pass path should see why
                observe.stderr_line(
                    f"stream_interstage disabled: {self._interstage_blocked()}"
                )
            wf.rule(
                "call_consensus_molecular_tpu",
                [consensus_input],
                [aligned],
                lambda r: self.run_molecular(r, mode="self"),
            )
            wf.rule(
                "call_duplex_tpu",
                [aligned],
                [target],
                lambda r: self.run_duplex(r, mode="self"),
            )
            self.final_output = target
            return wf, target

        molecular = self.out("_unalignedConsensus_molecular.bam")
        wf.rule(
            "call_consensus_reads_molecular",
            [consensus_input],
            [molecular],
            lambda r: self.run_molecular(r, mode="unaligned"),
        )
        fq1 = self.out("_unalignedConsensus_unfiltered_1.fq.gz")
        fq2 = self.out("_unalignedConsensus_unfiltered_2.fq.gz")
        wf.rule("consensus_to_fq_unfiltered", [molecular], [fq1, fq2], self.run_sam_to_fastq)
        if cfg.aligner == "none":
            self.final_output = fq1
            return wf, fq1

        aligned0 = self.out("_consensus_unfiltered.bam")
        wf.rule("align_consensus_unfiltered", [fq1, fq2], [aligned0], self.run_bwameth)
        merged = self.out("_consensus_unfiltered_aunamerged.bam")
        wf.rule("mergeAunA_consensus", [aligned0, molecular], [merged], self.run_zipper)
        aligned = self.out("_consensus_unfiltered_aunamerged_aligned.bam")
        wf.rule("mergeAunA_consensus_grepaligned", [merged], [aligned], self.run_filter_mapped)
        duplex = self.out(
            "_consensus_unfiltered_aunamerged_converted_extended_duplexconsensus.bam"
        )
        wf.rule(
            "callduplex_tpu",
            [aligned],
            [duplex],
            lambda r: self.run_duplex(r, mode="unaligned"),
        )
        dfq1 = self.out("_unalignedConsensus_duplex_1.fq.gz")
        dfq2 = self.out("_unalignedConsensus_duplex_2.fq.gz")
        wf.rule("consensusduplex_to_fq", [duplex], [dfq1, dfq2], self.run_sam_to_fastq)
        target = self.out("_consensus_duplex_unfiltered_bwameth.bam")
        wf.rule("align_consensus_unfiltered_duplex", [dfq1, dfq2], [target], self.run_bwameth)
        self.final_output = target
        return wf, target


def run_pipeline(
    cfg: FrameworkConfig, bam_path: str, outdir: str = "output", force: bool = False
):
    """Build and run the pipeline; returns (target, rule results, stats).

    The device comes from cfg.backend ('cuda', the default, raises
    without a card; 'cpu' runs the plain PyTorch versions) and is
    resolved before any rule runs. The JAX package's run ledger
    (observe.open_ledger, rule_complete / stage_stats /
    pipeline_complete lines, BSSEQ_TPU_STATS) is ROADMAP queue 1, item 9;
    its compile cache (utils.compilecache) has no counterpart here."""
    device = resolve_device(check_backend(cfg.backend))
    builder = PipelineBuilder(cfg, bam_path, outdir, device=device)
    wf, target = builder.build()
    results = wf.run([target], force=force)
    return target, results, builder.stats
