"""The duplex-consensus pipeline as a workflow over file checkpoints.

The port of the JAX package's pipeline/stages.py: the stage ingest
(ingest_records and the two stage streams), PipelineBuilder and
run_pipeline. The rule chain is the reference's (main.snake.py:40-189)
with the consensus stages on the card, and the intermediate file names
are the reference's suffix chain.

A raw aligned BAM (raw UMIs in cfg.group_raw_tag, no MI) first goes
through the GroupReadsByUmi-equivalent rule `group_reads_by_umi`
(pipeline.group_umi) into `<sample>_umigrouped.bam`, whose molecules are
MI-contiguous, so the molecular stage then groups 'adjacent'.
group_umis 'auto' (the default) prepends it when the input's first
records carry the raw tag and no MI; 'always' regroups any input.

Three alignment modes (cfg.aligner):

* 'self'    — molecular consensus (mode 'self': window-space consensus
              keeps coordinates) written as the intermediate
              `<sample>_consensus_unfiltered_aunamerged_aligned.bam`, then
              the fused duplex stage into the coordinate-sorted target
              `<sample>_consensus_duplex_unfiltered.bam`; 2 rules.
* 'bwameth' — parity path: every reference rule has an equivalent here,
              shelling out to bwameth exactly as the reference does.
* 'none'    — stop after the molecular consensus FASTQs.

single_strand stops after the molecular stage. cfg.filter (a dict of
pipeline.filter.FilterParams fields, validated at build time) appends the
FilterConsensusReads-equivalent rule: on 'self' `filter_consensus_duplex`
over the coordinate-sorted duplex target (name sort, filter, coordinate
sort: three passes over encoded blobs, off the duplex stage) into
`<sample>_consensus_duplex_filtered.bam`, the new target; on 'none' and
'bwameth' `filter_consensus_molecular` into
`<sample>_unalignedConsensus_molecular_filtered.bam`, which the FASTQs
and the zipper then read. duplex_passthrough writes the duplex stage's
leftover records through (pipeline.calling._passthrough_records) and
forces the Python ingest; with a filter it is refused (leftovers carry no
cd tags).

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

sort_engine 'bucket' (pipeline.bucketemit) routes the 'self' outputs
into coordinate buckets; with stream_interstage it also fuses the two
consensus stages into one rule, `call_consensus_molecular_duplex_fused`
(run_fused): the molecular batches route into buckets, and as each
sorted bucket is written to the molecular BAM its records go straight on
into the duplex grouping — the intermediate file is still written (same
bytes), but never re-read. Where fusion cannot engage
(_interstage_blocked: another sort engine, checkpoints, methyl,
passthrough) the JAX package's loud fallback to the two-pass path runs.

Each consensus stage builds its input guard from the environment
(faults.guard.Guard.from_env: BSSEQ_TPU_INPUT_POLICY, default strict)
and reads through open_guarded_reader.

indel_policy ('drop' | 'align') reaches both molecular call sites (the
two-pass rule and the fused rule) and the molecular ingest's C scan; an
unknown policy or transport raises a WorkflowError in
PipelineBuilder.build(), before any stage runs.

With BSSEQ_TPU_STATS set, run_pipeline writes the JAX package's run
ledger (utils.observe): a run_manifest line, one rule_complete line per
rule, one stage_stats line per stage and a closing pipeline_complete
line. BSSEQ_TPU_COMPILE_CACHE_DIR points the kernel builds at a shared
directory (utils.compilecache).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import time

from bsseqconsensusreads_tpu_torch.config import FrameworkConfig, check_backend
from bsseqconsensusreads_tpu_torch.faults import guard as _guard
from bsseqconsensusreads_tpu_torch.io.bam import (
    BamHeader,
    BamReader,
    BamWriter,
    GuardedBamReader,
)
from bsseqconsensusreads_tpu_torch.io.fasta import FastaFile
from bsseqconsensusreads_tpu_torch.pipeline.calling import (
    StageStats,
    call_duplex_batches,
    call_molecular_batches,
    check_route,
)
from bsseqconsensusreads_tpu_torch.pipeline.checkpoint import BatchCheckpoint
from bsseqconsensusreads_tpu_torch.pipeline.workflow import Workflow, WorkflowError
from bsseqconsensusreads_tpu_torch.utils import compilecache, observe
from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

INGEST_CHOICES = ("auto", "native", "python")


def open_guarded_reader(path: str, guard):
    """The policy's record reader for one consensus stage's input: the
    resilient policies (quarantine, lenient) read through
    io.bam.GuardedBamReader — BGZF resync, record quarantine, per-record
    validation — while strict and off keep the plain BamReader (strict's
    structural checks are always on in BamReader itself; its semantic
    checks run vectorized in the native grouped stream or per family in
    faults.guard.guard_groups). Binds the guard to the input either way,
    so the sidecar path and `record #N` diagnostics are anchored."""
    if guard is not None and guard.resilient:
        return GuardedBamReader(path, guard)
    reader = BamReader(path)
    if guard is not None:
        guard.bind(path, reader.header)
    return reader


def ingest_records(path: str, reader, stats: StageStats,
                   ingest_choice: str = "auto",
                   grouping: str = "coordinate",
                   strip_suffix: bool = False,
                   scan_policy: str | None = None,
                   threads: int | None = None,
                   native_block_reason: str | None = None,
                   guard=None):
    """The record stream for one consensus stage: a
    pipeline.ingest.GroupedColumnarStream over `path` (records decoded and
    grouped in C, with the stage's encode scan) or `reader`, the open
    BamReader on the same file. native_block_reason: why this stage
    needs the Python records ('auto' then takes them; 'native' raises a
    WorkflowError naming it). The chosen engine lands in stats.metrics
    as the 'ingest_native' / 'group_native' counters.

    `guard` (faults.guard.Guard) routes by policy: the resilient policies
    need the Python records of io.bam.GuardedBamReader (which `reader`
    must then be), so they take the Python engine ('native' raises); the
    strict policy keeps the native engine and hands the guard to the
    grouped stream for its vectorized per-batch validation."""
    if ingest_choice not in INGEST_CHOICES:
        raise ValueError(f"unknown ingest {ingest_choice!r}; use auto|native|python")
    if guard is not None and guard.resilient and native_block_reason is None:
        native_block_reason = (
            f"the {guard.policy!r} input policy (stream resync and record "
            "quarantine need the Python decode engine)"
        )
    native_ok = grouping in ("coordinate", "adjacent")
    if ingest_choice == "native" and not native_ok:
        raise ValueError(
            f"ingest 'native' is incompatible with grouping {grouping!r} "
            "(it would pin every columnar batch for the whole file)"
        )
    if native_block_reason is not None:
        if ingest_choice == "native":
            # an explicit request the stage cannot honor fails loudly
            raise WorkflowError(
                f"ingest 'native' is incompatible here: {native_block_reason}"
            )
        native_ok = False
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
        grouping=grouping, threads=threads, guard=guard,
    )


def molecular_ingest_stream(path: str, reader, stats: StageStats,
                            ingest_choice: str = "auto",
                            grouping: str = "coordinate",
                            threads: int | None = None,
                            guard=None,
                            indel_policy: str = "drop"):
    """The molecular stage's ingest: full-MI grouping, the C encode digest
    under the stage's indel policy."""
    return ingest_records(path, reader, stats, ingest_choice=ingest_choice,
                          grouping=grouping, scan_policy=indel_policy, threads=threads,
                          guard=guard)


def duplex_ingest_stream(path: str, reader, stats: StageStats,
                         ingest_choice: str = "auto",
                         grouping: str = "coordinate",
                         threads: int | None = None,
                         passthrough: bool = False,
                         guard=None):
    """The duplex stage's ingest: strand-suffix-stripped grouping (base
    MI) and the duplex-shaped C scan. The duplex stage reads only MI, RX
    and the cd/ce/cB consensus arrays off its records, all of which the
    columnar views carry — except under passthrough, whose leftovers are
    written through with their full tag set: Python records then."""
    return ingest_records(
        path, reader, stats, ingest_choice=ingest_choice, grouping=grouping,
        strip_suffix=True, scan_policy="duplex", threads=threads,
        native_block_reason=(
            "duplex passthrough needs full-tag Python records "
            "(native views carry only MI/RX)"
        ) if passthrough else None,
        guard=guard,
    )


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
            # graftlint: disable=thread-unsafe-mutation -- the pipeline builder runs on
            # the main thread before any stage; the worker edge is a basename match
            # (out)
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
                sort_engine=self.cfg.sort_engine, metrics=stats.metrics,
                sort_buckets=self.cfg.sort_buckets, **sort_kw,
            )
            return
        ck.write_batches(batches)
        engine = resolve_sort_engine(self.cfg.sort_engine) if mode == "self" else None
        if engine == "bucket":
            # the two-phase bucketed finalize: per-bucket sorted runs
            # behind their own manifest, only damaged buckets replayed
            # on resume (pipeline.bucketemit); it books its own seconds
            from bsseqconsensusreads_tpu_torch.pipeline import bucketemit

            bucketemit.finalize_checkpoint(
                ck, header, metrics=stats.metrics, buckets=self.cfg.sort_buckets,
                **sort_kw,
            )
            return
        with stats.metrics.timed("sort_write"):
            if mode != "self":
                ck.finalize(None)  # raw shard concatenation
            elif engine == "native":
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

    def run_group(self, rule) -> None:
        """UMI-grouping pre-stage (fgbio GroupReadsByUmi equivalent,
        pipeline.group_umi): RX -> MI with /A|/B duplex suffixes, two
        bounded-memory external passes over raw record blobs."""
        from bsseqconsensusreads_tpu_torch.pipeline.group_umi import (
            GroupStats,
            group_reads_by_umi_raw,
            grouped_header,
        )

        stats = self.stats.setdefault("group", GroupStats())
        out_path = rule.outputs[0]
        with BamReader(rule.inputs[0]) as reader:
            header = self._pg(grouped_header(reader.header), "group")
            with BamWriter(out_path, header, level=self._out_level(out_path)) as w:
                w.write_raw_many(
                    group_reads_by_umi_raw(
                        reader, reader.header,
                        strategy=self.cfg.group_strategy,
                        edits=self.cfg.group_edits,
                        raw_tag=self.cfg.group_raw_tag,
                        min_map_q=self.cfg.group_min_map_q,
                        workdir=self.cfg.tmp or None,
                        buffer_records=self.cfg.sort_buffer_records,
                        stats=stats,
                    )
                )

    def _filter_params(self):
        """cfg.filter dict -> validated pipeline.filter.FilterParams.
        Called at build() time too, so a bad dict fails in seconds, not
        after the consensus stages have run."""
        from bsseqconsensusreads_tpu_torch.pipeline.filter import FilterParams

        kw = dict(self.cfg.filter or {})
        if "min_reads" in kw:
            v = kw["min_reads"]
            kw["min_reads"] = (v,) if isinstance(v, int) else tuple(v)
        try:
            return FilterParams(**kw)
        except (TypeError, ValueError) as exc:
            raise WorkflowError(f"invalid `filter:` config: {exc}") from exc

    def run_filter(self, rule) -> None:
        """Consensus-filter stage (pipeline.filter) over the unaligned
        molecular consensus: the producer of the
        `…_molecular_filtered.bam` the reference's dead rule expects
        (main.snake.py:70-80)."""
        from bsseqconsensusreads_tpu_torch.pipeline.filter import (
            FilterStats,
            filter_consensus_raw,
            probe_strand_tag_support,
        )

        params = self._filter_params()
        probe_strand_tag_support(rule.inputs[0], params)
        stats = self.stats.setdefault("filter", FilterStats())
        out_path = rule.outputs[0]
        with BamReader(rule.inputs[0]) as reader:
            header = self._pg(reader.header, "filter")
            with BamWriter(out_path, header, level=self._out_level(out_path)) as w:
                w.write_raw_many(filter_consensus_raw(reader.raw_records(), params, stats=stats))

    def run_filter_duplex(self, rule) -> None:
        """Self-mode consensus filter: the duplex output is
        coordinate-sorted, so template mates are not adjacent — stream it
        through an external name sort, filter template-atomically, and
        coordinate-sort the survivors back out. Three bounded-memory
        passes, kept off the duplex stage (filtering before its sort would
        force the Python emit there), all over encoded blobs: the name
        sort (raw_name_key), filter_consensus_raw, then the stage outputs'
        raw coordinate sort (cfg.sort_engine) — the JAX package's record
        passes' bytes with no object round trip per spill."""
        from bsseqconsensusreads_tpu_torch.pipeline.extsort import (
            external_sort_raw,
            external_sort_raw_to_writer,
            raw_name_key,
        )
        from bsseqconsensusreads_tpu_torch.pipeline.filter import (
            FilterStats,
            filter_consensus_raw,
            probe_strand_tag_support,
        )

        params = self._filter_params()
        probe_strand_tag_support(rule.inputs[0], params)
        stats = self.stats.setdefault("filter", FilterStats())
        sort_kw = dict(workdir=self.cfg.tmp or None,
                       buffer_records=self.cfg.sort_buffer_records)
        out_path = rule.outputs[0]
        with BamReader(rule.inputs[0]) as reader:
            header = self._pg(reader.header, "filter").with_sort_order("coordinate")
            name_sorted = external_sort_raw(reader.raw_records(), header, key=raw_name_key,
                                            **sort_kw)
            with BamWriter(out_path, header, level=self._out_level(out_path)) as w:
                external_sort_raw_to_writer(
                    filter_consensus_raw(name_sorted, params, stats=stats), w, header,
                    engine=self.cfg.sort_engine, **sort_kw,
                )

    def _molecular_batches(self, src: str, reader, stats: StageStats, guard, mode: str,
                           skip_batches: int = 0):
        """The molecular stage's batch stream over an open guarded reader."""
        cfg = self.cfg
        return call_molecular_batches(
            molecular_ingest_stream(src, reader, stats, ingest_choice=cfg.ingest,
                                    grouping=self.molecular_grouping, guard=guard,
                                    indel_policy=cfg.indel_policy),
            params=cfg.molecular,
            mode=mode,
            batch_families=cfg.batch_families,
            max_window=cfg.max_window,
            grouping=self.molecular_grouping,
            stats=stats,
            batching=cfg.batching,
            device=self.device,
            emit=cfg.emit,
            skip_batches=skip_batches,
            indel_policy=cfg.indel_policy,
            transport=cfg.transport,
            base_counts=cfg.base_count_tags,
            guard=guard,
        )

    def run_molecular(self, rule, mode: str) -> None:
        stats = self.stats.setdefault("molecular", StageStats(stage="molecular"))
        src = rule.inputs[0]
        g = _guard.Guard.from_env(stats)
        try:
            with open_guarded_reader(src, g) as reader, observe.maybe_trace("molecular"):
                header = self._pg(reader.header, "molecular")
                ck = self._checkpointed("molecular", rule, header)
                batches = self._molecular_batches(
                    src, reader, stats, g, mode, skip_batches=ck.batches_done if ck else 0,
                )
                self._write_stage_output(batches, rule.outputs[0], header, mode, ck, stats)
        finally:
            g.close()

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
        g = _guard.Guard.from_env(stats)
        try:
            with FastaFile(cfg.genome_fasta) as fasta, open_guarded_reader(src, g) as reader, \
                    observe.maybe_trace("duplex"):
                names = [n for n, _ in reader.header.references]
                header = self._pg(reader.header, "duplex")
                if mode == "self":  # output leaves coordinate-sorted
                    header = header.with_sort_order("coordinate")
                ck = self._checkpointed("duplex", rule, header)
                methyl_acc = None
                # the FASTA path: loaded into a device-resident genome only
                # when the wire transport engages (call_duplex_batches
                # decides) — or the methyl accumulator's store when
                # extraction is on
                store = cfg.genome_fasta
                if cfg.methyl != "off":
                    methyl_acc = self._methyl_accumulator(rule, stats)
                    store = methyl_acc.refstore
                    if ck is not None:
                        # spill at the checkpoint's committed watermarks,
                        # and restore the run chain on resume
                        methyl_acc.attach_checkpoint(ck)
                batches = self._duplex_batches(
                    duplex_ingest_stream(src, reader, stats, ingest_choice=cfg.ingest,
                                         grouping=cfg.grouping,
                                         passthrough=cfg.duplex_passthrough, guard=g),
                    fasta, names, stats, mode, store,
                    skip_batches=ck.batches_done if ck else 0,
                    methyl=methyl_acc, guard=g,
                )
                self._write_stage_output(batches, rule.outputs[0], header, mode, ck, stats)
                if methyl_acc is not None:
                    methyl_acc.finalize()
        finally:
            g.close()

    def _duplex_batches(self, records, fasta, names, stats: StageStats, mode: str, store,
                        skip_batches: int = 0, methyl=None, guard=None):
        """The duplex stage's batch stream over a record stream."""
        cfg = self.cfg
        return call_duplex_batches(
            records,
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
            skip_batches=skip_batches,
            transport=cfg.transport,
            refstore=store,
            strand_tags=cfg.duplex_strand_tags,
            chemistry=cfg.chemistry,
            methyl=methyl,
            passthrough=cfg.duplex_passthrough,
            guard=guard,
        )

    def _interstage_blocked(self) -> str:
        """Why the fused molecular->duplex rule cannot engage ('' when it
        can): it needs the bucket engine's in-plan-order bucket emit (the
        tee rides BucketRouter.stream_to) and no mid-stage checkpoint
        (shard replay would re-enter the tee); methyl and passthrough ride
        the two-pass path, as in the JAX package."""
        from bsseqconsensusreads_tpu_torch.pipeline.extsort import resolve_sort_engine

        if resolve_sort_engine(self.cfg.sort_engine) != "bucket":
            return "sort_engine must resolve to 'bucket'"
        if self.cfg.checkpoint_every > 0:
            return "checkpoint_every > 0 (batch shards cannot tee)"
        if self.cfg.methyl != "off":
            return "methyl extraction rides the duplex checkpoint protocol"
        if self.cfg.duplex_passthrough:
            return "duplex_passthrough is validated on the two-pass path"
        return ""

    def run_fused(self, rule) -> None:
        """The fused molecular->duplex rule (stream_interstage): the
        molecular batch stream routes into coordinate buckets, and as each
        sorted bucket is written to the molecular BAM its records also
        decode straight into the duplex grouping — the intermediate file
        is still written (the same bytes: one continuous writer in plan
        order), but the duplex stage never re-reads it. The duplex stage
        then takes Python records, as in the JAX package."""
        from bsseqconsensusreads_tpu_torch.io.bam import attach_codec_metrics, decode_record
        from bsseqconsensusreads_tpu_torch.pipeline import bucketemit

        cfg = self.cfg
        mol_out, duplex_out = rule.outputs
        mol_stats = self.stats.setdefault("molecular", StageStats(stage="molecular"))
        dstats = self.stats.setdefault("duplex", StageStats(stage="duplex"))
        src = rule.inputs[0]
        g = _guard.Guard.from_env(mol_stats)
        try:
            with FastaFile(cfg.genome_fasta) as fasta, open_guarded_reader(src, g) as reader, \
                    observe.maybe_trace("fused"):
                mol_header = self._pg(reader.header, "molecular")
                batches = self._molecular_batches(src, reader, mol_stats, g, "self")
                plan = bucketemit.BucketPlan.from_header(mol_header, cfg.sort_buckets)
                mol_stats.metrics.count("bucket_count", plan.nbuckets)
                router = bucketemit.BucketRouter(
                    plan, mol_header, workdir=cfg.tmp or None,
                    buffer_records=cfg.sort_buffer_records, metrics=mol_stats.metrics,
                )

                def fused_records():
                    """Pull-driven tee: consuming this generator runs the
                    molecular stage, writes its BAM, and hands every sorted
                    record on as a decoded object."""
                    try:
                        for batch in batches:
                            for item in batch:
                                router.route(item)
                        with BamWriter(mol_out, mol_header,
                                       level=self._out_level(mol_out)) as w:
                            attach_codec_metrics(w, mol_stats.metrics)
                            for blob in router.stream_to(w):
                                # stream_to yields the prefixed frame
                                yield decode_record(blob[4:])
                    finally:
                        router.close()

                names = [n for n, _ in mol_header.references]
                dheader = self._pg(mol_header, "duplex").with_sort_order("coordinate")
                dstats.metrics.count("ingest_native", 0)
                dstats.metrics.count("group_native", 0)
                dbatches = self._duplex_batches(
                    fused_records(), fasta, names, dstats, "self", cfg.genome_fasta,
                )
                self._write_stage_output(dbatches, duplex_out, dheader, "self", None, dstats)
        finally:
            g.close()

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
        try:  # an unknown transport or indel policy
            check_route(cfg.transport, cfg.indel_policy)
        except ValueError as exc:
            raise WorkflowError(f"config: {exc}") from None
        if cfg.filter is not None and not cfg.single_strand:  # single_strand: no filter rule
            self._filter_params()  # fail fast on a bad dict
            if cfg.duplex_passthrough and cfg.aligner == "self":
                raise WorkflowError(
                    "filter + duplex_passthrough: passthrough leftovers carry "
                    "no cd consensus tags, which the filter requires — "
                    "disable one of the two"
                )

    def build(self) -> tuple[Workflow, str]:
        cfg = self.cfg
        self._check_config()
        wf = Workflow()
        consensus_input = self.bam_path
        if self._needs_grouping():
            consensus_input = self.out("_umigrouped.bam")
            wf.rule("group_reads_by_umi", [self.bam_path], [consensus_input], self.run_group)
            # the grouped intermediate is MI-contiguous in position order
            self.molecular_grouping = "adjacent"
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
            fused = False
            if cfg.stream_interstage:
                blocked = self._interstage_blocked()
                if blocked:
                    # the fallback must be loud: an operator who asked for
                    # fusion and got the two-pass path should see why
                    observe.emit("interstage_fallback", {"reason": blocked})
                    observe.stderr_line(f"stream_interstage disabled: {blocked}")
                else:
                    fused = True
            if fused:
                wf.rule(
                    "call_consensus_molecular_duplex_fused",
                    [consensus_input],
                    [aligned, target],
                    self.run_fused,
                )
            else:
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
            if cfg.filter is not None:
                ftarget = self.out("_consensus_duplex_filtered.bam")
                wf.rule("filter_consensus_duplex", [target], [ftarget], self.run_filter_duplex)
                target = ftarget
            self.final_output = target
            return wf, target

        molecular = self.out("_unalignedConsensus_molecular.bam")
        wf.rule(
            "call_consensus_reads_molecular",
            [consensus_input],
            [molecular],
            lambda r: self.run_molecular(r, mode="unaligned"),
        )
        fq_src = molecular
        if cfg.filter is not None:
            # the file the reference's dead rule reads (main.snake.py:72)
            fq_src = self.out("_unalignedConsensus_molecular_filtered.bam")
            wf.rule("filter_consensus_molecular", [molecular], [fq_src], self.run_filter)
        fq1 = self.out("_unalignedConsensus_unfiltered_1.fq.gz")
        fq2 = self.out("_unalignedConsensus_unfiltered_2.fq.gz")
        wf.rule("consensus_to_fq_unfiltered", [fq_src], [fq1, fq2], self.run_sam_to_fastq)
        if cfg.aligner == "none":
            self.final_output = fq1
            return wf, fq1

        aligned0 = self.out("_consensus_unfiltered.bam")
        wf.rule("align_consensus_unfiltered", [fq1, fq2], [aligned0], self.run_bwameth)
        merged = self.out("_consensus_unfiltered_aunamerged.bam")
        # the tag graft reads the BAM that fed the aligner (the filtered
        # one when the filter rule ran)
        wf.rule("mergeAunA_consensus", [aligned0, fq_src], [merged], self.run_zipper)
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
    resolved before any rule runs. With BSSEQ_TPU_STATS set the run
    writes the JAX package's ledger: a run_manifest line (with the
    config digest and the sample), one 'rule_complete' line per rule,
    one 'stage_stats' line per stage and a closing 'pipeline_complete'
    line whose pipeline_s the rule seconds sum to."""
    device = resolve_device(check_backend(cfg.backend))
    compilecache.maybe_enable()
    builder = PipelineBuilder(cfg, bam_path, outdir, device=device)
    wf, target = builder.build()
    observe.open_ledger(config_digest=observe.config_digest(cfg), component="pipeline",
                        sample=builder.sample)
    t0 = time.monotonic()
    results = wf.run([target], force=force)
    pipeline_s = time.monotonic() - t0
    for r in results:
        observe.emit("rule_complete", {"rule": r.name, "ran": r.ran,
                                       "seconds": round(r.seconds, 3), "reason": r.reason})
    observe.emit_stage_stats(builder.stats, sample=builder.sample)
    observe.emit("pipeline_complete", {"pipeline_s": round(pipeline_s, 3), "target": target,
                                       "rules": len(results), "sample": builder.sample})
    observe.flush_sinks()
    return target, results, builder.stats
