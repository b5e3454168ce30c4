"""Framework configuration.

The port's FrameworkConfig: every field of the JAX package's config.py
dataclass under the same name and with the same default, and the same
YAML surface (the reference's config.yaml keys genome_dir,
genome_fasta_file_name, tmp and the tool paths, plus the keys the
reference hardcodes in its rule bodies).

One field differs: `backend` takes 'cuda' (default: the card) or 'cpu'
(the plain PyTorch versions on the host). The JAX value 'tpu' is refused,
and a config asking for the card never falls back to the CPU — without a
card the run raises (utils.device.resolve_device).

Which keys the port's pipeline honours, and which still raise at
PipelineBuilder.build() with the ROADMAP item that brings them, is
listed in pipeline/stages.py.

PyYAML is imported by from_yaml only, when it is called: the port's
modules import without it.
"""

from __future__ import annotations

import dataclasses
import os

from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.pipeline.workflow import WorkflowError

BACKENDS = ("cuda", "cpu")


def check_backend(backend: str) -> str:
    """`backend` if it is one the port runs on, else a WorkflowError that
    names the values it takes."""
    if backend not in BACKENDS:
        raise WorkflowError(
            f"unknown backend {backend!r}: the port runs on 'cuda' (the "
            "card, default) or 'cpu' (the plain PyTorch versions); the JAX "
            "package's 'tpu' has no counterpart here"
        )
    return backend


@dataclasses.dataclass
class FrameworkConfig:
    # reference-compatible keys (config.yaml:1-11)
    genome_dir: str = "."
    genome_fasta_file_name: str = "genome.fa"
    tmp: str = "/tmp"
    bwameth: str = ""  # external aligner command; empty = not available
    samtools: str = ""  # kept for interop; unused by the pipeline

    # framework keys (promoted from hardcoded rule bodies)
    backend: str = "cuda"  # cuda | cpu
    aligner: str = "self"  # self | bwameth | none
    batch_families: int = 512
    max_window: int = 4096
    #: MI-group streaming strategy (pipeline.calling.stream_mi_groups)
    grouping: str = "coordinate"
    #: molecular-stage chunk composition: 'bucketed' | 'sequential'
    batching: str = "bucketed"
    #: intra-stage checkpoint interval in kernel batches (0 = rule-boundary
    #: checkpoints only); pipeline.checkpoint
    checkpoint_every: int = 0
    #: indel reads in the molecular stage: 'drop' (reference parity)
    indel_policy: str = "drop"
    #: spill threshold (records) of the external-merge sorts
    sort_buffer_records: int = 100_000
    #: consensus-stage record ingest: auto | native | python
    ingest: str = "auto"
    #: consensus-stage record emission: auto | native | python
    emit: str = "auto"
    #: raw coordinate-sort engine of the 'self' stage outputs
    sort_engine: str = "auto"
    #: bucket count for sort_engine 'bucket'
    sort_buckets: int = 0
    #: the fused molecular->duplex streaming path (needs sort_engine
    #: 'bucket'; otherwise the run falls back loudly to the two-pass path)
    stream_interstage: bool = False
    #: BGZF deflate level of intermediate stage outputs (the final target
    #: always writes at level 6)
    intermediate_level: int = 1
    #: consensus-stage device transport: auto | wire | unpacked. One device:
    #: 'auto' is the packed wire on the card (backend cuda) and the plain
    #: unpacked tensors on the CPU, the JAX package's single-device rule
    transport: str = "auto"
    #: UMI grouping pre-stage: auto | always | never
    group_umis: str = "auto"
    group_strategy: str = "paired"
    group_edits: int = 1
    group_min_map_q: int = 1
    group_raw_tag: str = "RX"
    #: optional consensus-filter stage (a dict of FilterParams fields)
    filter: dict | None = None
    #: reference-parity emission of off-vocabulary duplex records
    duplex_passthrough: bool = False
    #: conversion prepend at reference position 0: 'skip' | 'shift'
    pos0: str = "skip"
    #: molecular-stage cB raw base histogram tags
    base_count_tags: bool = True
    #: duplex-stage ac/bc per-strand consensus call string tags
    duplex_strand_tags: bool = True
    #: library chemistry: bisulfite | emseq | none
    chemistry: str = "bisulfite"
    #: fused methylation extraction: off | bedmethyl | cx | both
    methyl: str = "off"
    methyl_out: str = ""
    #: stop after the molecular stage (no duplex pairing)
    single_strand: bool = False
    molecular: ConsensusParams = dataclasses.field(
        default_factory=lambda: ConsensusParams(min_reads=1)
    )
    duplex: ConsensusParams = dataclasses.field(
        default_factory=lambda: ConsensusParams(min_reads=0)
    )

    def __post_init__(self) -> None:
        check_backend(self.backend)

    @property
    def genome_fasta(self) -> str:
        return os.path.join(self.genome_dir, self.genome_fasta_file_name)

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "FrameworkConfig":
        try:
            import yaml
        except ImportError as exc:
            raise WorkflowError(
                f"reading {path} needs PyYAML, which is not installed "
                f"({exc}); build a FrameworkConfig in code instead"
            ) from None
        with open(path) as fh:
            raw = yaml.safe_load(fh) or {}
        raw.update(overrides)
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in ("molecular", "duplex"):
                continue
            if f.name in raw:
                kw[f.name] = raw[f.name]
        cfg = cls(**kw)
        for side in ("molecular", "duplex"):
            if side in raw:
                base = getattr(cfg, side)
                setattr(cfg, side, base.replace(**raw[side]))
        return cfg
