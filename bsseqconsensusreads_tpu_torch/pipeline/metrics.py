"""Duplex library QC metrics — fgbio CollectDuplexSeqMetrics equivalent.

The port's copy of the JAX package's pipeline/metrics.py; the `metrics`
subcommand feeds it the native columnar views (pipeline.ingest
.columnar_records), which carry the qname and MI it reads.

Run right after UMI grouping, these metrics answer the questions every
duplex experiment starts with: how deep are the UMI families, what
fraction of molecules yielded both strands (the precondition for a
duplex consensus at all — the reference's whole pipeline exists to
combine /A with /B, reference README.md:1-9), and how much raw
sequencing went into each duplex. Computed from the published semantics
of fgbio's CollectDuplexSeqMetrics family-size tables:

* family_sizes     — histogram over molecules of total template count
                     ("DS" double-strand families)
* strand_sizes     — histogram over single-strand families (/A or /B
                     members separately, "SS")
* ab_ba_sizes      — histogram over molecules of (larger strand,
                     smaller strand) template-count pairs
* duplex_yield     — molecules with >=1 template on BOTH strands, plus
                     the stricter >=2/>=1 tier fgbio reports (ds_duplex
                     vs ds_fraction_duplex_ideal)

One bounded pass over an MI-grouped stream (GroupReadsByUmi output —
this framework's pipeline.group_umi or fgbio's own); molecules are
delimited by MI-base change, templates counted as distinct qnames.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

from bsseqconsensusreads_tpu_torch.io.bam import BamRecord


@dataclass
class DuplexMetrics:
    """Accumulated metrics; `as_dict()` is the JSON the CLI emits."""

    records: int = 0
    molecules: int = 0
    single_strand_families: int = 0
    #: molecules with >=1 template on both strands
    duplexes: int = 0
    #: molecules meeting fgbio's ideal-duplex tier: >=2 templates on the
    #: deeper strand and >=1 on the other
    duplexes_2_1: int = 0
    family_sizes: dict = field(default_factory=dict)
    strand_sizes: dict = field(default_factory=dict)
    ab_ba_sizes: dict = field(default_factory=dict)

    def _bump(self, hist: dict, key) -> None:
        hist[key] = hist.get(key, 0) + 1

    def add_molecule(self, strand_templates: dict) -> None:
        """Fold in one molecule: {strand -> set of qnames}."""
        counts = sorted(
            (len(q) for q in strand_templates.values()), reverse=True
        )
        total = sum(counts)
        if total == 0:
            return
        self.molecules += 1
        self._bump(self.family_sizes, total)
        for c in counts:
            if c:
                self.single_strand_families += 1
                self._bump(self.strand_sizes, c)
        ab = counts[0]
        ba = counts[1] if len(counts) > 1 else 0
        self._bump(self.ab_ba_sizes, f"{ab},{ba}")
        if ba >= 1:
            self.duplexes += 1
            if ab >= 2:
                self.duplexes_2_1 += 1

    def as_dict(self) -> dict:
        total_templates = sum(k * v for k, v in self.family_sizes.items())
        return {
            "records": self.records,
            "molecules": self.molecules,
            "templates": total_templates,
            "single_strand_families": self.single_strand_families,
            "duplexes": self.duplexes,
            "duplexes_2_1": self.duplexes_2_1,
            "duplex_fraction": (
                round(self.duplexes / self.molecules, 5) if self.molecules else 0.0
            ),
            "mean_family_size": (
                round(total_templates / self.molecules, 3) if self.molecules else 0.0
            ),
            "family_sizes": {
                str(k): v for k, v in sorted(self.family_sizes.items())
            },
            "strand_sizes": {
                str(k): v for k, v in sorted(self.strand_sizes.items())
            },
            "ab_ba_sizes": dict(sorted(self.ab_ba_sizes.items())),
        }


def duplex_seq_metrics(records: Iterable[BamRecord]) -> DuplexMetrics:
    """One streaming pass over MI-grouped records (molecules contiguous by
    MI base id, the GroupReadsByUmi output contract). Molecule delimiting
    and the missing-MI error contract belong to
    pipeline.calling.stream_mi_groups ('adjacent' mode, suffix-stripped);
    this only partitions each molecule's records by strand suffix."""
    from bsseqconsensusreads_tpu_torch.pipeline.calling import stream_mi_groups

    m = DuplexMetrics()
    for _base, group in stream_mi_groups(
        records, strip_suffix=True, grouping="adjacent"
    ):
        strands: dict[str, set] = {}
        for rec in group:
            m.records += 1
            _, _, strand = str(rec.get_tag("MI")).partition("/")
            strands.setdefault(strand or "A", set()).add(rec.qname)
        m.add_molecule(strands)
    return m
