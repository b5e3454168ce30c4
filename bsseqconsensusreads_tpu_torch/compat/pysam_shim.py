"""Minimal pysam-compatible module over the port's io stack.

The port's copy of the JAX package's compat/pysam_shim.py, built on the
port's io.bam and io.fasta: the reference's pysam scripts run unchanged
against the port's BAM reader and writer and FASTA fetch.

Covers exactly the API surface the reference's two tools use
(tools/1.convert_AG_to_CT.py, tools/2.extend_gap.py):

* ``AlignmentFile(path, 'rb')`` — iterate ``AlignedSegment``s, ``.header``,
  ``get_reference_name``, context manager, ``close``;
* ``AlignmentFile(path, 'wb', template=... | header=...)`` — ``write``;
* ``AlignedSegment`` — flag / pos / reference_start / reference_id /
  reference_end / query_name / query_sequence / seq / qual /
  query_qualities / cigartuples / get_tag / set_tag / has_tag, with
  pysam's mutation semantics (assigning a sequence clears the stored
  qualities — tools/2.extend_gap.py depends on restoring them afterwards
  via ``.qual = ...``);
* ``FastaFile.fetch(name, start, end)`` with pysam's end-clamping;
* CIGAR op constants and a ``bcftools`` placeholder
  (tools/1.convert_AG_to_CT.py imports it and never uses it).

This is NOT a general pysam replacement; unsupported attributes raise
AttributeError so a parity test can never silently diverge.
"""

from __future__ import annotations

import sys
import types

from bsseqconsensusreads_tpu_torch.io import fasta as _fasta
from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamReader, BamRecord, BamWriter

# pysam/htslib CIGAR op codes
CMATCH = 0
CINS = 1
CDEL = 2
CREF_SKIP = 3
CSOFT_CLIP = 4
CHARD_CLIP = 5
CPAD = 6
CEQUAL = 7
CDIFF = 8

_REF_CONSUMING = {CMATCH, CDEL, CREF_SKIP, CEQUAL, CDIFF}


class AlignedSegment:
    """Mutable record view with pysam attribute names and semantics."""

    def __init__(self, rec: BamRecord | None = None):
        rec = rec if rec is not None else BamRecord()
        self.query_name = rec.qname
        self.flag = rec.flag
        self.reference_id = rec.ref_id
        self.reference_start = rec.pos
        self.mapping_quality = rec.mapq
        self.next_reference_id = rec.next_ref_id
        self.next_reference_start = rec.next_pos
        self.template_length = rec.tlen
        self._seq = rec.seq or ""
        # BAM stores raw phred; pysam exposes them as an int sequence
        self._quals: list[int] | None = list(rec.qual) if rec.qual else None
        self._cigar = list(rec.cigar) if rec.cigar else []
        self._tags = dict(rec.tags)

    # --- positions ---------------------------------------------------------

    @property
    def pos(self) -> int:
        return self.reference_start

    @pos.setter
    def pos(self, value: int) -> None:
        self.reference_start = value

    @property
    def reference_end(self):
        if self.reference_start < 0 or not self._cigar:
            return None
        span = sum(n for op, n in self._cigar if op in _REF_CONSUMING)
        return self.reference_start + span

    # --- sequence / qualities ---------------------------------------------

    @property
    def query_sequence(self) -> str:
        return self._seq

    @query_sequence.setter
    def query_sequence(self, value) -> None:
        # pysam semantics: assigning a sequence invalidates the stored
        # qualities (the caller must re-assign them)
        self._seq = value or ""
        self._quals = None

    @property
    def seq(self) -> str:
        return self._seq

    @seq.setter
    def seq(self, value) -> None:
        self.query_sequence = value

    @property
    def query_qualities(self):
        return self._quals

    @query_qualities.setter
    def query_qualities(self, value) -> None:
        self._quals = None if value is None else [int(q) for q in value]

    @property
    def qual(self):
        """Phred+33 string view (legacy pysam accessor the tools use)."""
        if self._quals is None:
            return None
        return "".join(chr(q + 33) for q in self._quals)

    @qual.setter
    def qual(self, value) -> None:
        self._quals = None if value is None else [ord(c) - 33 for c in value]

    # --- cigar -------------------------------------------------------------

    @property
    def cigartuples(self):
        return self._cigar if self._cigar else None

    @cigartuples.setter
    def cigartuples(self, value) -> None:
        self._cigar = [(int(op), int(n)) for op, n in value] if value else []

    @property
    def cigar(self):
        """Legacy pysam alias (tools/1.convert_AG_to_CT.py:181 assigns it)."""
        return self.cigartuples

    @cigar.setter
    def cigar(self, value) -> None:
        self.cigartuples = value

    # --- tags --------------------------------------------------------------

    def get_tag(self, name: str):
        return self._tags[name][1]

    def has_tag(self, name: str) -> bool:
        return name in self._tags

    def set_tag(self, name: str, value, value_type: str = "i") -> None:
        if value is None:
            self._tags.pop(name, None)
            return
        if value_type == "i":
            value = int(value)
        self._tags[name] = (value_type, value)

    # --- conversion --------------------------------------------------------

    def to_record(self) -> BamRecord:
        quals = self._quals
        if quals is None:
            # BAM convention for absent qualities: 0xFF fill
            qual_bytes = bytes([0xFF] * len(self._seq))
        else:
            qual_bytes = bytes(int(q) & 0xFF for q in quals)
        return BamRecord(
            qname=self.query_name,
            flag=self.flag,
            ref_id=self.reference_id,
            pos=self.reference_start,
            mapq=self.mapping_quality,
            cigar=list(self._cigar),
            next_ref_id=self.next_reference_id,
            next_pos=self.next_reference_start,
            tlen=self.template_length,
            seq=self._seq,
            qual=qual_bytes,
            tags=dict(self._tags),
        )


class AlignmentFile:
    def __init__(self, path: str, mode: str = "rb", template=None, header=None):
        self._path = path
        self._mode = mode
        if mode == "rb":
            self._reader = BamReader(path)
            self.header = self._reader.header
            self._writer = None
        elif mode == "wb":
            if header is None and template is not None:
                header = template.header
            if header is None:
                raise ValueError("AlignmentFile('wb') needs template= or header=")
            if not isinstance(header, BamHeader):
                raise TypeError(f"unsupported header object {type(header)!r}")
            self.header = header
            self._writer = BamWriter(path, header)
            self._reader = None
        else:
            raise ValueError(f"unsupported mode {mode!r}")

    def __iter__(self):
        for rec in self._reader:
            yield AlignedSegment(rec)

    def get_reference_name(self, rid: int) -> str:
        return self.header.ref_name(rid)

    def write(self, seg: AlignedSegment) -> None:
        self._writer.write(seg.to_record())

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
        if self._writer is not None:
            self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FastaFile:
    def __init__(self, path: str):
        self._fa = _fasta.FastaFile(path)

    def fetch(self, reference: str, start: int = 0, end: int | None = None) -> str:
        # first-party fetch already clamps end past the contig like pysam
        return self._fa.fetch(reference, start, end)

    @property
    def references(self):
        return self._fa.references

    def close(self) -> None:
        self._fa.close()


def build_module() -> types.ModuleType:
    """A module object that quacks like ``pysam`` for the reference tools."""
    mod = types.ModuleType("pysam")
    mod.AlignmentFile = AlignmentFile
    mod.AlignedSegment = AlignedSegment
    mod.FastaFile = FastaFile
    for name in (
        "CMATCH", "CINS", "CDEL", "CREF_SKIP", "CSOFT_CLIP", "CHARD_CLIP",
        "CPAD", "CEQUAL", "CDIFF",
    ):
        setattr(mod, name, globals()[name])
    # imported (never used) by tools/1.convert_AG_to_CT.py
    mod.bcftools = types.ModuleType("pysam.bcftools")
    return mod


def install_shim() -> types.ModuleType:
    """Register the shim as ``pysam`` (and ``rich_click`` -> click, which is
    API-compatible for the decorators the tools use) in sys.modules.
    No-op when a real pysam is importable (installed OR already imported) —
    never shadow a real installation process-wide."""
    if "pysam" not in sys.modules:
        import importlib.util

        if importlib.util.find_spec("pysam") is None:
            mod = build_module()
            sys.modules["pysam"] = mod
            sys.modules["pysam.bcftools"] = mod.bcftools
        else:
            import pysam  # noqa: F401  (real installation wins)
    if "rich_click" not in sys.modules:
        try:
            import rich_click  # noqa: F401
        except ImportError:
            import click

            sys.modules["rich_click"] = click
    return sys.modules["pysam"]
