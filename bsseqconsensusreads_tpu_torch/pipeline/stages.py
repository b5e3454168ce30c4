"""Stage ingest: which record engine feeds a consensus stage.

The ingest part of the JAX package's pipeline/stages.py (its
ingest_records / molecular_ingest_stream / duplex_ingest_stream, without
the input-guard branches). The pipeline runner of that module
(PipelineBuilder, run_pipeline) is a later slice of the port.

Engines are resolved by what the stage can take, never by what happens
to be built: 'auto' is the native columnar decoder with C-side MI
grouping and the C encode scan wherever the stage can take it, and the
Python BamReader only where it cannot (grouping 'gather', which would
pin every columnar batch for the whole file). 'native' where the stage
cannot take it raises, and a native library that does not build raises
io._nativelib.NativeLibraryError — nothing falls back to Python.
'python' stays selectable by name: it is the parity twin.
"""

from __future__ import annotations

from bsseqconsensusreads_tpu_torch.pipeline.calling import StageStats

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
