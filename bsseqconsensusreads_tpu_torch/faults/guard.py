"""The typed input errors the port's BAM codec raises.

A copy of the error taxonomy of the JAX package's faults/guard.py — only
the classes, the record-body check and the stream-error classification
that io.bgzf / io.bam / io.native take. The guard's policies (quarantine,
lenient repair, family admission) and the vectorized ColumnarBatch
validation are a later slice of the port.
"""

from __future__ import annotations

import struct

#: the one shared reason string for a record whose declared field
#: lengths cannot fit its block size
REASON_RECORD_CORRUPT = "corrupt record body (field/length mismatch)"


class GuardError(Exception):
    """Base of every typed input error: any failure caused by input bytes
    is an instance of this (or a subclass)."""

    reason: str = "guard"


class StreamGuardError(GuardError, IOError):
    """Stream-level corruption or truncation (BGZF framing, BAM record
    framing, header). IOError ancestry keeps callers that catch IOError
    working."""

    def __init__(self, message: str, reason: str | None = None,
                 record_index: int | None = None,
                 voffset: int | None = None):
        where = []
        if record_index is not None:
            where.append(f"record #{record_index}")
        if voffset is not None:
            where.append(f"block @{voffset}")
        if where:
            message = f"{message} ({' in '.join(where)})"
        super().__init__(message)
        self.reason = reason or canonical_reason(message)
        self.record_index = record_index
        self.voffset = voffset


class RecordGuardError(GuardError, ValueError):
    """One record failed semantic validation."""

    def __init__(self, message: str, reason: str,
                 record_index: int | None = None,
                 qname: str | None = None):
        where = []
        if record_index is not None:
            where.append(f"record #{record_index}")
        if qname:
            where.append(f"qname {qname!r}")
        if where:
            message = f"{message} ({', '.join(where)})"
        super().__init__(message)
        self.reason = reason
        self.record_index = record_index
        self.qname = qname


class MissingTagError(RecordGuardError):
    """Record without the MI tag the grouping contract requires. Message
    matches the reference's ValueError byte-for-byte
    (tools/2.extend_gap.py:180)."""

    def __init__(self, qname: str):
        ValueError.__init__(self, f"{qname} does not have MI tag.")
        self.reason = "missing-mi"
        self.record_index = None
        self.qname = qname


class InputChangedError(GuardError, RuntimeError):
    """Checkpoint resume refused: the input BAM changed (size/mtime)
    since the manifest was written — resuming would splice consensus
    from two different inputs (pipeline.checkpoint)."""

    def __init__(self, target: str, manifest_fp: dict, run_fp: dict):
        super().__init__(
            f"checkpoint for {target} was computed from a different "
            f"input (manifest {manifest_fp} != current {run_fp}); "
            "refusing to splice consensus from two inputs — delete the "
            f"manifest ({target}.ckpt.json) to recompute from scratch"
        )
        self.reason = "input-changed"
        self.manifest_fingerprint = manifest_fp
        self.run_fingerprint = run_fp


#: ordered (substring, canonical reason) table — first match wins
_CANONICAL = (
    ("corrupt record body", "record-corrupt"),
    ("corrupt record size", "record-corrupt"),
    ("corrupt record tags", "record-corrupt"),
    ("corrupt record qname", "record-corrupt"),
    ("truncated record", "record-truncated"),
    ("truncated BAM record", "record-truncated"),
    ("does not have MI tag", "missing-mi"),
    ("CRC mismatch", "bgzf-corrupt"),
    ("ISIZE mismatch", "bgzf-corrupt"),
    ("inflate failed", "bgzf-corrupt"),
    ("corrupt BGZF", "bgzf-corrupt"),
    ("not a BGZF stream", "bgzf-corrupt"),
    ("missing BC extra subfield", "bgzf-corrupt"),
    ("truncated BGZF", "bgzf-truncated"),
    ("EOF marker missing", "bgzf-truncated"),
    ("corrupt BAM header", "header-corrupt"),
    ("not a BAM file", "not-bam"),
)


def canonical_reason(message: str) -> str:
    for needle, reason in _CANONICAL:
        if needle in message:
            return reason
    return "stream-error"


def classify_stream_error(
    message: str, record_index: int | None = None,
    voffset: int | None = None,
) -> StreamGuardError:
    """Wrap a decode-path error message (the Python codec's wording or the
    native codec's) into the typed stream error both engines share."""
    return StreamGuardError(
        message, reason=canonical_reason(message),
        record_index=record_index, voffset=voffset,
    )


_N_CIGAR = struct.Struct("<H")


def check_record_body(data: bytes) -> str | None:
    """Reason string when a record body's declared field lengths cannot
    fit its block size, else None. `data` is the record body WITHOUT its
    leading block_size prefix."""
    bs = len(data)
    if bs < 32:
        return REASON_RECORD_CORRUPT
    l_qname = data[8]
    (n_cigar,) = _N_CIGAR.unpack_from(data, 12)
    (l_seq,) = struct.unpack_from("<i", data, 16)
    if l_qname < 1 or l_seq < 0:
        return REASON_RECORD_CORRUPT
    need = 32 + l_qname + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
    if need > bs:
        return REASON_RECORD_CORRUPT
    return None
