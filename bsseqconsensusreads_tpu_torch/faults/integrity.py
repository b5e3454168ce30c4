"""Durable-state integrity: streaming CRC32 over files.

The port's copy of the JAX package's faults/integrity.py. Checkpoint
shards (pipeline.checkpoint) are the run's durable state — a corrupt one
must be detected and quarantined/recomputed, never spliced silently into
the output (BGZF's per-block CRC catches in-block corruption at inflate
time, but not a truncated tail, a zero-filled page, or a swapped file).
The CRC is over the raw file bytes, so it also pins the exact container
framing the manifest registered. Each mismatch is ledgered as
'integrity_mismatch' and raised as IntegrityError.
"""

from __future__ import annotations

import os
import zlib

from bsseqconsensusreads_tpu_torch.utils import observe

_CHUNK = 1 << 20


class IntegrityError(OSError):
    """A durable artifact failed its recorded CRC (or is missing)."""


def file_crc32(path: str) -> int:
    """CRC32 (unsigned) over the file's raw bytes, streaming."""
    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def verify_file_crc32(path: str, expected: int, what: str = "") -> None:
    """Raise IntegrityError (ledgered as 'integrity_mismatch') when the
    file's bytes no longer match the recorded CRC, or the file is gone."""
    label = what or os.path.basename(path)
    try:
        actual = file_crc32(path)
    except OSError as exc:
        observe.emit("integrity_mismatch", {"path": path, "what": label, "error": str(exc)})
        raise IntegrityError(f"{label}: unreadable: {exc}") from exc
    if actual != expected:
        observe.emit("integrity_mismatch", {"path": path, "what": label,
                                            "expected_crc": expected, "actual_crc": actual})
        raise IntegrityError(
            f"{label}: CRC mismatch (expected {expected:#010x}, "
            f"got {actual:#010x})"
        )
