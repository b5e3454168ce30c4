"""Durable-state integrity: streaming CRC32 over files.

The port's copy of the JAX package's faults/integrity.py. Checkpoint
shards (pipeline.checkpoint) are the run's durable state — a corrupt one
must be detected and quarantined/recomputed, never spliced silently into
the output (BGZF's per-block CRC catches in-block corruption at inflate
time, but not a truncated tail, a zero-filled page, or a swapped file).
The CRC is over the raw file bytes, so it also pins the exact container
framing the manifest registered. The JAX module ledgers each mismatch as
'integrity_mismatch'; the port has no ledger yet (ROADMAP queue 1, item
9), and the raised IntegrityError carries the same facts.
"""

from __future__ import annotations

import os
import zlib

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
    """Raise IntegrityError when the file's bytes no longer match the
    recorded CRC, or the file is gone."""
    label = what or os.path.basename(path)
    try:
        actual = file_crc32(path)
    except OSError as exc:
        raise IntegrityError(f"{label}: unreadable: {exc}") from exc
    if actual != expected:
        raise IntegrityError(
            f"{label}: CRC mismatch (expected {expected:#010x}, "
            f"got {actual:#010x})"
        )
