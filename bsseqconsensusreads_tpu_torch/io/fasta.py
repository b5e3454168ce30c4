"""Indexed FASTA reader — replacement for pysam.FastaFile.

The reference fetches per-read reference windows during B-strand conversion
(reference: tools/1.convert_AG_to_CT.py:35,107). This reader supports .fai
faidx indexes (building one on the fly when absent) and random-access fetch.
"""

from __future__ import annotations

import os


class FastaError(IOError):
    pass


class FastaFile:
    """Random-access FASTA with faidx semantics.

    fetch(name, start, end) returns the [start, end) slice (0-based,
    end-exclusive), clamped to the sequence length — matching
    pysam.FastaFile.fetch used by the reference.
    """

    def __init__(self, path: str):
        self._path = path
        self._fh = open(path, "rb")
        fai = path + ".fai"
        if os.path.exists(fai):
            self._index = self._load_fai(fai)
        else:
            self._index = self._build_index()
            try:
                self._save_fai(fai)
            except OSError:
                pass  # read-only dir: index stays in-memory

    @staticmethod
    def _load_fai(path: str) -> dict[str, tuple[int, int, int, int]]:
        index: dict[str, tuple[int, int, int, int]] = {}
        with open(path) as fh:
            for line in fh:
                name, length, offset, linebases, linewidth = line.rstrip("\n").split("\t")[:5]
                index[name] = (int(length), int(offset), int(linebases), int(linewidth))
        return index

    def _save_fai(self, path: str) -> None:
        with open(path, "w") as fh:
            for name, (length, offset, linebases, linewidth) in self._index.items():
                fh.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")

    def _build_index(self) -> dict[str, tuple[int, int, int, int]]:
        index: dict[str, tuple[int, int, int, int]] = {}
        self._fh.seek(0)
        name = None
        length = offset = linebases = linewidth = 0
        blank_seen = False
        pos = 0
        for raw in self._fh:
            line_len = len(raw)
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    index[name] = (length, offset, linebases, linewidth)
                name = line[1:].split()[0].decode("ascii") if len(line) > 1 else ""
                length = linebases = linewidth = 0
                blank_seen = False
                offset = pos + line_len
            elif not line:
                blank_seen = True
            elif name is not None:
                if blank_seen:
                    # A blank line inside a sequence body breaks the
                    # offset arithmetic; refuse like samtools faidx.
                    raise FastaError(
                        f"{self._path}: blank line inside sequence {name!r}"
                    )
                if linebases == 0:
                    linebases = len(line)
                    linewidth = line_len
                elif length % linebases != 0:
                    # The previous line was short but not final: offsets would
                    # be wrong from here on. samtools faidx rejects this too.
                    raise FastaError(
                        f"{self._path}: non-uniform line length in sequence {name!r}"
                    )
                elif len(line) > linebases:
                    raise FastaError(
                        f"{self._path}: line longer than first line in sequence {name!r}"
                    )
                length += len(line)
            pos += line_len
        if name is not None:
            index[name] = (length, offset, linebases, linewidth)
        if not index:
            raise FastaError(f"{self._path}: no sequences found")
        return index

    @property
    def references(self) -> list[str]:
        return list(self._index)

    def get_reference_length(self, name: str) -> int:
        return self._index[name][0]

    def span(self, name: str) -> tuple[int, int, int]:
        """(length, file offset of the first base, bytes from it through
        the last base) of sequence `name`: its whole body, line ends
        included, as fetch(name) reads it."""
        length, offset, linebases, linewidth = self._index[name]
        if length == 0:
            return 0, offset, 0
        last = ((length - 1) // linebases) * linewidth + (length - 1) % linebases
        return length, offset, last + 1

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> str:
        if name not in self._index:
            raise KeyError(name)
        length, offset, linebases, linewidth = self._index[name]
        if end is None or end > length:
            end = length
        start = max(start, 0)
        if start >= end:
            return ""
        # File offset of base i: offset + (i // linebases) * linewidth + i % linebases
        first = offset + (start // linebases) * linewidth + start % linebases
        last = offset + ((end - 1) // linebases) * linewidth + (end - 1) % linebases
        self._fh.seek(first)
        raw = self._fh.read(last - first + 1)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "FastaFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
