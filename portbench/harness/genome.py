"""The cell's genome, made from the seed: random A/C/G/T contigs of the
configuration's lengths, drawn on the device in one call per contig and
copied to the host once (the program reads both copies: its wire
gathers windows from the device, its host phases from the host)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Genome:
    names: list
    lengths: np.ndarray  # int64 [contigs]
    offsets: np.ndarray  # int64 [contigs]: first base of each contig in `codes`
    codes: np.ndarray  # int8 [total], A C G T = 0..3

    def contig(self, ref_id: int) -> np.ndarray:
        o = int(self.offsets[ref_id])
        return self.codes[o:o + int(self.lengths[ref_id])]

    def fetch_str(self, name: str, start: int, end: int) -> str:
        """FastaFile.fetch's contract over the codes: [start, end) of a
        contig, clipped to it."""
        rid = self.names.index(name)
        seq = self.contig(rid)[max(start, 0):max(end, 0)]
        return np.frombuffer(b"ACGTN", np.uint8)[seq].tobytes().decode()


def make_genome(torch, lengths, seed: int, device: str) -> Genome:
    """Contigs chr-named 1..n of `lengths`, from a generator on `device`
    seeded with `seed`; the host copy is returned (the device copy is
    freed: the program uploads its own)."""
    lengths = np.asarray(lengths, np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])[:-1]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    host = torch.empty(int(lengths.sum()), dtype=torch.int8)
    for o, n in zip(offsets, lengths):
        part = torch.randint(0, 4, (int(n),), generator=gen, device=device, dtype=torch.int8)
        host[int(o):int(o + n)].copy_(part)
        del part
    names = [f"chr{i}" for i in range(1, len(lengths) + 1)]
    return Genome(names, lengths, offsets, host.numpy())
