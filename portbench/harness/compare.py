"""What decides `correct`: the records the timed path wrote for a sample
of families (drawn from the seed in set-up, the deepest family among
them), against the plain reference's records of the same families, field
by field, plus the records each output holds in all.

Numbers (each held to its limit in portbench/limits/<cell>.json):
  records_missing     reference records with no program record of the same
                      name and flag, program records of the sampled families
                      the reference lacks, and the difference between each
                      output's record count and the pass's expected count
  base_mismatch_ppm   consensus bases that differ, per million compared
  qual_mismatch_ppm   base qualities that differ, per million compared
  tag_mismatch_ppm    tag values (each element of an array tag, each letter
                      of ac/bc) and record fields that differ, per million
                      compared; a record whose placement differs counts all
                      of its values as differing
"""

from __future__ import annotations

import numpy as np

from harness import bamio

PLACEMENT = ("ref_id", "pos", "mapq", "cigar", "next_ref_id", "next_pos", "tlen")


def _values(v) -> int:
    if isinstance(v, np.ndarray):
        return int(v.size)
    if isinstance(v, str):
        return max(len(v), 1)
    return 1


def _tag_diffs(a, b) -> int:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return max(a.size, b.size)
        return int((a != b).sum())
    if isinstance(a, str) and isinstance(b, str) and len(a) == len(b) and len(a) > 1:
        return sum(x != y for x, y in zip(a, b))
    if isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        return int(np.float32(a) != np.float32(b))
    return int(a != b) * max(_values(a), _values(b))


class Tally:
    def __init__(self):
        self.missing = 0
        self.bases = self.base_diff = 0
        self.quals = self.qual_diff = 0
        self.tags = self.tag_diff = 0

    def record(self, got: dict | None, want: dict | None) -> None:
        if got is None or want is None:
            self.missing += 1
            return
        n = len(want["seq"])
        self.bases += n
        self.quals += n
        ntag = len(PLACEMENT) + sum(_values(v) for v in want["tags"].values())
        self.tags += ntag
        if any(got[k] != want[k] for k in PLACEMENT) or len(got["seq"]) != n:
            self.base_diff += n
            self.qual_diff += n
            self.tag_diff += ntag
            return
        self.base_diff += sum(x != y for x, y in zip(got["seq"], want["seq"]))
        self.qual_diff += int((np.frombuffer(got["qual"], np.uint8)
                               != np.frombuffer(want["qual"], np.uint8)).sum())
        for key in set(got["tags"]) | set(want["tags"]):
            if key not in got["tags"] or key not in want["tags"]:
                self.tag_diff += _values(got["tags"].get(key, want["tags"].get(key)))
            else:
                self.tag_diff += _tag_diffs(got["tags"][key], want["tags"][key])

    def numbers(self) -> dict:
        def ppm(d, n):
            return 1e6 * d / n if n else 0.0
        return {"records_missing": float(self.missing),
                "base_mismatch_ppm": ppm(self.base_diff, self.bases),
                "qual_mismatch_ppm": ppm(self.qual_diff, self.quals),
                "tag_mismatch_ppm": ppm(self.tag_diff, self.tags)}


def compare_records(tally: Tally, got: list, want: list) -> None:
    """Match by (name, flag) and tally every field."""
    g = {(r["qname"], r["flag"]): r for r in got}
    w = {(r["qname"], r["flag"]): r for r in want}
    for key in set(g) | set(w):
        tally.record(g.get(key), w.get(key))


def program_records(path: str, wanted) -> tuple[int, dict]:
    """(records in the BAM, {qname: [decoded records]} for names in
    `wanted`)."""
    buf = bamio.inflate_bgzf(path)
    start, _refs = bamio.read_header(buf)
    offs = bamio.record_offsets(buf, start)
    found: dict = {}
    for off in offs:
        name = bamio.record_name(buf, off)
        if name in wanted:
            found.setdefault(name, []).append(bamio.decode_record(buf, off))
    return len(offs), found
