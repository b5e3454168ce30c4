"""SAM text format interop.

The port's copy of the JAX package's io/sam.py. Needed where the
reference pipes `bwameth … | samtools view -h -b` (main.snake.py:93,188):
bwameth emits SAM on stdout; this module converts the text stream to
BamRecords (and back, for debugging/interop).
"""

from __future__ import annotations

from typing import Iterable, Iterator, TextIO

from bsseqconsensusreads_tpu_torch.io.bam import (
    CIGAR_OPS,
    BamHeader,
    BamRecord,
)

_OP_OF = {c: i for i, c in enumerate(CIGAR_OPS)}
_TAG_CAST = {"i": int, "f": float, "A": str, "Z": str, "H": str}
_B_CAST = {"c": int, "C": int, "s": int, "S": int, "i": int, "I": int, "f": float}


def parse_cigar(text: str) -> list[tuple[int, int]]:
    if text == "*":
        return []
    out = []
    n = 0
    for ch in text:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            out.append((_OP_OF[ch], n))
            n = 0
    return out


def _parse_tag(field: str) -> tuple[str, tuple]:
    key, tc, val = field.split(":", 2)
    if tc == "B":
        sub = val[0]
        vals = [_B_CAST[sub](v) for v in val[1:].split(",") if v]
        return key, ("B", (sub, vals))
    return key, (tc, _TAG_CAST[tc](val))


def parse_sam_line(line: str, header: BamHeader) -> BamRecord:
    f = line.rstrip("\n").split("\t")
    qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq, qual = f[:11]
    rec = BamRecord(
        qname=qname,
        flag=int(flag),
        ref_id=header.ref_id(rname) if rname != "*" else -1,
        pos=int(pos) - 1,
        mapq=int(mapq),
        cigar=parse_cigar(cigar),
        next_ref_id=(
            header.ref_id(rnext)
            if rnext not in ("*", "=")
            else (header.ref_id(rname) if rnext == "=" else -1)
        ),
        next_pos=int(pnext) - 1,
        tlen=int(tlen),
        seq="" if seq == "*" else seq,
        qual=None if qual == "*" else bytes(ord(c) - 33 for c in qual),
    )
    for field in f[11:]:
        key, tv = _parse_tag(field)
        rec.tags[key] = tv
    return rec


def read_sam(stream: TextIO) -> tuple[BamHeader, Iterator[BamRecord]]:
    """Parse a SAM text stream; returns (header, record iterator)."""
    header_lines: list[str] = []
    refs: list[tuple[str, int]] = []
    first_record: str | None = None
    for line in stream:
        if line.startswith("@"):
            header_lines.append(line)
            if line.startswith("@SQ"):
                name, ln = "", 0
                for part in line.rstrip("\n").split("\t")[1:]:
                    if part.startswith("SN:"):
                        name = part[3:]
                    elif part.startswith("LN:"):
                        ln = int(part[3:])
                refs.append((name, ln))
        else:
            first_record = line
            break
    header = BamHeader("".join(header_lines), refs)

    def records() -> Iterator[BamRecord]:
        if first_record is not None and first_record.strip():
            yield parse_sam_line(first_record, header)
        for line in stream:
            if line.strip():
                yield parse_sam_line(line, header)

    return header, records()


def format_sam_record(rec: BamRecord, header: BamHeader) -> str:
    qual = "*" if rec.qual is None else "".join(chr(min(q, 93) + 33) for q in rec.qual)
    fields = [
        rec.qname,
        str(rec.flag),
        header.ref_name(rec.ref_id),
        str(rec.pos + 1),
        str(rec.mapq),
        rec.cigar_string(),
        header.ref_name(rec.next_ref_id) if rec.next_ref_id != rec.ref_id or rec.ref_id < 0 else "=",
        str(rec.next_pos + 1),
        str(rec.tlen),
        rec.seq or "*",
        qual,
    ]
    for key, (tc, val) in rec.tags.items():
        if tc == "B":
            sub, vals = val
            fields.append(f"{key}:B:{sub}," + ",".join(str(v) for v in vals))
        else:
            fields.append(f"{key}:{tc}:{val}")
    return "\t".join(fields)


def write_sam(records: Iterable[BamRecord], header: BamHeader, stream: TextIO) -> None:
    if header.text:
        stream.write(header.text if header.text.endswith("\n") else header.text + "\n")
    for name, length in header.references:
        if f"SN:{name}" not in header.text:
            stream.write(f"@SQ\tSN:{name}\tLN:{length}\n")
    for rec in records:
        stream.write(format_sam_record(rec, header) + "\n")
