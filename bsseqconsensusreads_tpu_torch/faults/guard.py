"""The input guard: untrusted-input hardening for the ingest path.

The port's copy of the JAX package's faults/guard.py, whole: the typed
error taxonomy, the policies, record-level semantic validation
(`record_violation`, vectorized over a columnar batch in
`batch_violations`), lenient repair, family-level admission control
(`guard_groups`) and the `Guard` with its lazy quarantine sidecar. On
the same input and policy the port refuses, quarantines and repairs the
same records as the JAX package, with the same reasons, counters and
sidecar bytes (tests/test_torch_guard.py).

One policy knob (``BSSEQ_TPU_INPUT_POLICY``):

* **strict** (default) — fail fast with a precise typed error
  (`record #N`, BGZF voffset where known). Nothing is ever silently
  dropped or repaired. The CLI exits 3 with one `input error [<reason>]`
  line.
* **quarantine** — the offending record (or whole family, for
  family-level violations) is written to a sidecar
  ``<input>.quarantined.bam`` with a ``qr:Z:<reason>`` tag, counters
  land in StageStats, and the run continues. Stream-level corruption
  resyncs to the next valid BGZF block (io.bgzf) and the next plausible
  record boundary (io.bam.GuardedBamReader).
* **lenient** — quarantine plus the provably safe repair: out-of-range
  quals clamped to the Phred-93 emit ceiling (``record_repaired``).
* **off** — no guard; on well-formed input every policy writes the
  same bytes.

Caps: ``BSSEQ_TPU_MAX_FAMILY_RECORDS`` (2**20),
``BSSEQ_TPU_MAX_READ_LEN`` (2**16); ``BSSEQ_TPU_GUARD_EVENT_CAP`` (100) bounds
the lines a guard prints on stderr (one per quarantined or repaired
record, quarantined family or stream gap; past the cap, one
``guard_events_truncated`` line at close).
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator

import numpy as np

from bsseqconsensusreads_tpu_torch.utils import observe

# ---------------------------------------------------------------------------
# typed error taxonomy

#: the one shared reason string for a record whose declared field
#: lengths cannot fit its block size — native/bamio.cpp raises the
#: byte-identical message (parity pinned by tests/test_guard.py)
REASON_RECORD_CORRUPT = "corrupt record body (field/length mismatch)"

#: Phred ceiling of every emitted quality (ops.phred.MAX_PHRED as int);
#: input quals above it are out of the SAM printable range.
QUAL_MAX = 93

#: sentinel the native tag extractor writes into a fixed-width MI/RX
#: slot when the tag is PRESENT but malformed — wrong type, empty, or
#: non-printable (native/bamio.cpp kTagMalformed). Distinguishes
#: "absent" ("") from "present and hostile" so the native strict path
#: refuses the same records the Python engine does.
TAG_MALFORMED = b"\x01"


class GuardError(Exception):
    """Base of every typed input-hardening error. The fuzz contract
    ('never crash') means: any failure caused by input bytes must be an
    instance of this (or a subclass) — a bare struct.error/IndexError
    escaping the ingest path is a bug."""

    reason: str = "guard"


class StreamGuardError(GuardError, IOError):
    """Stream-level corruption or truncation (BGZF framing, BAM record
    framing, header). IOError ancestry keeps existing callers that
    catch IOError working."""

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
    """One record failed semantic validation under the strict policy."""

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


class FamilyGuardError(GuardError, ValueError):
    """One MI family failed admission control under the strict policy."""

    def __init__(self, message: str, reason: str, mi: str = ""):
        super().__init__(message)
        self.reason = reason
        self.mi = mi


class MissingTagError(RecordGuardError):
    """Record without the MI tag the grouping contract requires.
    Message matches the historical ValueError byte-for-byte (reference
    parity: tools/2.extend_gap.py:180)."""

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


# ---------------------------------------------------------------------------
# error classification (python <-> native message parity)

#: ordered (substring, canonical reason) table — first match wins.
#: Python (io.bgzf / io.bam) and native (bamio.cpp) wordings both land
#: on the same canonical reason; the parity tests compare these.
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
    """Wrap a raw decode-path error message (python or native wording)
    into the typed stream error both engines share."""
    return StreamGuardError(
        message, reason=canonical_reason(message),
        record_index=record_index, voffset=voffset,
    )


# ---------------------------------------------------------------------------
# record-level structural validation (mirror of native/bamio.cpp)

_LSEQ_NCIG = struct.Struct("<H")  # n_cigar at +12; l_seq read as i32 at +16


def check_record_body(data: bytes) -> str | None:
    """Reason string when a record body's declared field lengths cannot
    fit its block size, else None. Byte-for-byte the same rule (and the
    same REASON_RECORD_CORRUPT message) as native/bamio.cpp's
    body_check — the two decode engines must refuse the same records.

    `data` is the record body WITHOUT its leading block_size prefix.
    """
    bs = len(data)
    if bs < 32:
        return REASON_RECORD_CORRUPT
    l_qname = data[8]
    (n_cigar,) = _LSEQ_NCIG.unpack_from(data, 12)
    (l_seq,) = struct.unpack_from("<i", data, 16)
    if l_qname < 1 or l_seq < 0:
        return REASON_RECORD_CORRUPT
    need = 32 + l_qname + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
    if need > bs:
        return REASON_RECORD_CORRUPT
    return None


# ---------------------------------------------------------------------------
# record-level semantic validation

#: CIGAR ops that consume query bases (M I S = X) — io.bam order.
_CONSUMES_QUERY = (1, 1, 0, 0, 1, 0, 0, 1, 1)


def _printable(s: str) -> bool:
    return all(0x21 <= ord(c) <= 0x7E for c in s)


def record_violation(
    rec, n_ref: int | None = None,
    ref_lens=None, max_read_len: int = 1 << 16,
) -> tuple[str, bool] | None:
    """(reason, repairable) for a decoded BamRecord that fails semantic
    validation, else None. `repairable` marks the violation classes the
    lenient policy may fix in place (repair_record)."""
    l_seq = len(rec.seq)
    if l_seq > max_read_len:
        return ("read-too-long", False)
    if rec.cigar and l_seq > 0:
        qlen = sum(ln for op, ln in rec.cigar if _CONSUMES_QUERY[op])
        if qlen != l_seq:
            return ("cigar-seq-mismatch", False)
    if rec.pos < -1 or rec.next_pos < -1:
        return ("pos-out-of-range", False)
    if n_ref is not None:
        if rec.ref_id < -1 or rec.ref_id >= n_ref:
            return ("ref-out-of-range", False)
        if rec.next_ref_id < -1 or rec.next_ref_id >= n_ref:
            return ("ref-out-of-range", False)
    if (
        ref_lens is not None
        and 0 <= rec.ref_id < len(ref_lens)
        and rec.pos >= ref_lens[rec.ref_id]
    ):
        return ("pos-out-of-range", False)
    for key in ("MI", "RX"):
        if rec.has_tag(key):
            v = rec.get_tag(key)
            if not isinstance(v, str) or not v or not _printable(v):
                return ("tag-shape", False)
    if rec.qual and max(rec.qual) > QUAL_MAX:
        return ("qual-out-of-range", True)
    return None


def repair_record(rec) -> str | None:
    """Apply the provably-safe lenient repairs in place; returns the
    repair reason or None. Today: clamp out-of-range quals to the
    Phred-93 emit ceiling (ordering-preserving; every emitted qual is
    capped there anyway, ops.phred.MAX_PHRED)."""
    if rec.qual and max(rec.qual) > QUAL_MAX:
        rec.qual = bytes(min(q, QUAL_MAX) for q in rec.qual)
        return "qual-out-of-range"
    return None


def batch_violations(
    batch, n_ref: int | None = None, ref_lens=None,
    max_read_len: int = 1 << 16,
) -> dict[int, tuple[str, bool]]:
    """Vectorized record_violation over one io.native.ColumnarBatch:
    {record index -> (reason, repairable)}. Empty on well-formed input
    — the native hot path pays a handful of numpy passes per 64K-record
    batch and nothing per record."""
    out: dict[int, tuple[str, bool]] = {}
    n = batch.n
    if n == 0:
        return out

    def mark(idx_array, reason, repairable=False):
        for i in idx_array:
            out.setdefault(int(i), (reason, repairable))

    l_seq = batch.l_seq
    mark(np.nonzero((l_seq < 0) | (l_seq > max_read_len))[0], "read-too-long")
    # MI/RX present-but-malformed (native extractor sentinel); absent
    # RX stays legal, absent MI errors at the grouper before batching
    for col in (getattr(batch, "mi", None), getattr(batch, "rx", None)):
        if col is not None:
            mark(np.nonzero(col == TAG_MALFORMED)[0], "tag-shape")
    bad_pos = (batch.pos < -1) | (batch.next_pos < -1)
    if ref_lens is not None and len(ref_lens):
        lens = np.asarray(ref_lens, dtype=np.int64)
        rid = batch.ref_id
        valid = (rid >= 0) & (rid < len(lens))
        over = np.zeros(n, dtype=bool)
        over[valid] = batch.pos[valid].astype(np.int64) >= lens[rid[valid]]
        bad_pos |= over
    mark(np.nonzero(bad_pos)[0], "pos-out-of-range")
    if n_ref is not None:
        bad_ref = (
            (batch.ref_id < -1) | (batch.ref_id >= n_ref)
            | (batch.next_ref < -1) | (batch.next_ref >= n_ref)
        )
        mark(np.nonzero(bad_ref)[0], "ref-out-of-range")
    # CIGAR query length vs l_seq (records with a CIGAR only)
    ncig = batch.n_cigar.astype(np.int64)
    has_cigar = np.nonzero((ncig > 0) & (l_seq > 0))[0]
    if len(has_cigar):
        co = batch.cigar_off
        cused = int(co[-1] + ncig[-1])
        cg = batch.cigar[:cused]
        contrib = np.where(
            np.asarray(_CONSUMES_QUERY, dtype=np.uint8)[cg & 0xF] != 0,
            (cg >> 4).astype(np.int64), 0,
        )
        cum = np.concatenate([[0], np.cumsum(contrib)])
        qlen = cum[co[has_cigar] + ncig[has_cigar]] - cum[co[has_cigar]]
        mark(
            has_cigar[qlen != l_seq[has_cigar].astype(np.int64)],
            "cigar-seq-mismatch",
        )
    # qual range (vectorized over the var plane; 0xFF-first = missing)
    vused = int(batch.var_off[-1] + l_seq[-1]) if int(l_seq[-1]) >= 0 else 0
    if vused > 0:
        bad_q = np.nonzero(batch.qual[:vused] > QUAL_MAX)[0]
        if len(bad_q):
            owner = np.searchsorted(batch.var_off, bad_q, side="right") - 1
            for i in np.unique(owner):
                i = int(i)
                off = int(batch.var_off[i])
                ls = int(l_seq[i])
                if ls > 0 and batch.qual[off] != 0xFF:
                    out.setdefault(i, ("qual-out-of-range", True))
    return out


# ---------------------------------------------------------------------------
# the Guard: policy + sidecar + counters

POLICIES = ("strict", "quarantine", "lenient", "off")
ENV_POLICY = "BSSEQ_TPU_INPUT_POLICY"
ENV_MAX_FAMILY = "BSSEQ_TPU_MAX_FAMILY_RECORDS"
ENV_MAX_READ_LEN = "BSSEQ_TPU_MAX_READ_LEN"
ENV_EVENT_CAP = "BSSEQ_TPU_GUARD_EVENT_CAP"

DEFAULT_MAX_FAMILY_RECORDS = 1 << 20
DEFAULT_MAX_READ_LEN = 1 << 16


def resolve_policy(policy: str | None = None) -> str:
    policy = policy or os.environ.get(ENV_POLICY, "strict")
    if policy not in POLICIES:
        raise ValueError(
            f"unknown {ENV_POLICY} {policy!r} (want "
            f"{'|'.join(POLICIES)})"
        )
    return policy


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


class Guard:
    """One stage's input-hardening context: policy, limits, the lazy
    quarantine sidecar, and counters (merged into the stage's locked
    Metrics so they surface as first-class StageStats fields).

    Construct per stage (stages.PipelineBuilder / the CLI subcommands)
    and `bind()` it to the input path + header once the reader is open;
    an unbound guard still validates and counts, it just cannot write a
    sidecar (records are counted + ledgered only).
    """

    def __init__(self, policy: str | None = None, stats=None,
                 max_family_records: int | None = None,
                 max_read_len: int | None = None,
                 job: str | None = None):
        self.policy = resolve_policy(policy)
        self.stats = stats
        #: a serve tenant's guard tags its ledger events with the job id
        self.job = job
        self.max_family_records = (
            max_family_records
            if max_family_records is not None
            else _env_int(ENV_MAX_FAMILY, DEFAULT_MAX_FAMILY_RECORDS)
        )
        self.max_read_len = (
            max_read_len
            if max_read_len is not None
            else _env_int(ENV_MAX_READ_LEN, DEFAULT_MAX_READ_LEN)
        )
        self.input_path: str | None = None
        self.header = None
        self.n_ref: int | None = None
        self.ref_lens: list[int] | None = None
        #: set by the guarded reader wrap so guard_groups does not
        #: re-validate records a record-level pass already cleared
        self.records_prevalidated = False
        self._sidecar = None
        self._event_budget = _env_int(ENV_EVENT_CAP, 100)
        self._events_dropped = 0

    # -- policy predicates ----------------------------------------------

    @property
    def active(self) -> bool:
        return self.policy != "off"

    @property
    def strict(self) -> bool:
        return self.policy == "strict"

    @property
    def resilient(self) -> bool:
        """True when stream/record corruption is survivable (quarantine
        + resync instead of fail-fast)."""
        return self.policy in ("quarantine", "lenient")

    @property
    def lenient(self) -> bool:
        return self.policy == "lenient"

    @classmethod
    def from_env(cls, stats=None) -> "Guard":
        return cls(stats=stats)

    # -- wiring ----------------------------------------------------------

    def bind(self, input_path: str | None, header=None) -> "Guard":
        self.input_path = input_path
        if header is not None:
            self.header = header
            self.n_ref = len(header.references)
            self.ref_lens = [ln for _, ln in header.references]
        return self

    @property
    def sidecar_path(self) -> str | None:
        return (
            self.input_path + ".quarantined.bam" if self.input_path else None
        )

    def count(self, name: str, n: int = 1) -> None:
        if self.stats is not None and n:
            self.stats.metrics.count(name, n)

    def _emit(self, event: str, payload: dict) -> None:
        if self._event_budget > 0:
            self._event_budget -= 1
            observe.event(event, payload, job=self.job)
        else:
            self._events_dropped += 1

    # -- quarantine -------------------------------------------------------

    def _sidecar_writer(self):
        if self._sidecar is None and self.sidecar_path and self.header:
            from bsseqconsensusreads_tpu_torch.io.bam import BamWriter

            # fresh file per run: a checkpoint resume replays the whole
            # group stream, so the sidecar is deterministically
            # rewritten — counts match an uninterrupted run
            self._sidecar = BamWriter(
                self.sidecar_path, self.header, level=1
            )
        return self._sidecar

    def _write_sidecar(self, rec, reason: str) -> None:
        w = self._sidecar_writer()
        if w is None:
            return
        from bsseqconsensusreads_tpu_torch.io.bam import BamRecord

        if not isinstance(rec, BamRecord):
            # a columnar view (or anything view-shaped): reconstruct the
            # fields the view exposes (MI/RX only — documented lossy)
            rec = BamRecord(
                qname=rec.qname, flag=rec.flag, ref_id=rec.ref_id,
                pos=rec.pos, mapq=rec.mapq, cigar=list(rec.cigar),
                next_ref_id=rec.next_ref_id, next_pos=rec.next_pos,
                tlen=rec.tlen, seq=rec.seq, qual=rec.qual,
                tags=dict(rec.tags),
            )
        else:
            rec = rec.copy()
        rec.set_tag("qr", reason, "Z")
        w.write(rec)

    def quarantine_blob(self, blob: bytes, index: int, reason: str,
                        voffset: int | None = None) -> None:
        """Quarantine a structurally corrupt record blob (cannot be
        decoded): preserved verbatim — capped at 4 KiB — in the `qb`
        hex tag of a placeholder unmapped record."""
        self.count("records_quarantined")
        self._emit("record_quarantined", {
            "input": self.input_path, "record_index": index,
            "reason": reason, "voffset": voffset, "bytes": len(blob),
        })
        w = self._sidecar_writer()
        if w is None:
            return
        from bsseqconsensusreads_tpu_torch.io.bam import BamRecord, FUNMAP

        ph = BamRecord(qname=f"quarantined.{index}", flag=FUNMAP)
        ph.set_tag("qr", reason, "Z")
        ph.set_tag("qb", blob[:4096].hex().upper(), "H")
        w.write(ph)

    def quarantine_record(self, rec, index: int | None, reason: str) -> None:
        self.count("records_quarantined")
        self._emit("record_quarantined", {
            "input": self.input_path, "record_index": index,
            "qname": getattr(rec, "qname", None), "reason": reason,
        })
        self._write_sidecar(rec, reason)

    def quarantine_family(self, mi: str, records, reason: str) -> None:
        self.count("families_quarantined")
        self.count("family_records_quarantined", len(records))
        self._emit("family_quarantined", {
            "input": self.input_path, "mi": mi, "records": len(records),
            "reason": reason,
        })
        for rec in records:
            self._write_sidecar(rec, reason)

    def repaired(self, rec, index: int | None, reason: str) -> None:
        self.count("records_repaired")
        self._emit("record_repaired", {
            "input": self.input_path, "record_index": index,
            "qname": getattr(rec, "qname", None), "reason": reason,
        })

    def stream_event(self, kind: str, payload: dict) -> None:
        """Ledger a stream-resilience event (bgzf resync gap, truncated
        tail) and count it under the same name."""
        self.count(kind)
        self._emit(kind, {"input": self.input_path, **payload})

    def close(self) -> None:
        if self._events_dropped:
            observe.event("guard_events_truncated", {
                "input": self.input_path, "dropped": self._events_dropped,
            })
            self._events_dropped = 0
        if self._sidecar is not None:
            self._sidecar.close()
            self._sidecar = None


# ---------------------------------------------------------------------------
# group-level admission control

def _family_run_violations(fam, guard: Guard) -> dict[int, tuple[str, bool]]:
    """Batch-cached vectorized violations for an ingest.FamilyRun (or a
    list of ColumnarRecordViews sharing one batch): {absolute batch
    index -> (reason, repairable)}."""
    batch = fam.batch
    cache = getattr(batch, "guard_bad", None)
    if cache is None:
        cache = batch_violations(
            batch, n_ref=guard.n_ref, ref_lens=guard.ref_lens,
            max_read_len=guard.max_read_len,
        )
        try:
            batch.guard_bad = cache
        except AttributeError:  # foreign batch type without the slot
            pass
    return cache


def guard_groups(
    groups: Iterable, guard: Guard | None,
) -> Iterator:
    """Wrap a (mi, records) / ingest.FamilyRun group stream with the
    guard's family-level admission control and (when the records were
    not already validated record-by-record upstream) semantic record
    validation. Pass-through when the guard is off/None.

    Family-level rules, all policies:
    * more than guard.max_family_records records -> strict: raise
      FamilyGuardError; else quarantine the family whole. This cap is
      admission *policy*, not envelope self-defense: the segment-packed
      kernel layout already keeps a giant family from padding its
      batchmates (it contributes only its own rows to the dense axis),
      but an unbounded family still costs unbounded host memory during
      grouping and unbounded device rows in its batch — the >=100 GB
      failure mode of the reference is bounded here by choice, at a
      configurable line, rather than by layout necessity.
    * any record in the family failing semantic validation -> strict:
      raise RecordGuardError; lenient: repair when repairable; else
      quarantine the family whole (a corrupt member poisons the
      consensus, and family-granular drops keep the python and native
      engines byte-identical on the same corrupt input).
    """
    if guard is None or not guard.active:
        yield from groups
        return
    for fam in groups:
        n = getattr(fam, "n", None)
        if n is None:
            mi, records = fam
            n = len(records)
        else:
            mi = fam.mi
        if n > guard.max_family_records:
            if guard.strict:
                raise FamilyGuardError(
                    f"family {mi!r} has {n} records "
                    f"(cap {guard.max_family_records}; raise "
                    f"{ENV_MAX_FAMILY} if this input is trusted)",
                    reason="family-too-large", mi=mi,
                )
            records = fam.records if hasattr(fam, "records") else fam[1]
            guard.quarantine_family(mi, records, "family-too-large")
            continue
        if hasattr(fam, "batch"):  # ingest.FamilyRun: vectorized check
            bad = _family_run_violations(fam, guard)
            if bad:
                hit = [
                    i for i in range(fam.start, fam.start + fam.n)
                    if i in bad
                ]
                if hit:
                    if guard.strict:
                        reason, _ = bad[hit[0]]
                        raise RecordGuardError(
                            f"record failed input validation: {reason}",
                            reason=reason, record_index=hit[0],
                        )
                    if guard.lenient and all(
                        bad[i][1] for i in hit
                    ):
                        # repairable-only family: clamp in the shared
                        # qual plane (views read through to it)
                        for i in hit:
                            off = int(fam.batch.var_off[i])
                            ls = int(fam.batch.l_seq[i])
                            q = fam.batch.qual[off:off + ls]
                            np.minimum(q, QUAL_MAX, out=q)
                            guard.repaired(None, i, bad[i][0])
                        yield fam
                        continue
                    guard.quarantine_family(
                        mi, fam.records, bad[hit[0]][0]
                    )
                    continue
            yield fam
            continue
        if guard.records_prevalidated:
            yield mi, records
            continue
        # python-object groups: per-record semantic validation
        viol = None
        for rec in records:
            if hasattr(rec, "_b"):  # columnar views w/o FamilyRun
                bad = _family_run_violations(
                    type("F", (), {"batch": rec._b})(), guard
                )
                v = bad.get(rec._i)
            else:
                v = record_violation(
                    rec, n_ref=guard.n_ref, ref_lens=guard.ref_lens,
                    max_read_len=guard.max_read_len,
                )
            if v is not None:
                viol = (rec, v)
                if not (guard.lenient and v[1]):
                    break
        if viol is None:
            yield mi, records
            continue
        rec, (reason, repairable) = viol
        if guard.strict:
            raise RecordGuardError(
                f"record failed input validation: {reason}",
                reason=reason, qname=getattr(rec, "qname", None),
            )
        if guard.lenient:
            repaired_all = True
            for r in records:
                v = record_violation(
                    r, n_ref=guard.n_ref, ref_lens=guard.ref_lens,
                    max_read_len=guard.max_read_len,
                )
                if v is None:
                    continue
                if v[1] and not hasattr(r, "_b"):
                    fixed = repair_record(r)
                    if fixed:
                        guard.repaired(r, None, fixed)
                        continue
                repaired_all = False
                break
            if repaired_all:
                yield mi, records
                continue
        guard.quarantine_family(mi, records, reason)
