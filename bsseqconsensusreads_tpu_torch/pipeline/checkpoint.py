"""Intra-stage checkpoint/resume for the streaming consensus callers.

The port of the JAX package's pipeline/checkpoint.py (_Manifest and
BatchCheckpoint). The reference's checkpointing is the rule-boundary file
DAG: a crashed run re-runs whole rules. This module adds the finer
granularity of the kernel batch.

Protocol
--------
Consensus batches (call_molecular_batches / call_duplex_batches) are
deterministic given identical input + parameters. BatchCheckpoint writes
them into numbered BAM shard files next to the target
(`<target>.part00000.bam`, …), registering each completed shard in a
manifest (`<target>.ckpt.json`) via atomic rename. On resume, the caller
asks for `skip_batches=ck.batches_done` — the stream replays group parsing
(host I/O) but skips encode and the kernel for everything already
durable. `finalize()` streams the shards into the target BAM (tmp +
rename) and removes the scratch files; a crash mid-finalize resumes by
re-finalizing.

A partially-written shard (crash before its manifest rename) is simply
overwritten on resume — the manifest is the single source of truth.

Integrity (faults.integrity): every registered shard carries a CRC32
over its file bytes, verified on resume. A shard that fails its CRC is
quarantined (renamed `*.quarantined`) and the manifest truncated to the
valid prefix — its batches (and every later shard's, to keep the replay
contiguous) are recomputed. A stale-fingerprint manifest is discarded
loudly; an input that changed since the manifest was written refuses
(faults.guard.InputChangedError). Discards and quarantines print one
stderr line each (utils.observe.event; the JAX package ledgers the same
event names).

Faults: the `ckpt_shard_write`, `ckpt_manifest_rename` and
`ckpt_finalize` failpoints fire where the JAX package fires them, and
the shard write runs under the bounded retrier (faults.retry.guarded) —
a failed attempt rewrites the whole shard from the batch items still in
memory.

Elastic workers install two gates here: the write gate (a fenced lease,
elastic.fencing) before every shard write, manifest rename and finalize,
and the batch gate (a preemption latch, elastic.preempt) after every
consumed batch. Neither touches a kernel launch.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from functools import partial
from typing import Iterable, Iterator

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.faults import retry as _faultretry
from bsseqconsensusreads_tpu_torch.faults.guard import InputChangedError
from bsseqconsensusreads_tpu_torch.io.bam import (
    BamHeader,
    BamReader,
    BamWriter,
    write_items,
)
from bsseqconsensusreads_tpu_torch.utils import observe

#: Durable-write gate, installed by elastic.fencing.adopt() in workers
#: holding a fenced lease: called (with the seam name) before every
#: checkpoint shard write, manifest rename and stage finalize, and
#: raises FencedError once the holder's fence epoch is revoked. None —
#: one branch per durable write — everywhere else.
_WRITE_GATE = None


def install_write_gate(gate) -> None:
    global _WRITE_GATE
    _WRITE_GATE = gate


def _gate(what: str) -> None:
    if _WRITE_GATE is not None:
        _WRITE_GATE(what)


#: Batch-boundary gate, installed by elastic.preempt in workers: called
#: with the would-be durable batch count after every batch consumed by
#: write_batches, and raises PreemptedError once a preemption latch is
#: set. The pending buffer is flushed BEFORE the error propagates, so
#: the interrupting batch is durable — handoff latency is bounded by one
#: batch, never one lease. None everywhere else.
_BATCH_GATE = None


def install_batch_gate(gate) -> None:
    global _BATCH_GATE
    _BATCH_GATE = gate


def _batch_gate(batches_done: int) -> None:
    if _BATCH_GATE is not None:
        _BATCH_GATE(batches_done)


@dataclasses.dataclass
class _Manifest:
    batches_done: int = 0
    shards: list[str] = dataclasses.field(default_factory=list)
    records: int = 0
    fingerprint: dict = dataclasses.field(default_factory=dict)
    #: identity of the INPUT the shards were computed from (path, size,
    #: mtime) — kept apart from the config fingerprint: config drift
    #: discards and recomputes, input drift refuses
    input_fingerprint: dict = dataclasses.field(default_factory=dict)
    #: per-shard CRC32, batches and records, parallel to `shards`
    shard_crcs: list[int] = dataclasses.field(default_factory=list)
    shard_batches: list[int] = dataclasses.field(default_factory=list)
    shard_records: list[int] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "_Manifest":
        if not os.path.exists(path):
            return cls()
        with open(path) as fh:
            d = json.load(fh)
        return cls(
            d["batches_done"], d["shards"], d["records"],
            d.get("fingerprint", {}),
            d.get("input_fingerprint", {}),
            d.get("shard_crcs", []),
            d.get("shard_batches", []),
            d.get("shard_records", []),
        )

    def consistent(self) -> bool:
        n = len(self.shards)
        return (
            len(self.shard_crcs) == n
            and len(self.shard_batches) == n
            and len(self.shard_records) == n
        )

    def save(self, path: str) -> None:
        _gate("ckpt_manifest_rename")
        _failpoints.fire("ckpt_manifest_rename")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(dataclasses.asdict(self), fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)


class BatchCheckpoint:
    """Durable batch-granular writer for one consensus stage target.

    every: batches per shard file — the checkpoint interval.

    fingerprint: what identifies the batching/model parameters the shards
    were computed from. A stale manifest whose fingerprint mismatches is
    discarded (with its shards) instead of splicing old-config shards
    into a new run.

    input_fingerprint: identity of the input file (path/size/mtime). A
    mismatch refuses to resume (InputChangedError): the operator decides
    whether the swap was intentional by deleting the manifest.
    """

    def __init__(self, target: str, header: BamHeader, every: int = 16,
                 fingerprint: dict | None = None, level: int = 6,
                 input_fingerprint: dict | None = None):
        if every < 1:
            raise ValueError(f"checkpoint interval must be >= 1, got {every}")
        self.target = target
        self.header = header
        self.every = every
        self.level = level  # deflate level of the finalized target
        self.manifest_path = target + ".ckpt.json"
        self.manifest = _Manifest.load(self.manifest_path)
        fingerprint = fingerprint or {}
        input_fingerprint = input_fingerprint or {}
        if self.manifest.shards and not self.manifest.consistent():
            # a mangled manifest: its per-shard bookkeeping cannot be
            # trusted, so recompute rather than resume
            self._discard(reason="manifest_format")
        if (
            self.manifest.shards
            and self.manifest.input_fingerprint
            and input_fingerprint
            and self.manifest.input_fingerprint != input_fingerprint
        ):
            observe.emit(
                "checkpoint_input_changed",
                {
                    "target": self.target,
                    "manifest_input": self.manifest.input_fingerprint,
                    "run_input": input_fingerprint,
                    "batches_at_stake": self.manifest.batches_done,
                },
            )
            raise InputChangedError(
                self.target, self.manifest.input_fingerprint,
                input_fingerprint,
            )
        if self.manifest.shards and self.manifest.fingerprint != fingerprint:
            # loud: an operator must be able to tell "resumed fresh on
            # purpose" from "params drifted"
            observe.event(
                "checkpoint_discarded",
                {
                    "target": self.target,
                    "reason": "fingerprint_mismatch",
                    "manifest_fingerprint": self.manifest.fingerprint,
                    "run_fingerprint": fingerprint,
                    "dropped_batches": self.manifest.batches_done,
                    "dropped_shards": len(self.manifest.shards),
                },
            )
            self._discard_scratch()
            self.manifest = _Manifest()
        self.manifest.fingerprint = fingerprint
        self.manifest.input_fingerprint = input_fingerprint
        #: optional watermark hook, called as on_flush(batches_done) after
        #: a shard write succeeds and BEFORE the manifest commits: the
        #: methyl tally accumulator spills at exactly these points, so a
        #: crash between the two leaves at worst a run the next resume
        #: drops as above the watermark (its batches replay), never a hole
        #: and never a double count (methyl.tally.MethylAccumulator)
        self.on_flush = None
        self._verify_shards()

    def _discard(self, reason: str) -> None:
        observe.event(
            "checkpoint_discarded",
            {
                "target": self.target,
                "reason": reason,
                "dropped_batches": self.manifest.batches_done,
                "dropped_shards": len(self.manifest.shards),
            },
        )
        self._discard_scratch()
        self.manifest = _Manifest()

    def _discard_scratch(self) -> None:
        # glob rather than the manifest list: catches orphaned partials
        # (crash before registration) and quarantined shards too
        for path in glob.glob(self.target + ".part*"):
            try:
                os.remove(path)
            # graftlint: disable=swallowed-exception -- a scratch shard already gone
            # needs no removal
            except FileNotFoundError:
                pass
        try:
            os.remove(self.manifest_path)
        # graftlint: disable=swallowed-exception -- a scratch manifest already gone
        # needs no removal
        except FileNotFoundError:
            pass

    def _verify_shards(self) -> None:
        """Resume-time integrity pass: verify every registered shard's
        CRC; quarantine the first corrupt/missing one and truncate the
        manifest to the valid prefix (later shards are dropped too —
        batch replay must stay contiguous)."""
        m = self.manifest
        if not m.shards or not m.consistent():
            return
        d = os.path.dirname(self.target)
        keep = len(m.shards)
        for i, shard in enumerate(m.shards):
            path = os.path.join(d, shard)
            try:
                _integrity.verify_file_crc32(
                    path, m.shard_crcs[i], what=f"checkpoint shard {shard}"
                )
            except OSError as exc:
                keep = i
                observe.event(
                    "shard_quarantined",
                    {
                        "target": self.target,
                        "shard": shard,
                        "error": str(exc),
                        "dropped_batches": sum(m.shard_batches[i:]),
                        "dropped_shards": len(m.shards) - i,
                    },
                )
                if os.path.exists(path):
                    os.replace(path, path + ".quarantined")
                break
        if keep == len(m.shards):
            return
        for shard in m.shards[keep + 1:]:
            # valid but orphaned by the gap: their batches recompute
            try:
                os.remove(os.path.join(d, shard))
            except FileNotFoundError:
                pass
        m.shards = m.shards[:keep]
        m.shard_crcs = m.shard_crcs[:keep]
        m.shard_records = m.shard_records[:keep]
        m.shard_batches = m.shard_batches[:keep]
        m.batches_done = sum(m.shard_batches)
        m.records = sum(m.shard_records)
        m.save(self.manifest_path)

    @property
    def batches_done(self) -> int:
        """Batches already durable — pass as skip_batches on resume."""
        return self.manifest.batches_done

    def _shard_path(self, index: int) -> str:
        return f"{self.target}.part{index:05d}.bam"

    def write_batches(self, batches: Iterable[list]) -> None:
        """Consume a batch stream (already offset by skip_batches), flushing
        a shard + manifest update every `every` batches. Batch items may be
        BamRecord objects or io.bam.RawRecords blocks (the native batch
        emit) — shards hold identical bytes either way."""
        buf: list = []
        pending = 0
        for batch in batches:
            buf.extend(batch)
            pending += 1
            try:
                _batch_gate(self.manifest.batches_done + pending)
            except BaseException:
                # make the in-flight batch durable before unwinding: the
                # gate fires at a batch boundary, so `buf` is a complete
                # prefix — flushing it now bounds handoff latency to one
                # batch instead of one lease
                self._flush(buf, pending)
                close = getattr(batches, "close", None)
                if close is not None:
                    # join the stream's in-flight batches (its pools'
                    # streams and pinned staging) now, not at collection:
                    # they are not durable, the next holder recomputes them
                    close()
                raise
            if pending == self.every:
                self._flush(buf, pending)
                buf, pending = [], 0
        if pending:
            self._flush(buf, pending)

    def _write_shard(self, path: str, items: list) -> int:
        """One shard write attempt — the retry unit for transient I/O
        errors."""
        _gate("ckpt_shard_write")
        _failpoints.fire("ckpt_shard_write", shard=os.path.basename(path))
        # shards are scratch (re-read once at finalize, then deleted):
        # always deflate fast, like the external-sort spills
        with BamWriter(path, self.header, level=1) as w:
            n = write_items(w, items)
        # the shard must hit disk BEFORE the manifest claims it durable
        with open(path, "rb") as fh:
            os.fsync(fh.fileno())
        return n

    def _flush(self, items: list, n_batches: int) -> None:
        path = self._shard_path(len(self.manifest.shards))
        n = _faultretry.guarded(
            partial(self._write_shard, path, items),
            stage="checkpoint", batch=len(self.manifest.shards),
        )
        if self.on_flush is not None:
            self.on_flush(self.manifest.batches_done + n_batches)
        self.manifest.batches_done += n_batches
        self.manifest.shards.append(os.path.basename(path))
        self.manifest.records += n
        self.manifest.shard_crcs.append(_integrity.file_crc32(path))
        self.manifest.shard_batches.append(n_batches)
        self.manifest.shard_records.append(n)
        self.manifest.save(self.manifest_path)

    def iter_raw_records(self) -> Iterator[bytes]:
        """Stream every durable record as its encoded blob, in batch order
        — feeds the raw coordinate sort without a decode/re-encode round
        trip."""
        d = os.path.dirname(self.target)
        for shard in self.manifest.shards:
            with BamReader(os.path.join(d, shard)) as r:
                yield from r.raw_records()

    def finalize(self, records: Iterable[bytes] | None = None,
                 writer_fn=None) -> int:
        """Concatenate shards into the target BAM and remove scratch files.

        records: optionally a transformed stream of encoded record blobs
        (the Python raw coordinate sort over iter_raw_records()) to write
        instead of the raw shard order. writer_fn: alternatively a
        callable receiving the open target BamWriter and returning the
        record count (the native raw sort writes through the writer's
        codec). Returns the record count.

        The target appears atomically (tmp + rename): a crash mid-finalize
        leaves no partial target for the workflow's mtime check to mistake
        for a completed rule — the manifest survives and the rerun
        re-finalizes from the durable shards.
        """
        _gate("ckpt_finalize")
        _failpoints.fire("ckpt_finalize", target=self.target)
        n = 0
        tmp = self.target + ".finalize.tmp"
        with BamWriter(tmp, self.header, level=self.level) as w:
            if writer_fn is not None:
                n = writer_fn(w)
            elif records is None:
                # raw-order concatenation: copy each shard's record bytes
                # verbatim, coalesced
                d = os.path.dirname(self.target)
                for shard in self.manifest.shards:
                    with BamReader(os.path.join(d, shard)) as r:
                        n += w.write_raw_many(r.raw_records())
            else:
                n = w.write_raw_many(records)
        os.replace(tmp, self.target)
        self._discard_scratch()
        return n
