"""Methylation tally accumulator with spill runs and a watermark protocol.

The port of the JAX package's methyl/tally.py. Per-batch methyl planes
(methyl.context) reduce into per-site (methylated, unmethylated) sums
keyed by the site's GLOBAL genome offset (ops.refstore's concatenated
coordinate: contig-major, so sorted global offsets ARE (contig, pos)
order and the emit never sorts again).

Crash consistency rides the duplex checkpoint's watermark protocol:

  * add() is idempotent per batch index: a replayed batch recomputes
    identical tallies, so replacing the pending entry (or ignoring a batch
    at or below the committed watermark) never double-counts;
  * flush(watermark), wired as pipeline.checkpoint.BatchCheckpoint's
    on_flush hook (called after the shard write and BEFORE the manifest
    commits), spills every pending batch <= watermark into one CRC'd run
    file recorded in a sidecar manifest (<output>.methyl.runs.json) whose
    entries carry their `upto` watermark;
  * resume(batches_done) keeps the longest manifest prefix whose `upto`
    does not exceed the checkpoint's committed batch count and whose CRCs
    verify, and deletes the orphan run files after it: those batches
    replay through the stage like the consensus stream itself.

Tally sums are commutative integers, so the bedMethyl/CX bytes do not
depend on where the runs were cut.

merge_tallies has a native engine (csrc/host/wirepack.cpp
methyl_tally_merge, bound in io.wirepack) and the numpy argsort +
reduceat twin below; both give the same arrays.

A run write fires the `extsort_spill` failpoint with stage="methyl" and
runs under the bounded retrier (faults.retry.guarded), as in the JAX
package. The duplex stage adds each batch's tallies on its ordered
retire (pipeline.calling), so batches arrive here in batch order under
any number of overlap and host workers.
"""

from __future__ import annotations

import json
import os
import struct
import threading

import numpy as np

from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.faults import retry as _faultretry
from bsseqconsensusreads_tpu_torch.utils import observe

_RUN_MAGIC = b"BSMT"
_RUN_VERSION = 1
MERGE_ENGINES = ("auto", "native", "python")


def merge_tallies(sites, ctx, meth, unmeth, engine: str = "auto"):
    """Reduce (possibly duplicated) site tallies to sorted unique sums.

    sites int64 [n] global genome offsets, ctx u8 [n] (a pure function of
    the site, so any occurrence's value is THE value), meth/unmeth u32 [n].
    Returns the same four arrays, sites strictly increasing. engine:
    'auto' and 'native' take the C sweep (a library that does not build
    raises), 'python' the numpy twin; BSSEQ_TPU_METHYL_MERGE overrides
    (the JAX package's knob)."""
    engine = os.environ.get("BSSEQ_TPU_METHYL_MERGE", engine)
    if engine not in MERGE_ENGINES:
        raise ValueError(f"unknown merge engine {engine!r} (auto | native | python)")
    sites = np.ascontiguousarray(sites, dtype=np.int64)
    ctx = np.ascontiguousarray(ctx, dtype=np.uint8)
    meth = np.ascontiguousarray(meth, dtype=np.uint32)
    unmeth = np.ascontiguousarray(unmeth, dtype=np.uint32)
    if engine != "python":
        from bsseqconsensusreads_tpu_torch.io import wirepack

        return wirepack.methyl_tally_merge(sites, ctx, meth, unmeth)
    if not sites.size:
        return sites, ctx, meth, unmeth
    order = np.argsort(sites, kind="stable")
    s = sites[order]
    first = np.concatenate([[True], s[1:] != s[:-1]])
    idx = np.nonzero(first)[0]
    return (
        s[idx],
        ctx[order][idx],
        np.add.reduceat(meth[order].astype(np.uint64), idx).astype(np.uint32),
        np.add.reduceat(unmeth[order].astype(np.uint64), idx).astype(np.uint32),
    )


def extract_tallies(planes, metas, refstore, rid_map=None):
    """Sparse per-batch tallies from the dense methyl planes.

    planes u8 [F, 2, W] (ctx, nibble counts), metas the batch's FamilyMeta
    list, refstore an ops.refstore.RefStore. rid_map
    (refstore.contig_indices over the BAM header's names) maps each meta's
    ref_id to a STORE contig index: the header's contig order need not be
    the store's. Families without a reference (unknown contig, negative
    start) carry no sites. One vectorized nonzero over the batch."""
    planes = np.asarray(planes)
    rid = np.asarray([m.ref_id for m in metas], dtype=np.int64)
    if rid_map is not None:
        rid_map = np.asarray(rid_map, dtype=np.int64)
        known = (rid >= 0) & (rid < len(rid_map))
        rid = np.where(known, rid_map[np.where(known, rid, 0)], -1)
    ws = np.asarray([m.window_start for m in metas], dtype=np.int64)
    ok = (rid >= 0) & (rid < len(refstore.names)) & (ws >= 0)
    gstart = np.where(ok, refstore.offsets[np.where(ok, rid, 0)] + ws, -1)
    ctx_plane = planes[:, 0, :]
    cnt_plane = planes[:, 1, :]
    mask = (ctx_plane != 0) & (cnt_plane != 0) & ok[:, None]
    fi, col = np.nonzero(mask)
    cnt = cnt_plane[fi, col]
    return (
        gstart[fi] + col,
        ctx_plane[fi, col],
        (cnt & 0xF).astype(np.uint32),
        (cnt >> 4).astype(np.uint32),
    )


def _write_run_payload(path: str, entries, engine: str) -> int:
    """One run file: header + the four tally arrays of every pending
    entry, concatenated and merged."""
    sites, ctx, meth, unmeth = merge_tallies(
        *(np.concatenate([e[k] for e in entries]) for k in range(4)), engine=engine
    )
    with open(path, "wb") as fh:
        fh.write(_RUN_MAGIC)
        fh.write(struct.pack("<IQ", _RUN_VERSION, sites.size))
        fh.write(sites.tobytes())
        fh.write(ctx.tobytes())
        fh.write(meth.tobytes())
        fh.write(unmeth.tobytes())
    return int(sites.size)


def _read_run_file(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != _RUN_MAGIC:
            raise _integrity.IntegrityError(f"{path}: bad methyl run magic {magic!r}")
        version, n = struct.unpack("<IQ", fh.read(12))
        if version != _RUN_VERSION:
            raise _integrity.IntegrityError(
                f"{path}: methyl run version {version} != {_RUN_VERSION}"
            )
        sites = np.frombuffer(fh.read(8 * n), dtype=np.int64)
        ctx = np.frombuffer(fh.read(n), dtype=np.uint8)
        meth = np.frombuffer(fh.read(4 * n), dtype=np.uint32)
        unmeth = np.frombuffer(fh.read(4 * n), dtype=np.uint32)
    if unmeth.size != n:
        raise _integrity.IntegrityError(f"{path}: truncated methyl run")
    return sites, ctx, meth, unmeth


class MethylAccumulator:
    """Thread-safe tally sink for one duplex stage run.

    bed_path / cx_path select the outputs (either may be None, not both).
    Run files spill next to the first output. When a BatchCheckpoint
    drives flush(), spills happen ONLY at its committed watermarks (a run
    can never hold a batch the replay would redo and the manifest would
    drop); without a checkpoint a size threshold (spill_sites) bounds the
    pending memory instead. engine: merge_tallies' engine. metrics (a
    utils.observe.Metrics) gets the 'methyl_spill_runs' /
    'methyl_spill_sites' counters and the finalize's seconds."""

    def __init__(self, refstore, bed_path: str | None = None,
                 cx_path: str | None = None, *, metrics=None,
                 spill_sites: int = 1 << 22, engine: str = "auto"):
        if bed_path is None and cx_path is None:
            raise ValueError("MethylAccumulator needs bed_path or cx_path")
        if engine not in MERGE_ENGINES:
            raise ValueError(f"unknown merge engine {engine!r} (auto | native | python)")
        self.refstore = refstore
        self.bed_path = bed_path
        self.cx_path = cx_path
        self.metrics = metrics
        self.spill_sites = spill_sites
        self.engine = engine
        target = bed_path if bed_path is not None else cx_path
        self._base = target
        self._manifest_path = target + ".methyl.runs.json"
        self._lock = threading.Lock()
        self._pending: dict[int, tuple] = {}
        self._pending_sites = 0
        self._watermark = 0
        self._runs: list[dict] = []
        self._checkpointed = False
        self._rid_map = None  # set by bind_names (BAM ref_id -> store index)
        self.sites_out = 0  # unique sites written (set by finalize)

    def bind_names(self, ref_names) -> None:
        """Pin the BAM header's ref_id -> store contig mapping that
        add_planes' global offsets need."""
        self._rid_map = self.refstore.contig_indices(ref_names)

    # ---- ingestion ----------------------------------------------------

    def add(self, batch_index: int, sites, ctx, meth, unmeth) -> None:
        """Record one batch's tallies. Idempotent per batch index: a
        repeated add replaces the identical pending entry or, at or below
        the committed watermark, is ignored."""
        with self._lock:
            if batch_index <= self._watermark:
                return
            prev = self._pending.get(batch_index)
            if prev is not None:
                self._pending_sites -= prev[0].size
            entry = (
                np.asarray(sites, dtype=np.int64),
                np.asarray(ctx, dtype=np.uint8),
                np.asarray(meth, dtype=np.uint32),
                np.asarray(unmeth, dtype=np.uint32),
            )
            self._pending[batch_index] = entry
            self._pending_sites += entry[0].size
            if not self._checkpointed and self._pending_sites > self.spill_sites:
                self._spill_locked(max(self._pending))

    def add_planes(self, batch_index: int, planes, metas) -> None:
        self.add(batch_index, *extract_tallies(planes, metas, self.refstore, self._rid_map))

    # ---- spill / watermark protocol ------------------------------------

    def attach_checkpoint(self, ck) -> None:
        """Become the checkpoint's on_flush hook and restore the committed
        run chain of a resumed run."""
        self._checkpointed = True
        self.resume(ck.batches_done)
        ck.on_flush = self.flush

    def flush(self, watermark: int) -> None:
        """Spill every pending batch <= watermark into one run file. Called
        by BatchCheckpoint after its shard write and BEFORE its manifest
        commits: a crash between the two leaves a run the next resume
        drops as above the watermark, never a hole."""
        with self._lock:
            self._spill_locked(watermark)

    def _spill_locked(self, watermark: int) -> None:
        take = sorted(bi for bi in self._pending if bi <= watermark)
        if not take:
            return
        run_index = len(self._runs)
        path = f"{self._base}.methyl.run.{run_index:04d}"
        entries = [self._pending[bi] for bi in take]

        def write_attempt() -> int:
            # a failed attempt rewrites the same path whole
            _failpoints.fire("extsort_spill", stage="methyl", run=run_index)
            return _write_run_payload(path, entries, self.engine)

        n = _faultretry.guarded(
            write_attempt, metrics=self.metrics, stage="extsort_spill", batch=run_index,
        )
        self._runs.append({
            "file": os.path.basename(path),
            "crc": _integrity.file_crc32(path),
            "upto": watermark,
            "records": n,
        })
        self._save_manifest()
        for bi in take:
            # graftlint: disable=thread-unsafe-mutation -- _spill_locked: every caller
            # holds self._lock
            self._pending_sites -= self._pending.pop(bi)[0].size
        # graftlint: disable=thread-unsafe-mutation -- same lock as above
        self._watermark = max(self._watermark, watermark)
        if self.metrics is not None:
            self.metrics.count("methyl_spill_runs")
            self.metrics.count("methyl_spill_sites", n)
        observe.emit("methyl_spill", {"run": run_index, "sites": n, "upto": watermark})

    def _save_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"runs": self._runs}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._manifest_path)

    def resume(self, batches_done: int) -> None:
        """Restore the committed run chain: keep the longest manifest prefix
        with upto <= batches_done and verified CRCs; delete every run after
        it (orphans of a crashed spill, whose batches replay)."""
        if not os.path.exists(self._manifest_path):
            return
        with open(self._manifest_path) as fh:
            runs = json.load(fh).get("runs", [])
        base_dir = os.path.dirname(self._base) or "."
        keep: list[dict] = []
        for run in runs:
            if run["upto"] > batches_done:
                break
            try:
                _integrity.verify_file_crc32(
                    os.path.join(base_dir, run["file"]), run["crc"], run["file"]
                )
            except _integrity.IntegrityError:
                break
            keep.append(run)
        for run in runs[len(keep):]:
            path = os.path.join(base_dir, run["file"])
            if os.path.exists(path):
                os.unlink(path)
        dropped = len(runs) - len(keep)
        self._runs = keep
        self._watermark = keep[-1]["upto"] if keep else 0
        if dropped or keep:
            observe.event("methyl_resume", {
                "runs_kept": len(keep), "runs_dropped": dropped,
                "watermark": self._watermark,
            })
        if dropped:
            self._save_manifest()

    # ---- finalize ------------------------------------------------------

    def finalize(self) -> dict:
        """Merge the run chain and the pending tallies and write the
        outputs. Returns {"sites": n, "bed": path?, "cx": path?}; with
        metrics, the seconds of the merge and of each output are timed as
        'methyl_finalize' ('.merge', '.bedmethyl', '.cx')."""
        from bsseqconsensusreads_tpu_torch.methyl import emit as _emit
        from bsseqconsensusreads_tpu_torch.utils.observe import Metrics

        timer = self.metrics if self.metrics is not None else Metrics()
        with self._lock, timer.timed("methyl_finalize"):
            base_dir = os.path.dirname(self._base) or "."
            with timer.timed("methyl_finalize.merge"):
                parts = []
                for run in self._runs:
                    path = os.path.join(base_dir, run["file"])
                    _integrity.verify_file_crc32(path, run["crc"], run["file"])
                    parts.append(_read_run_file(path))
                parts.extend(self._pending[bi] for bi in sorted(self._pending))
                if parts:
                    arrays = [np.concatenate([p[k] for p in parts]) for k in range(4)]
                else:
                    arrays = [np.zeros(0, np.int64), np.zeros(0, np.uint8),
                              np.zeros(0, np.uint32), np.zeros(0, np.uint32)]
                sites, ctx, meth, unmeth = merge_tallies(*arrays, engine=self.engine)
            self.sites_out = int(sites.size)
            out: dict = {"sites": self.sites_out}
            if self.bed_path is not None:
                with timer.timed("methyl_finalize.bedmethyl"):
                    _emit.write_bedmethyl(self.bed_path, self.refstore, sites, ctx, meth, unmeth)
                out["bed"] = self.bed_path
            if self.cx_path is not None:
                with timer.timed("methyl_finalize.cx"):
                    _emit.write_cx_report(self.cx_path, self.refstore, sites, ctx, meth, unmeth)
                out["cx"] = self.cx_path
            for run in self._runs:
                path = os.path.join(base_dir, run["file"])
                if os.path.exists(path):
                    os.unlink(path)
            if os.path.exists(self._manifest_path):
                os.unlink(self._manifest_path)
            self._runs = []
            self._pending.clear()
            self._pending_sites = 0
            observe.emit("methyl_finalize", out)
            return out
