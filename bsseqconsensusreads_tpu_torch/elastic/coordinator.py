"""graftswarm coordinator: the work-unit ledger behind `cli elastic run`.

An elastic run shards one grouped input across worker processes and
merges their outputs back into bytes identical to the single-process
pipeline. The coordinator owns three things:

* **the split** — `split_input` partitions the input into contiguous
  base-family (MI with the /A|/B strand suffix stripped) ordinal
  ranges, one slice BAM per range, same header bytes. Contiguity is
  what makes the merge exact: per-slice coordinate-sorted outputs
  merged in slice order reproduce the stable global sort the
  single-process run performs over the same emission stream. Each
  slice carries a family-hash fingerprint (CRC over its member base-MI
  ids) that every downstream commit must echo back.
* **the lease table** — slices are leased to workers over the serve
  tier's framed transport (`tcp:` with optional TLS; hostile frames get the
  same typed `TransportError` refusal matrix every serve front has).
  Leases expire against worker heartbeats; an expired lease or a dead
  worker requeues the slice (`slice_requeued` / `worker_lost` ledger
  events). Requeue loses nothing recomputable: the slice's work dir is
  keyed by slice id, not worker id, so the next holder's
  BatchCheckpoint resume keeps the longest verified CRC shard prefix
  and recomputes only the remainder — exactly-once emit per family.
* **durable truth** — the filesystem, not this process. A slice is
  done iff its dir holds a committed `manifest.json` whose fingerprint
  matches and whose output CRC verifies. The in-memory lease table is
  volatile by design: a restarted coordinator rescans the slice dirs
  and re-enqueues only the incomplete slices (the
  `elastic_coordinator_restart` chaos scenario drills this window).

`run_elastic` is the one-command front: split, serve, supervise N
local workers (`BSSEQ_TPU_WORKER_ID=w<i>`, fleet-style respawn with a
one-shot first-life failpoint override for the chaos drill), then
finalize through elastic.merge and refuse to declare the run ok until
the counters reconcile.

The coordinator process never touches the device: it splits, leases and
merges host bytes. The workers it spawns are this package's own CLI
(`python -m bsseqconsensusreads_tpu_torch elastic worker`), each with its
own CUDA context; their stderr lands in `<rundir>/workers/<wid>.log`.
"""

from __future__ import annotations

import base64
import bisect
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import zlib
from collections import deque

from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
from bsseqconsensusreads_tpu_torch.elastic import fencing as _fencing
from bsseqconsensusreads_tpu_torch.elastic import preempt as _preempt
from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.io.bam import BamReader, BamWriter
from bsseqconsensusreads_tpu_torch.serve.server import ProtocolServer
from bsseqconsensusreads_tpu_torch.utils import observe

ENV_WORKER_ID = "BSSEQ_TPU_WORKER_ID"
ENV_COORDINATOR_ADDR = "BSSEQ_TPU_COORDINATOR_ADDR"
ENV_LEASE_S = "BSSEQ_TPU_ELASTIC_LEASE_S"
#: wall-clock spawn instant, stamped by the supervisor into each worker's
#: environment so the worker can book its own spawn→join overhead span
ENV_SPAWNED_AT = "BSSEQ_TPU_SPAWNED_AT"
#: ship-mode wire chunk size (raw bytes per slice_fetch/slice_push
#: frame; the base64 envelope must stay under transport.MAX_FRAME)
ENV_CHUNK_B = "BSSEQ_TPU_ELASTIC_CHUNK_B"

#: Default lease duration. Workers renew at a third of this, so only a
#: hung or dead worker lets a lease lapse.
DEFAULT_LEASE_S = 30.0

DEFAULT_CHUNK_B = 1 << 20


def chunk_bytes(default: int = DEFAULT_CHUNK_B) -> int:
    """Raw bytes per slice-shipping chunk. Clamped so the base64
    envelope (4/3 inflation + JSON overhead) stays under MAX_FRAME;
    tests shrink it to force multi-chunk transfers on tiny slices."""
    try:
        n = int(os.environ.get(ENV_CHUNK_B, default))
    except ValueError:
        n = default
    return max(1, min(n, 4 * 1024 * 1024))

SLICES_DOC = "slices.json"
CFG_DOC = "cfg.json"
MANIFEST_NAME = "manifest.json"


class ElasticError(RuntimeError):
    """Unrunnable elastic configuration, exhausted workers, or a merge
    whose counters refuse to reconcile."""


def lease_seconds(default: float = DEFAULT_LEASE_S) -> float:
    try:
        return float(os.environ.get(ENV_LEASE_S, default))
    except ValueError:
        return default


def base_mi(mi: str) -> str:
    """Duplex family id: the MI with its /A | /B strand suffix stripped
    (the fgbio convention). Slicing on the BASE id keeps both strands
    of a duplex family in one slice, so per-slice duplex calling sees
    exactly the families the single-process run sees."""
    return mi.split("/", 1)[0]


def slice_name(sid: int) -> str:
    return f"s{sid:04d}"


def config_doc(cfg: FrameworkConfig) -> dict:
    """JSON-serializable form of a FrameworkConfig, shipped to workers
    at join time (and written to `<rundir>/cfg.json` for `--join`
    workers on another host reading the shared rundir)."""
    return dataclasses.asdict(cfg)


def config_from_doc(doc: dict) -> FrameworkConfig:
    from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams

    d = dict(doc)
    for key in ("molecular", "duplex"):
        if isinstance(d.get(key), dict):
            d[key] = ConsensusParams(**d[key])
    return FrameworkConfig(**d)


def _load_json(path: str) -> dict | None:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _save_json_atomic(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _input_fingerprint(path: str) -> dict:
    st = os.stat(path)
    return {
        "path": os.path.abspath(path),
        "size": st.st_size,
        "mtime": st.st_mtime,
    }


# --------------------------------------------------------------------- split


def split_input(bam_path: str, rundir: str, n_slices: int) -> list[dict]:
    """Partition a grouped BAM into contiguous base-family ordinal
    ranges, one slice BAM per range (same header bytes). Idempotent: a
    rerun over an unchanged input with intact slice files reuses them
    (the coordinator-restart resume path); anything stale is rebuilt.

    Returns the slice descriptors: sid, rundir-relative path, record /
    family counts, the family-hash fingerprint (CRC over member base-MI
    ids in ordinal order), and the slice file's own CRC.
    """
    slicedir = os.path.join(rundir, "slices")
    os.makedirs(slicedir, exist_ok=True)
    fp = _input_fingerprint(bam_path)
    doc_path = os.path.join(rundir, SLICES_DOC)
    doc = _load_json(doc_path)
    if (
        doc
        and doc.get("input_fingerprint") == fp
        and doc.get("n_slices_requested") == n_slices
    ):
        try:
            for sl in doc["slices"]:
                _integrity.verify_file_crc32(
                    os.path.join(rundir, sl["path"]), sl["input_crc"],
                    what=f"slice input {slice_name(sl['sid'])}",
                )
        except OSError:
            pass  # damaged or missing slice file: rebuild the split
        else:
            # resumed slices keep their original trace ids (their root
            # spans live in the same rundir ledger); docs from before
            # tracing get fresh ones so no slice ever runs untraced
            for sl in doc["slices"]:
                if not sl.get("trace"):
                    sl["trace"] = observe.mint_trace(
                        "slice", slice_name(sl["sid"])
                    )
            observe.emit(
                "elastic_split",
                {"slices": len(doc["slices"]), "families": doc["families"],
                 "records": doc["records"], "resumed": True},
            )
            return doc["slices"]

    # a rebuild over the same input reuses each slice's prior trace
    # context when the rebuilt slice is byte-identical — the rebuilt
    # file is the same unit of work, and its earlier root span already
    # lives in this rundir's ledger
    prior_traces: dict = {}
    if doc and doc.get("input_fingerprint") == fp:
        prior_traces = {
            (sl["path"], sl["family_crc"], sl["input_crc"]): sl["trace"]
            for sl in doc.get("slices", [])
            if sl.get("trace")
        }

    # pass 1: base-family ordinals in first-seen order (= the order the
    # single-process grouped stream meets them)
    ordinals: dict[str, int] = {}
    records = 0
    with BamReader(bam_path) as reader:
        header = reader.header
        for rec in reader:
            if not rec.has_tag("MI"):
                raise ElasticError(
                    "elastic runs shard by MI family and need grouped "
                    f"input (record {rec.qname!r} carries no MI tag) — "
                    "run the grouping pre-stage first (group_umis=always) "
                    "and hand the grouped BAM to `cli elastic run`"
                )
            fam = base_mi(str(rec.get_tag("MI")))
            if fam not in ordinals:
                ordinals[fam] = len(ordinals)
            records += 1
    families = len(ordinals)
    if not families:
        raise ElasticError(f"no records in {bam_path!r} — nothing to shard")
    n = max(1, min(n_slices, families))
    bounds = [families * i // n for i in range(n + 1)]

    # pass 2: write each record to the slice owning its family ordinal
    paths = [os.path.join(slicedir, f"{slice_name(s)}.bam") for s in range(n)]
    counts = [0] * n
    writers = [BamWriter(p + ".tmp", header, level=1) for p in paths]
    try:
        with BamReader(bam_path) as reader:
            for rec in reader:
                o = ordinals[base_mi(str(rec.get_tag("MI")))]
                s = bisect.bisect_right(bounds, o) - 1
                writers[s].write(rec)
                counts[s] += 1
    finally:
        for w in writers:
            w.close()
    for p in paths:
        os.replace(p + ".tmp", p)

    fam_ids = sorted(ordinals, key=ordinals.get)
    slices = []
    for s in range(n):
        members = fam_ids[bounds[s]:bounds[s + 1]]
        rel_path = os.path.join("slices", f"{slice_name(s)}.bam")
        family_crc = (
            zlib.crc32("\x00".join(members).encode()) & 0xFFFFFFFF
        )
        input_crc = _integrity.file_crc32(paths[s])
        slices.append({
            "sid": s,
            "path": rel_path,
            "records": counts[s],
            "families": len(members),
            "family_crc": family_crc,
            "input_crc": input_crc,
            # the split is the slice's admission: its trace context is
            # minted here, persisted in slices.json, and shipped inside
            # every lease grant — one causal tree per slice across
            # coordinator, every holder, and the merge; a byte-identical
            # rebuild keeps the prior context
            "trace": prior_traces.get((rel_path, family_crc, input_crc))
            or observe.mint_trace("slice", slice_name(s)),
        })
    _save_json_atomic(doc_path, {
        "input_fingerprint": fp,
        "n_slices_requested": n_slices,
        "records": records,
        "families": families,
        "slices": slices,
    })
    observe.emit(
        "elastic_split",
        {"slices": n, "families": families, "records": records,
         "resumed": False},
    )
    return slices


# -------------------------------------------------------------------- ledger


class SliceLedger:
    """Lease table over the durable slice state. Every mutation holds
    the one lock; durable commits (manifest writes) happen outside it.
    Restart-safe by construction: __init__ rescans the slice dirs and
    enqueues only slices without a verified committed manifest."""

    def __init__(self, rundir: str, slices: list[dict],
                 lease_s: float | None = None):
        self.rundir = rundir
        self.slices = {sl["sid"]: sl for sl in slices}
        self.lease_s = lease_s if lease_s is not None else lease_seconds()
        self._lock = threading.Lock()
        self._pending: deque[int] = deque()
        self._leases: dict[str, dict] = {}
        self._done: dict[int, dict] = {}
        self._seq = 0
        #: fence epochs: one minted (and persisted) per lease grant, so
        #: a slice's CURRENT holder always outranks every prior holder —
        #: and a restarted coordinator resumes above all of them
        self.book = _fencing.EpochBook(rundir)
        self._slice_epoch: dict[int, int] = {}
        self.requeues = 0
        self.workers_lost = 0
        self.preempts = 0
        self.workers: set[str] = set()
        for sl in slices:
            m = self._verified_manifest(sl)
            if m is not None:
                self._done[sl["sid"]] = m
            else:
                self._pending.append(sl["sid"])
        if self._done:
            observe.emit(
                "elastic_ledger_resumed",
                {"done": len(self._done), "pending": len(self._pending)},
            )

    def _slice_dir(self, sid: int) -> str:
        return os.path.join(self.rundir, "slices", slice_name(sid))

    def _manifest_path(self, sid: int) -> str:
        return os.path.join(self._slice_dir(sid), MANIFEST_NAME)

    def _verified_manifest(self, sl: dict) -> dict | None:
        """A committed manifest counts only if its family fingerprint
        matches this split AND its output bytes still verify."""
        m = _load_json(self._manifest_path(sl["sid"]))
        if not m or m.get("family_crc") != sl["family_crc"]:
            return None
        out = os.path.join(self._slice_dir(sl["sid"]), m.get("output", ""))
        try:
            _integrity.verify_file_crc32(
                out, int(m.get("crc", -1)),
                what=f"slice {slice_name(sl['sid'])} output",
            )
        except (OSError, ValueError):
            return None
        return m

    # -- worker-facing ops ----------------------------------------------

    def join(self, worker: str) -> None:
        with self._lock:
            fresh = worker not in self.workers
            self.workers.add(worker)
        if fresh:
            observe.emit("elastic_join", {"worker": worker})

    def lease(self, worker: str) -> dict:
        """Grant the next pending slice, or report wait/done. The grant
        carries the lease id + duration the holder must renew against —
        and echo back at publish."""
        with self._lock:
            if not self._pending:
                if not self._leases and len(self._done) == len(self.slices):
                    return {"done": True}
                return {"wait": True}
            sid = self._pending.popleft()
            self._seq += 1
            lease_id = f"{slice_name(sid)}.{self._seq}"
            # the fence epoch is durable BEFORE the grant leaves: a
            # restarted coordinator can never re-mint an epoch some
            # zombie already holds
            epoch = self.book.mint()
            self._slice_epoch[sid] = epoch
            self._leases[lease_id] = {
                "sid": sid,
                "worker": worker,
                "epoch": epoch,
                "expires": time.monotonic() + self.lease_s,
            }
            grant = {
                "slice": dict(self.slices[sid]),
                "lease_id": lease_id,
                "lease_s": self.lease_s,
                "fence_epoch": epoch,
            }
        # the slice's trace context ships inside the grant (the slice
        # dict carries it); the lease line itself is stamped so the
        # grant joins the slice's causal tree
        with observe.bind_trace(grant["slice"].get("trace")):
            observe.emit(
                "elastic_lease",
                {"slice": slice_name(sid), "worker": worker,
                 "lease_id": lease_id, "epoch": epoch},
            )
        return grant

    def slice_epoch(self, sid: int) -> int | None:
        """The epoch of the slice's CURRENT (latest) grant."""
        with self._lock:
            return self._slice_epoch.get(sid)

    def heartbeat(self, worker: str, lease_id: str) -> bool:
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease["worker"] != worker:
                return False
            lease["expires"] = time.monotonic() + self.lease_s
            return True

    def commit(self, lease_id: str, sid: int, manifest: dict,
               worker: str = "", epoch: int | None = None) -> dict:
        """Publish: validate the fence epoch, the lease, and the
        fingerprint, verify the output bytes, then commit the manifest
        atomically. A publish carrying an epoch below the slice's
        current grant is a ZOMBIE — refused with `publish_fenced` even
        when its bytes happen to match (precedence over the duplicate
        path: a superseded holder gets a typed refusal, not an "ok"
        that invites it to keep writing). A publish under a merely
        lapsed lease is refused (its slice was requeued; the durable
        checkpoint keeps the work) unless the requeued twin already
        committed identical output."""
        fenced_current: int | None = None
        with self._lock:
            current = self._slice_epoch.get(sid)
            if (epoch is not None and current is not None
                    and int(epoch) < current):
                fenced_current = current
            else:
                lease = self._leases.get(lease_id)
                if lease is None or lease["sid"] != sid:
                    done = self._done.get(sid)
                    if (done is not None
                            and done.get("crc") == manifest.get("crc")):
                        return {"ok": True, "duplicate": True}
                    return {"ok": False, "reason": "lease_expired"}
                sl = self.slices.get(sid)
        if fenced_current is not None:
            _fencing.emit_publish_fenced(
                slice_name(sid), worker, int(epoch), fenced_current,
                trace=(self.slices.get(sid) or {}).get("trace"),
            )
            return {"ok": False, "reason": "fenced", "epoch": fenced_current}
        if sl is None:
            return {"ok": False, "reason": "unknown_slice"}
        if manifest.get("family_crc") != sl["family_crc"]:
            return {"ok": False, "reason": "fingerprint_mismatch"}
        out = os.path.join(self._slice_dir(sid), str(manifest.get("output")))
        try:
            _integrity.verify_file_crc32(
                out, int(manifest.get("crc", -1)),
                what=f"slice {slice_name(sid)} output",
            )
        except (OSError, ValueError) as exc:
            return {"ok": False, "reason": f"output_integrity: {exc}"}
        _failpoints.fire("elastic_manifest_commit", slice=slice_name(sid))
        _save_json_atomic(self._manifest_path(sid), manifest)
        with self._lock:
            self._leases.pop(lease_id, None)
            self._done[sid] = manifest
        # the slice trace's terminal event: `observe check` requires
        # every slice tree to reach one of these
        with observe.bind_trace(sl.get("trace")):
            observe.emit(
                "elastic_slice_done",
                {"slice": slice_name(sid),
                 "worker": worker or str(manifest.get("worker", "")),
                 "records": manifest.get("records_out")},
            )
        return {"ok": True}

    # -- liveness --------------------------------------------------------

    def _requeue_locked(self, lease: dict, reason: str) -> None:
        sid = lease["sid"]
        self._pending.appendleft(sid)
        self.requeues += 1
        # the killed holder's trace continues, not dangles: this requeue
        # line carries the SAME slice trace, and the next holder's spans
        # join the same tree (chaos-drill trace-completeness gate)
        with observe.bind_trace((self.slices.get(sid) or {}).get("trace")):
            observe.emit(
                "slice_requeued",
                {"slice": slice_name(sid), "worker": lease["worker"],
                 "reason": reason, "batches_kept": self._batches_kept(sid)},
            )

    def _batches_kept(self, sid: int) -> int:
        """Batches the lost worker left durable in the slice's stage
        checkpoints — the prefix the next holder keeps (its resume
        re-verifies every shard CRC; a corrupt shard truncates the
        prefix further, pipeline.checkpoint._verify_shards)."""
        total = 0
        try:
            names = os.listdir(self._slice_dir(sid))
        except OSError:
            return 0
        for name in names:
            if name.endswith(".ckpt.json"):
                m = _load_json(os.path.join(self._slice_dir(sid), name))
                total += int((m or {}).get("batches_done") or 0)
        return total

    def expire_scan(self) -> int:
        """Requeue every lapsed lease; returns how many. A lapsed lease
        means the holder stopped renewing — hung or dead either way, it
        is presumed lost."""
        now = time.monotonic()
        with self._lock:
            expired = [
                (lid, lease) for lid, lease in self._leases.items()
                if lease["expires"] <= now
            ]
            for lid, lease in expired:
                self._leases.pop(lid)
                self.workers_lost += 1
                observe.emit(
                    "worker_lost",
                    {"worker": lease["worker"], "reason": "lease_expired",
                     "leases": 1},
                )
                self._requeue_locked(lease, "lease_expired")
        return len(expired)

    def preempt(self, worker: str, lease_id: str, sid: int,
                batches_kept: int = 0, epoch: int | None = None) -> dict:
        """Voluntary drain-and-handoff: the holder finished its
        in-flight batch, flushed the checkpoint prefix durable, and is
        handing the lease back BEFORE exiting — so the slice requeues
        immediately instead of waiting out `lease_s` expiry. The next
        grant mints a higher fence epoch, which revokes the departed
        holder exactly as a crash would; a handoff carrying a stale
        epoch is itself a zombie and is refused `fenced` with the same
        precedence the publish path enforces (fence before lease
        bookkeeping)."""
        fenced_current: int | None = None
        with self._lock:
            current = self._slice_epoch.get(sid)
            if (epoch is not None and current is not None
                    and int(epoch) < current):
                fenced_current = current
            else:
                lease = self._leases.get(lease_id)
                if (lease is None or lease["sid"] != sid
                        or lease["worker"] != worker):
                    # lapsed (or already requeued) before the handoff
                    # landed: nothing to release — the expiry path
                    # already did the work this op would have
                    return {"ok": False, "reason": "lease_expired"}
                self._leases.pop(lease_id)
                self.preempts += 1
                with observe.bind_trace(
                    (self.slices.get(sid) or {}).get("trace")
                ):
                    observe.emit(
                        "worker_preempted",
                        {"worker": worker, "reason": "handoff",
                         "slice": slice_name(sid),
                         "batches_kept": int(batches_kept)},
                    )
                self._requeue_locked(lease, "preempted")
        if fenced_current is not None:
            _fencing.emit_publish_fenced(
                slice_name(sid), worker, int(epoch), fenced_current,
                trace=(self.slices.get(sid) or {}).get("trace"),
            )
            return {"ok": False, "reason": "fenced", "epoch": fenced_current}
        return {"ok": True}

    def note_worker_dead(self, worker: str) -> None:
        """Supervisor fast path: a reaped worker process requeues its
        leases immediately instead of waiting out the lease clock."""
        with self._lock:
            held = [
                (lid, lease) for lid, lease in self._leases.items()
                if lease["worker"] == worker
            ]
            self.workers_lost += 1
            observe.emit(
                "worker_lost",
                {"worker": worker, "reason": "process_exit",
                 "leases": len(held)},
            )
            for lid, lease in held:
                self._leases.pop(lid)
                self._requeue_locked(lease, "worker_lost")

    # -- progress --------------------------------------------------------

    def all_done(self) -> bool:
        with self._lock:
            return len(self._done) == len(self.slices)

    def has_pending(self) -> bool:
        with self._lock:
            return bool(self._pending)

    def counts(self) -> dict:
        with self._lock:
            return {
                "slices": len(self.slices),
                "done": len(self._done),
                "pending": len(self._pending),
                "leased": len(self._leases),
                "requeues": self.requeues,
                "workers_lost": self.workers_lost,
                "preempts": self.preempts,
                "workers": len(self.workers),
            }

    def manifests(self) -> dict[int, dict]:
        with self._lock:
            return dict(self._done)


# -------------------------------------------------------------------- server


class Coordinator(ProtocolServer):
    """Framed-transport front of one SliceLedger: the elastic op table
    over the same accept/refuse machinery every serve front shares
    (typed TransportError refusals, TLS via the serve env vars)."""

    def __init__(self, ledger: SliceLedger, cfg_doc: dict, *,
                 addresses, ready_file: str | None = None,
                 ship: bool = False):
        super().__init__(addresses=addresses, ready_file=ready_file)
        self.ledger = ledger
        self.cfg_doc = cfg_doc
        #: shared-nothing mode: workers fetch slice input and push
        #: output over the wire instead of touching the rundir — the
        #: flag rides the elastic_join reply, so `--join` workers on
        #: another host need no local configuration
        self.ship = ship
        #: in-flight pushed-output streams: sid -> {epoch, name,
        #: received}; a higher-epoch holder restarts the stream, a
        #: mismatched offset answers a resync instead of corrupting it
        self._push: dict[int, dict] = {}
        self._push_lock = threading.Lock()
        self._monitor_stop = threading.Event()
        self._monitor_thread: threading.Thread | None = None

    def start_monitor(self, interval_s: float = 0.25) -> None:
        if self._monitor_thread is not None:
            return
        # lease-expiry pump: it only calls
        # the lock-guarded ledger API on a fixed cadence
        # graftlint: owned-thread -- lease-expiry pump: it only calls
        # the lock-guarded ledger API on a fixed cadence
        self._monitor_thread = threading.Thread(
            target=self._monitor, args=(interval_s,),
            name="elastic-lease-monitor", daemon=True,
        )
        self._monitor_thread.start()

    def _monitor(self, interval_s: float) -> None:
        while not self._monitor_stop.wait(interval_s):
            self.ledger.expire_scan()

    def _on_drain(self) -> None:
        self._monitor_stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5.0)

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pong": True}
        if op == "elastic_join":
            worker = str(req.get("worker") or "")
            self.ledger.join(worker)
            return {
                "ok": True,
                "rundir": self.ledger.rundir,
                "cfg": self.cfg_doc,
                "slices": len(self.ledger.slices),
                "lease_s": self.ledger.lease_s,
                "ship": self.ship,
            }
        if op == "lease":
            return {"ok": True, **self.ledger.lease(str(req.get("worker") or ""))}
        if op == "heartbeat":
            ok = self.ledger.heartbeat(
                str(req.get("worker") or ""), str(req.get("lease_id") or "")
            )
            if not ok:
                return {"ok": False, "reason": "lease_expired"}
            return {"ok": True, "lease_s": self.ledger.lease_s}
        if op == "publish":
            epoch = req.get("epoch")
            return self.ledger.commit(
                str(req.get("lease_id") or ""),
                int(req.get("slice", -1)),
                req.get("manifest") or {},
                worker=str(req.get("worker") or ""),
                epoch=int(epoch) if epoch is not None else None,
            )
        if op == "preempt":
            epoch = req.get("epoch")
            return self.ledger.preempt(
                str(req.get("worker") or ""),
                str(req.get("lease_id") or ""),
                int(req.get("slice", -1)),
                batches_kept=int(req.get("batches_kept") or 0),
                epoch=int(epoch) if epoch is not None else None,
            )
        if op == "slice_fetch":
            return self._slice_fetch(req)
        if op == "slice_push":
            return self._slice_push(req)
        if op == "status":
            return {"ok": True, **self.ledger.counts()}
        if op == "metrics":
            c = self.ledger.counts()
            return {"ok": True, "metrics": {
                "component": "coordinator",
                "slices": c["slices"],
                "slices_done": c["done"],
                "lease_backlog": c["pending"],
                "outstanding_leases": c["leased"],
                "workers": c["workers"],
                "counters": {
                    "requeues": c["requeues"],
                    "workers_lost": c["workers_lost"],
                    "preempts": c["preempts"],
                },
            }}
        return {"ok": False, "error": f"unknown op {op!r}"}

    # -- shared-nothing slice shipping -----------------------------------

    def _slice_fetch(self, req: dict) -> dict:
        """One bounded chunk of a slice input BAM, CRC'd per chunk. The
        op is stateless and read-only: resume after a dropped connection
        is the client re-asking for the same offset. Replies opt out of
        the rid reply cache (`_nocache`) — re-fetching is safe and the
        cache must stay small."""
        sid = int(req.get("slice", -1))
        sl = self.ledger.slices.get(sid)
        if sl is None:
            return {"ok": False, "error": f"unknown slice {sid}"}
        offset = max(0, int(req.get("offset", 0)))
        path = os.path.join(self.ledger.rundir, sl["path"])
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                fh.seek(offset)
                data = fh.read(chunk_bytes())
        except OSError as exc:
            return {"ok": False, "error": f"slice_fetch: {exc}"}
        return {
            "ok": True,
            "offset": offset,
            "size": size,
            "eof": offset + len(data) >= size,
            "crc": zlib.crc32(data) & 0xFFFFFFFF,
            "data": base64.b64encode(data).decode("ascii"),
            "_nocache": True,
        }

    def _slice_push(self, req: dict) -> dict:
        """One bounded chunk of a slice OUTPUT, shipped back by the
        holder. Fenced like publish: a chunk carrying a stale epoch is
        refused (`publish_fenced`) so a zombie can never race the
        requeued holder's stream. The stream is strictly sequential —
        a chunk at the wrong offset answers the authoritative
        `received` byte count (resync) instead of writing, which makes
        duplicate and retried chunks idempotent at chunk granularity."""
        sid = int(req.get("slice", -1))
        worker = str(req.get("worker") or "")
        sl = self.ledger.slices.get(sid)
        if sl is None:
            return {"ok": False, "error": f"unknown slice {sid}"}
        epoch = req.get("epoch")
        current = self.ledger.slice_epoch(sid)
        if epoch is not None and current is not None and int(epoch) < current:
            _fencing.emit_publish_fenced(
                slice_name(sid), worker, int(epoch), current,
                trace=sl.get("trace"),
            )
            return {"ok": False, "reason": "fenced", "epoch": current}
        name = os.path.basename(str(req.get("name") or ""))
        if not name:
            return {"ok": False, "error": "slice_push without a name"}
        try:
            data = base64.b64decode(str(req.get("data") or ""))
        except ValueError:
            return {"ok": False, "reason": "chunk_integrity"}
        if (zlib.crc32(data) & 0xFFFFFFFF) != int(req.get("crc", -1)):
            return {"ok": False, "reason": "chunk_integrity"}
        offset = int(req.get("offset", 0))
        sdir = self.ledger._slice_dir(sid)
        os.makedirs(sdir, exist_ok=True)
        part = os.path.join(sdir, f".push.{name}")
        with self._push_lock:
            st = self._push.get(sid)
            if st is None or st.get("epoch") != epoch or st.get("name") != name:
                # a new holder (or a new attempt) restarts the stream
                st = {"epoch": epoch, "name": name, "received": 0}
                self._push[sid] = st
                with open(part, "wb"):
                    pass
            if offset != st["received"]:
                return {"ok": True, "received": st["received"],
                        "resync": True}
            with open(part, "ab") as fh:
                fh.write(data)
            st["received"] += len(data)
            received = st["received"]
            if req.get("eof"):
                os.replace(part, os.path.join(sdir, name))
                self._push.pop(sid, None)
        return {"ok": True, "received": received}


# ----------------------------------------------------------------- run front


def _check_runnable(cfg: FrameworkConfig) -> None:
    """Loud scope refusals: elastic covers the self-mode molecular →
    duplex chain; anything narrower must say so instead of producing
    output that silently differs from the single-process run."""
    problems = []
    if cfg.aligner != "self":
        problems.append(
            f"aligner={cfg.aligner!r} (elastic runs the self-mode "
            "molecular->duplex chain only)"
        )
    if getattr(cfg, "filter", None):
        problems.append("the filter stage is single-process only")
    if getattr(cfg, "single_strand", False):
        problems.append("single_strand consensus is single-process only")
    if getattr(cfg, "methyl", "off") != "off":
        problems.append(
            "methyl tallies are per-process accumulators with no "
            "cross-worker merge yet (methyl=off to run elastic)"
        )
    if problems:
        raise ElasticError("elastic run refused: " + "; ".join(problems))


def _run_inline(cfg: FrameworkConfig, ledger: SliceLedger) -> None:
    """Sequential in-process execution of every pending slice — the
    tier-1 test mode. Byte-identity is concurrency-independent (the
    merge consumes committed slice outputs in slice order), so inline
    runs pin exactly the bytes the subprocess fleet produces."""
    from bsseqconsensusreads_tpu_torch.elastic import worker as _worker

    wid = os.environ.get(ENV_WORKER_ID) or "inline"
    while True:
        grant = ledger.lease(wid)
        if grant.get("done"):
            return
        if grant.get("wait"):
            ledger.expire_scan()
            time.sleep(0.01)
            continue
        # same trace discipline as the subprocess worker: the slice's
        # spans land on its causal tree even in inline mode
        slice_trace = grant["slice"].get("trace")
        with observe.bind_trace(slice_trace):
            manifest = _worker.process_slice(
                cfg, ledger.rundir, grant["slice"], worker=wid
            )
        resp = ledger.commit(
            grant["lease_id"], grant["slice"]["sid"], manifest, worker=wid,
            epoch=grant.get("fence_epoch"),
        )
        if not resp.get("ok"):
            # lapsed lease: the slice went back to pending and the next
            # loop pass resumes it from its checkpoint
            if resp.get("reason") == "lease_expired":
                continue
            raise ElasticError(f"inline commit refused: {resp}")


def _run_fleet(
    ledger: SliceLedger,
    cfg_doc_: dict,
    *,
    workers: int,
    address: str,
    worker_failpoints: dict,
    max_restarts: int,
    timeout_s: float,
    ship: bool = False,
) -> None:
    """Coordinator in-process + N worker subprocesses (the fleet spawn
    idiom: identity env var, one-shot first-life failpoint override,
    respawn budget).

    The supervisor is itself preemptible: SIGTERM/SIGINT latch an
    interrupt; the loop then SIGTERMs every worker (each does its own
    voluntary drain-and-handoff), reaps the children inside the grace
    budget (kill on lapse — no orphans either way), stops respawning,
    and raises with the ledger counts. The ledger is durable truth, so
    the interrupted run is resumable: rerunning against the same outdir
    rescans committed manifests and requeues only unfinished slices."""
    server = Coordinator(ledger, cfg_doc_, addresses=[address], ship=ship)
    server.start_monitor()
    # the accept loop owns the socket; this
    # thread exists so the supervisor below can poll worker processes
    # graftlint: owned-thread -- the accept loop owns the socket; this
    # thread exists so the supervisor below can poll worker processes
    thread = threading.Thread(
        target=server.serve_forever, name="elastic-coordinator", daemon=True
    )
    thread.start()
    deadline = time.monotonic() + timeout_s
    interrupted = threading.Event()
    prev_handlers: dict[int, object] = {}

    def _on_signal(signum, frame):  # pragma: no cover - signal context
        interrupted.set()

    for _sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[_sig] = signal.signal(_sig, _on_signal)
        except ValueError:
            # not the main thread (library/test embedding): the caller
            # owns signal routing; drain still works via the ledger API
            break
    try:
        while not server.bound:
            if time.monotonic() > deadline:
                raise ElasticError("coordinator failed to bind in time")
            time.sleep(0.02)
        addr = server.bound[0]
        fail_once = dict(worker_failpoints)
        logdir = os.path.join(ledger.rundir, "workers")
        procs: dict[str, subprocess.Popen | None] = {}
        restarts: dict[str, int] = {}

        def spawn(wid: str) -> None:
            env = dict(os.environ)
            env[ENV_WORKER_ID] = wid
            env[ENV_COORDINATOR_ADDR] = addr
            # the worker books its own spawn→join 'worker_spawn' span
            # against this instant (same-host wall clock)
            env[ENV_SPAWNED_AT] = repr(time.time())
            # failpoints arm per worker FIRST LIFE only (the chaos
            # drill's kill must not be inherited by the respawn — or by
            # every worker when the parent itself is under failpoints)
            schedule = fail_once.pop(wid, None)
            if schedule:
                env["BSSEQ_TPU_FAILPOINTS"] = schedule
            else:
                env.pop("BSSEQ_TPU_FAILPOINTS", None)
            os.makedirs(logdir, exist_ok=True)
            with open(os.path.join(logdir, f"{wid}.log"), "ab") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "bsseqconsensusreads_tpu_torch",
                     "elastic", "worker", "--join", addr],
                    env=env, stdout=subprocess.DEVNULL, stderr=log,
                )
            procs[wid] = proc
            observe.emit(
                "elastic_worker_spawn",
                {"worker": wid, "pid": proc.pid,
                 "generation": restarts.get(wid, 0)},
            )

        for i in range(workers):
            wid = f"w{i}"
            restarts[wid] = 0
            spawn(wid)

        def drain_children() -> None:
            """SIGTERM every live worker (voluntary handoff), then reap
            inside the grace budget — kill on lapse. No orphans."""
            for proc in procs.values():
                if proc is not None and proc.poll() is None:
                    proc.terminate()
            reap_by = time.monotonic() + _preempt.grace_s()
            for wid, proc in list(procs.items()):
                if proc is None:
                    continue
                try:
                    proc.wait(timeout=max(0.5, reap_by - time.monotonic()))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10.0)
                procs[wid] = None

        while not ledger.all_done():
            if interrupted.is_set():
                drain_children()
                raise ElasticError(
                    "elastic run interrupted: workers drained and "
                    f"reaped, ledger resumable at {ledger.rundir} — "
                    f"{ledger.counts()}"
                )
            if time.monotonic() > deadline:
                raise ElasticError(
                    f"elastic run timed out ({timeout_s:.0f}s) with "
                    f"{ledger.counts()}"
                )
            for wid, proc in list(procs.items()):
                if proc is None or proc.poll() is None:
                    continue
                rc = proc.returncode
                procs[wid] = None
                if rc != 0:
                    ledger.note_worker_dead(wid)
                if ledger.all_done():
                    continue
                if restarts[wid] < max_restarts and not interrupted.is_set():
                    restarts[wid] += 1
                    spawn(wid)
            if all(p is None for p in procs.values()) and not ledger.all_done():
                raise ElasticError(
                    "all workers exited with work pending "
                    f"(restart budget {max_restarts} exhausted): "
                    f"{ledger.counts()}"
                )
            time.sleep(0.05)

        # every slice durable: live workers see done=True and exit 0
        for proc in procs.values():
            if proc is None:
                continue
            try:
                proc.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
    finally:
        for _sig, prev in prev_handlers.items():
            try:
                signal.signal(_sig, prev)
            except (ValueError, TypeError):
                pass
        server.request_drain()
        thread.join(timeout=10.0)


def run_elastic(
    cfg: FrameworkConfig,
    bam_path: str,
    outdir: str = "output",
    *,
    workers: int = 2,
    slices: int = 0,
    address: str = "tcp:127.0.0.1:0",
    inline: bool = False,
    worker_failpoints: dict | None = None,
    max_restarts: int = 2,
    lease_s: float | None = None,
    timeout_s: float = 3600.0,
    ship: bool = False,
) -> tuple[str, dict]:
    """One elastic run end to end: split → lease/execute → merge →
    reconcile. Returns (final target path, reconciliation report).
    Raises ElasticError when the counters refuse to reconcile — a
    faster wrong answer is not a result."""
    _check_runnable(cfg)
    os.makedirs(outdir, exist_ok=True)
    rundir = os.path.join(outdir, "elastic")
    os.makedirs(rundir, exist_ok=True)
    n_slices = slices if slices >= 1 else max(1, workers) * 4
    t0 = time.monotonic()
    specs = split_input(bam_path, rundir, n_slices)
    doc = config_doc(cfg)
    _save_json_atomic(os.path.join(rundir, CFG_DOC), doc)
    ledger = SliceLedger(rundir, specs, lease_s=lease_s)
    if inline or workers < 1:
        if ship:
            raise ElasticError(
                "--ship needs a worker fleet: shared-nothing shipping "
                "is meaningless inside one process (drop --inline)"
            )
        _run_inline(cfg, ledger)
    else:
        _run_fleet(
            ledger, doc,
            workers=workers, address=address,
            worker_failpoints=worker_failpoints or {},
            max_restarts=max_restarts, timeout_s=timeout_s,
            ship=ship,
        )
    from bsseqconsensusreads_tpu_torch.elastic import merge as _merge

    # merge is a run-level overhead bucket: booked on the proc trace so
    # `observe trace` can rank it against spawn/import/compile
    with observe.span("merge", ctx=observe.proc_trace()):
        target, report = _merge.finalize(cfg, bam_path, outdir, specs,
                                         ledger.manifests())
    report["requeues"] = ledger.requeues
    report["workers_lost"] = ledger.workers_lost
    report["preempts"] = ledger.preempts
    report["wall_s"] = round(time.monotonic() - t0, 3)
    observe.emit(
        "elastic_run_complete",
        {"slices": len(specs), "records": report["records"],
         "requeues": ledger.requeues, "workers_lost": ledger.workers_lost,
         "ok": report["ok"]},
    )
    observe.flush_sinks()
    if not report["ok"]:
        raise ElasticError(
            f"elastic run did not reconcile: {report['checks']}"
        )
    return target, report
