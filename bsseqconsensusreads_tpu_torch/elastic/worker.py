"""graftswarm worker: the thin process side of `cli elastic`.

A worker is deliberately boring — it joins a coordinator, then loops
lease → run the EXISTING pipeline/stages.py chain over the leased
slice → publish a manifest. All elastic intelligence (splitting,
requeue, merge, reconciliation) lives coordinator-side; this module
adds nothing to the science path, which is the whole byte-identity
argument: the records a slice emits are the records the single-process
run emits for those families, produced by the same code.

Per slice the worker runs `run_pipeline` in a SLICE-KEYED work dir
(`<rundir>/slices/s<NNNN>/`). Keying by slice rather than worker is
the loss-recovery mechanism: when a lease lapses and the slice is
requeued, the next holder resumes from the same dir, where
BatchCheckpoint keeps the longest verified CRC shard prefix and
recomputes only the remainder — the dead worker's finished batches are
never redone and never double-emitted.

The published manifest carries the slice's family fingerprint, output
CRC, per-stage StageStats, and the per-bucket record counts of its
coordinate-bucketed output (BucketPlan over the final header), which
the coordinator's merge reconciles against the merged stream before
the run may call itself ok.
"""

from __future__ import annotations

import base64
import dataclasses
import os
import random
import shutil
import tempfile
import threading
import time
import zlib

from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.io.bam import BamReader
from bsseqconsensusreads_tpu_torch.parallel.multihost import WorkerHeartbeat
from bsseqconsensusreads_tpu_torch.pipeline import checkpoint as _checkpoint
from bsseqconsensusreads_tpu_torch.pipeline.bucketemit import (
    BucketPlan,
    blob_bucket_key,
    resolve_buckets,
)
from bsseqconsensusreads_tpu_torch.serve import transport
from bsseqconsensusreads_tpu_torch.utils import observe

from bsseqconsensusreads_tpu_torch.elastic import fencing as _fencing
from bsseqconsensusreads_tpu_torch.elastic import preempt as _preempt
from bsseqconsensusreads_tpu_torch.elastic.coordinator import (
    ENV_COORDINATOR_ADDR,
    ENV_SPAWNED_AT,
    ENV_WORKER_ID,
    ElasticError,
    chunk_bytes,
    config_from_doc,
    slice_name,
)

#: bounded per-chunk retries for the ship-mode transfers (each chunk is
#: one request on its own connection — a dropped connection costs one
#: chunk, not the stream)
CHUNK_RETRIES = 5

# where ship mode lands the fetched slice input inside the private work
# dir; _reset_stale_finals must never mistake it for a stage final
SHIP_INPUT = "input.bam"


def slice_config(cfg: FrameworkConfig) -> FrameworkConfig:
    """The per-slice pipeline config. Grouping is forced off (slices
    are cut FROM grouped input; regrouping a shard could renumber
    families), interstage streaming off (checkpointing requires the
    materialized interstage, stages._interstage_blocked), and
    checkpoints on — they are what makes requeue cheap."""
    return dataclasses.replace(
        cfg,
        group_umis="never",
        stream_interstage=False,
        checkpoint_every=cfg.checkpoint_every if cfg.checkpoint_every >= 1
        else 4,
    )


def _bucket_manifest(path: str, buckets: int) -> tuple[list[int], int]:
    """Per-bucket record counts of one coordinate-sorted slice output
    (the bucket engine's geometry over the output's own header). The merge
    recomputes the same vector over the merged stream; equality means
    no record moved buckets and none vanished."""
    with BamReader(path, threads=1) as reader:
        plan = BucketPlan.from_header(reader.header, buckets)
        counts = [0] * plan.nbuckets
        total = 0
        for blob in reader.raw_records():
            counts[plan.bucket_of(blob_bucket_key(blob))] += 1
            total += 1
    return counts, total


def _reset_stale_finals(sdir: str, sname: str, worker: str) -> None:
    """A leased slice has NO committed manifest (the coordinator only
    leases unverified slices), so a durable stage FINAL in its work dir
    is the orphan of a holder that died between a stage finalize and
    the manifest commit. Stage stats are not durable: resuming past
    such a final would skip the stage whole (mtime rerun semantics) and
    the published manifest could never reconcile its ingest counters
    against the split. Finals appear atomically (tmp+rename at
    ckpt_finalize), so their presence is exact — clear the work dir and
    recompute the slice. Mid-stage deaths leave .ckpt/.part shards,
    never a final, so the cheap batches_kept resume path is untouched."""
    stale = sorted(
        f for f in os.listdir(sdir)
        if f.endswith(".bam") and ".ckpt" not in f and ".part" not in f
        and f != SHIP_INPUT
    )
    if not stale:
        return
    for f in os.listdir(sdir):
        if f == SHIP_INPUT:
            # ship-mode fetched input: raw bytes, never a stage final
            continue
        path = os.path.join(sdir, f)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.unlink(path)
    observe.emit(
        "elastic_slice_reset",
        {"slice": sname, "worker": worker, "stale": stale},
    )


def _load_stack(cfg: FrameworkConfig):
    """Import the pipeline (and torch with it) and, on a card run, check
    the card and load the vote kernels' library through the locked build
    cache (ops.cuda_vote.build_library: one nvcc build however many workers share
    the card). A worker whose config names the card and cannot reach it
    raises here — it never carries on on the CPU. Returns run_pipeline."""
    from bsseqconsensusreads_tpu_torch.pipeline.stages import run_pipeline

    if cfg.backend == "cuda":
        from bsseqconsensusreads_tpu_torch.ops import cuda_vote
        from bsseqconsensusreads_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")
        cuda_vote._load()
    return run_pipeline


def process_slice(cfg: FrameworkConfig, rundir: str, sl: dict,
                  worker: str = "", workdir: str | None = None,
                  input_path: str | None = None) -> dict:
    """Run the standard pipeline chain over one leased slice; returns
    the publishable manifest. Work dir is keyed by SLICE id so a
    requeued slice resumes its own checkpoints — unless ship mode hands
    in a private `workdir` (and a locally fetched `input_path`), in
    which case nothing here touches the shared rundir at all."""
    sname = slice_name(sl["sid"])
    _failpoints.fire("elastic_slice", slice=sname, worker=worker)
    sdir = workdir or os.path.join(rundir, "slices", sname)
    os.makedirs(sdir, exist_ok=True)
    _reset_stale_finals(sdir, sname, worker)
    scfg = dataclasses.replace(slice_config(cfg), tmp=sdir)
    slice_bam = input_path or os.path.join(rundir, sl["path"])
    _integrity.verify_file_crc32(
        slice_bam, sl["input_crc"], what=f"slice input {sname}"
    )
    # deferred: run_pipeline pulls the torch stack in; workers that only
    # join/poll must stay cheap to import
    import_t0 = time.time()
    run_pipeline = _load_stack(scfg)
    if observe.stats_sink() is not None:
        # the 'jax_import' overhead bucket, under the JAX package's span
        # name so the two packages' `observe trace` tables compare row
        # for row: here it covers the pipeline's import, the card's check
        # and the kernel library's load (torch itself loads with the
        # worker's first imports, inside its worker_spawn span). Near-zero
        # after the first slice (all cached per process), so summing
        # dur_s reads as the one-time per-process cost
        observe.emit_span(
            "jax_import", import_t0, time.time(),
            ctx=observe.proc_trace(), worker=worker,
        )
    from bsseqconsensusreads_tpu_torch.ops import cuda_vote

    launches0 = dict(cuda_vote.LAUNCHES)
    t0 = time.monotonic()
    with observe.span("slice_pipeline", slice=sname, worker=worker):
        target, _results, stats = run_pipeline(scfg, slice_bam, outdir=sdir)
    wall_s = time.monotonic() - t0
    # the vote kernels this slice launched on the card (0 on a CPU run,
    # where the plain versions vote): the fleet's launches are the sum
    # of these lines over the workers' ledgers; with the worker's peak
    # of allocated device memory so far
    peak = 0
    if scfg.backend == "cuda":
        import torch

        peak = torch.cuda.max_memory_allocated()
    observe.emit("kernel_launches", {
        "slice": sname, "worker": worker, "backend": scfg.backend,
        **{k: v - launches0.get(k, 0) for k, v in cuda_vote.LAUNCHES.items()},
        "device_peak_bytes": peak,
    })
    buckets, records_out = _bucket_manifest(
        target, resolve_buckets(cfg.sort_buckets)
    )
    manifest = {
        "slice": sname,
        "worker": worker,
        "output": os.path.basename(target),
        "crc": _integrity.file_crc32(target),
        "family_crc": sl["family_crc"],
        "records_in": sl["records"],
        "records_out": records_out,
        "buckets": buckets,
        "wall_s": round(wall_s, 3),
        "stats": {stage: s.as_dict() for stage, s in stats.items()},
    }
    observe.emit(
        "elastic_slice_processed",
        {"slice": sname, "worker": worker, "records_out": records_out,
         "wall_s": manifest["wall_s"]},
    )
    return manifest


def _renew_lease(address: str, worker: str, lease_id: str, lease_s: float,
                 stop: threading.Event, hb: WorkerHeartbeat) -> None:
    """Renewal pump for one held lease, with deadline accounting that
    closes the delayed-heartbeat race: renewal extends the LOCAL
    deadline from the instant the frame was SENT, never from the reply
    — wire delay counts against this worker, so a heartbeat that lands
    coordinator-side after expiry can never leave the worker believing
    it still holds the lease. The cadence is a jittered third of the
    lease (±20%, seeded by the lease id) so a fleet's renewals never
    synchronize, and each request times out well inside the remaining
    lease instead of blocking past it.

    Losing the lease — a `lease_expired` renewal reply, or the local
    deadline passing with no successful renewal (partition) — revokes
    the adopted fence epoch: the compute thread aborts at its next
    durable write (FencedError) instead of racing the requeued holder."""
    rng = random.Random(lease_id)
    deadline = time.monotonic() + lease_s
    while True:
        interval = max(0.05, lease_s / 3.0 * (0.8 + 0.4 * rng.random()))
        if stop.wait(interval):
            return
        hb.beat(phase="lease_renew", lease_id=lease_id)
        t_send = time.monotonic()
        if t_send >= deadline:
            # nothing renewed inside the whole lease window: presume
            # requeued — self-fence without waiting to hear it refused
            _fencing.revoke(f"lease {lease_id} deadline passed unrenewed",
                            lease_id=lease_id)
            return
        try:
            resp = transport.request(
                address,
                {"op": "heartbeat", "worker": worker, "lease_id": lease_id},
                timeout=max(1.0, min(lease_s / 2.0, deadline - t_send)),
            )
        # graftlint: disable=unbounded-retry -- bounded by the local lease
        # deadline: the next tick self-fences and returns once it passes
        except (OSError, transport.TransportError):
            continue  # transient: retry, but the local deadline still runs
        if resp.get("ok"):
            deadline = t_send + lease_s
            continue
        # the coordinator says the lease is gone: immediate local abort
        _fencing.revoke(f"lease {lease_id} expired at the coordinator",
                        lease_id=lease_id)
        return


# ------------------------------------------------- shared-nothing shipping


def _fetch_slice(address: str, sl: dict, dest: str, worker: str = "") -> str:
    """Pull one slice input BAM over the wire as CRC-verified bounded
    chunks (`slice_fetch`). The op is stateless coordinator-side, so
    resume after any failure is simply re-asking for the same offset —
    each retry ledgers `slice_chunk_resent`. The assembled file lands
    via tmp+rename and process_slice re-verifies the whole-file CRC
    against the split manifest, so a torn fetch can never be computed."""
    sname = slice_name(sl["sid"])
    tmp = dest + ".part"
    offset = 0
    with open(tmp, "wb") as out:
        while True:
            attempt = 0
            while True:
                data = None
                try:
                    # graftlint: disable=unleased-work-dispatch,untraced-transport-send -- read-only
                    # chunk pull under the CALLER's lease (work_loop holds
                    # lease_id + the renewal pump) and the caller's bound
                    # slice trace (request ships `_trace` from the ambient
                    # context); nothing here dispatches work
                    resp = transport.request(
                        address,
                        {"op": "slice_fetch", "slice": sl["sid"],
                         "offset": offset, "worker": worker},
                        timeout=120.0,
                    )
                # graftlint: disable=unbounded-retry -- bounded: attempt
                # caps at CHUNK_RETRIES (raise) with linear backoff
                except (OSError, transport.TransportError):
                    resp = None
                if resp is not None and resp.get("ok"):
                    got = base64.b64decode(str(resp.get("data") or ""))
                    if (zlib.crc32(got) & 0xFFFFFFFF) == int(
                            resp.get("crc", -1)):
                        data = got
                if data is not None:
                    break
                attempt += 1
                if attempt >= CHUNK_RETRIES:
                    raise ElasticError(
                        f"slice_fetch for {sname} failed at offset {offset} "
                        f"after {CHUNK_RETRIES} attempts"
                    )
                observe.emit(
                    "slice_chunk_resent",
                    {"slice": sname, "offset": offset, "attempt": attempt},
                )
                time.sleep(0.05 * attempt)
            out.write(data)
            offset += len(data)
            if resp.get("eof"):
                break
    os.replace(tmp, dest)
    return dest


def _push_output(address: str, sid: int, lease_id: str, epoch,
                 target: str, worker: str = "") -> None:
    """Ship one slice output back as a strictly sequential chunk stream
    (`slice_push`). The coordinator answers its authoritative received
    byte count on any offset mismatch (resync), which makes retried and
    duplicated chunks idempotent at chunk granularity; a `fenced` reply
    means a newer holder owns the slice — raise FencedError so the loop
    aborts locally instead of racing it."""
    sname = slice_name(sid)
    name = os.path.basename(target)
    size = os.path.getsize(target)
    chunk = chunk_bytes()
    offset = 0
    with open(target, "rb") as fh:
        while True:
            fh.seek(offset)
            data = fh.read(chunk)
            eof = offset + len(data) >= size
            payload = {
                "op": "slice_push", "slice": sid, "lease_id": lease_id,
                "epoch": epoch, "name": name, "offset": offset,
                "data": base64.b64encode(data).decode("ascii"),
                "crc": zlib.crc32(data) & 0xFFFFFFFF, "eof": eof,
                "worker": worker,
            }
            attempt = 0
            while True:
                try:
                    resp = transport.request(address, payload, timeout=120.0)
                # graftlint: disable=unbounded-retry -- bounded: attempt
                # caps at CHUNK_RETRIES (raise) with linear backoff
                except (OSError, transport.TransportError):
                    resp = None
                if resp is not None and resp.get("reason") != "chunk_integrity":
                    break
                attempt += 1
                if attempt >= CHUNK_RETRIES:
                    raise ElasticError(
                        f"slice_push for {sname} failed at offset {offset} "
                        f"after {CHUNK_RETRIES} attempts"
                    )
                observe.emit(
                    "slice_chunk_resent",
                    {"slice": sname, "offset": offset, "attempt": attempt},
                )
                time.sleep(0.05 * attempt)
            if resp.get("ok"):
                if resp.get("resync"):
                    # the coordinator already holds bytes we don't think
                    # we sent (reply lost in flight): trust its count
                    offset = int(resp.get("received", 0))
                    continue
                if eof:
                    return
                offset += len(data)
                continue
            if resp.get("reason") == "fenced":
                raise _fencing.FencedError(
                    f"slice_push for {sname} refused: epoch {epoch} is "
                    f"stale (current {resp.get('epoch')})",
                    epoch=epoch if epoch is None else int(epoch),
                )
            raise ElasticError(f"slice_push refused: {resp}")


def _handoff(address: str, *, wid: str, sl: dict, lease_id: str, epoch,
             batches_kept: int, rundir: str, ship: bool,
             flag: "_preempt.PreemptFlag") -> None:
    """Voluntary drain-and-handoff after a PreemptedError: persist the
    handoff manifest (shared-rundir mode; ship successors refetch and
    resume nothing local), then release the lease with a `preempt` op
    so the coordinator requeues IMMEDIATELY instead of waiting out
    `lease_s`. Every step is best-effort under the grace budget — a
    lapse degrades to the crash path (lease expiry), never a hang."""
    sname = slice_name(sl["sid"])
    if not ship:
        _preempt.write_handoff(
            os.path.join(rundir, "slices", sname),
            slice_name=sname, worker=wid, batches_kept=batches_kept,
        )
    budget = flag.deadline() - time.monotonic()
    try:
        # bind the slice's trace so the preempt frame ships `_trace`
        # and the coordinator's requeue joins this attempt's causal tree
        slice_trace = sl.get("trace")
        with observe.bind_trace(slice_trace):
            resp = transport.request(
                address,
                {"op": "preempt", "worker": wid, "lease_id": lease_id,
                 "slice": sl["sid"], "epoch": epoch,
                 "batches_kept": batches_kept},
                timeout=max(1.0, min(30.0, budget)),
            )
    except (OSError, transport.TransportError):
        # the wire is gone too: exit anyway — the durable prefix is on
        # disk and lease expiry requeues the slice coordinator-side
        resp = {"ok": False, "reason": "unreachable"}
    latency = time.monotonic() - flag.requested_at()
    if resp.get("ok"):
        _preempt.emit_handoff_published(
            slice_name=sname, worker=wid, batches_kept=batches_kept,
            handoff_latency_s=latency,
        )
    else:
        observe.emit(
            "elastic_publish_refused",
            {"slice": sname, "worker": wid, "reason": "preempt_" + str(
                resp.get("reason") or "refused")},
        )


def work_loop(address: str, worker_id: str | None = None,
              poll_s: float = 0.2) -> int:
    """Join a coordinator and process leased slices until it says done.
    Returns the number of slices this process published.

    graftpreempt: SIGTERM latches a preemption instead of killing the
    process. Mid-slice, the checkpoint batch gate aborts at the next
    batch boundary (the interrupting batch flushed durable first) and
    the worker hands the slice back via the `preempt` op; idle or
    between slices, the worker simply stops leasing and exits 0."""
    _preempt.install_signal_handler()
    _checkpoint.install_batch_gate(_preempt.batch_gate())
    wid = worker_id or os.environ.get(ENV_WORKER_ID) or f"pid{os.getpid()}"
    os.environ[ENV_WORKER_ID] = wid
    os.environ[ENV_COORDINATOR_ADDR] = address
    joined = transport.request(
        address, {"op": "elastic_join", "worker": wid}, timeout=60.0
    )
    if not joined.get("ok"):
        raise ElasticError(f"join refused by {address}: {joined}")
    cfg = config_from_doc(joined["cfg"])
    rundir = joined["rundir"]
    lease_default = float(joined.get("lease_s") or 30.0)
    spawned_env = os.environ.pop(ENV_SPAWNED_AT, None)
    if spawned_env is not None and observe.stats_sink() is not None:
        # the supervisor stamped wall-clock spawn time into our env;
        # spawn → successful join is this process's worker_spawn bucket
        try:
            observe.emit_span(
                "worker_spawn", float(spawned_env), time.time(),
                ctx=observe.proc_trace(), worker=wid,
            )
        except ValueError:
            pass  # unparseable stamp: skip the span, never the worker
    ship = bool(joined.get("ship"))
    private_root: str | None = None
    if ship:
        # shared-nothing: every byte of slice input/output crosses the
        # wire; this tmpdir is the worker's ONLY filesystem footprint
        private_root = tempfile.mkdtemp(prefix=f"bsseq-ship-{wid}-")
    hb = WorkerHeartbeat(component="elastic")
    hb.start()
    processed = 0
    wait_t0: float | None = None
    try:
        while True:
            if _preempt.FLAG.pending():
                # preempted while holding nothing: no handoff to
                # publish, just stop leasing and exit clean
                return processed
            hb.beat(phase="lease_poll")
            grant = transport.request(
                address, {"op": "lease", "worker": wid}, timeout=60.0
            )
            if grant.get("done"):
                return processed
            if grant.get("wait") or "slice" not in grant:
                if wait_t0 is None:
                    wait_t0 = time.time()
                time.sleep(poll_s)
                continue
            if wait_t0 is not None:
                if observe.stats_sink() is not None:
                    # lease_wait overhead bucket: idle span between the
                    # last grant and this one (backlog starvation)
                    observe.emit_span(
                        "lease_wait", wait_t0, time.time(),
                        ctx=observe.proc_trace(), worker=wid,
                    )
                wait_t0 = None
            sl = grant["slice"]
            lease_id = grant["lease_id"]
            epoch = grant.get("fence_epoch")
            lease_s = float(grant.get("lease_s") or lease_default)
            sname = slice_name(sl["sid"])
            # adopt the grant's fence BEFORE any work: from here every
            # durable write goes through the fence gate, and losing the
            # lease turns into a local FencedError instead of a race
            _fencing.adopt(epoch, lease_id)
            stop = threading.Event()
            # lease-renewal pump for the
            # slice this loop iteration is processing; joined below
            # graftlint: owned-thread -- lease-renewal pump for the
            # slice this loop iteration is processing; joined below
            renewer = threading.Thread(
                target=_renew_lease,
                args=(address, wid, lease_id, lease_s, stop, hb),
                name=f"lease-renew-{lease_id}", daemon=True,
            )
            renewer.start()
            # the slice's trace ctx rode in on the grant; binding it here
            # puts process_slice's spans and the publish request (via the
            # wire's `_trace`) on the slice's causal tree
            slice_trace = sl.get("trace")
            with observe.bind_trace(slice_trace):
                try:
                    try:
                        if ship:
                            workdir = os.path.join(private_root, sname)
                            os.makedirs(workdir, exist_ok=True)
                            local_bam = _fetch_slice(
                                address, sl,
                                os.path.join(workdir, SHIP_INPUT),
                                worker=wid,
                            )
                            manifest = process_slice(
                                cfg, rundir, sl, worker=wid,
                                workdir=workdir, input_path=local_bam,
                            )
                        else:
                            manifest = process_slice(
                                cfg, rundir, sl, worker=wid
                            )
                    finally:
                        stop.set()
                        renewer.join(timeout=5.0)
                    if ship:
                        _push_output(
                            address, sl["sid"], lease_id, epoch,
                            os.path.join(workdir, manifest["output"]),
                            worker=wid,
                        )
                    # last local gate before publish: the renewer may
                    # have revoked after the final durable write
                    _fencing.check("publish")
                    _failpoints.fire("elastic_publish",
                                     slice=sname, worker=wid)
                    resp = transport.request(
                        address,
                        {"op": "publish", "worker": wid,
                         "lease_id": lease_id, "slice": sl["sid"],
                         "manifest": manifest, "epoch": epoch},
                        timeout=600.0,
                    )
                # graftlint: disable=unbounded-retry -- not a retry: the
                # slice is ABANDONED (the requeued holder owns it) and the
                # loop leases different work; the coordinator's `done`
                # reply is the bound
                except _fencing.FencedError as exc:
                    # the lease is gone (renewal refused, deadline lapsed
                    # behind a partition, or the coordinator fenced our
                    # push): abort the slice locally — the requeued
                    # holder owns it now — and lease fresh work
                    observe.emit(
                        "elastic_publish_refused",
                        {"slice": sname, "worker": wid,
                         "reason": "fence_revoked", "detail": str(exc)},
                    )
                    _fencing.release()
                    continue
                except _preempt.PreemptedError as exc:
                    # voluntary eviction: the batch gate stopped the
                    # slice at a durable batch boundary — hand the
                    # lease back explicitly and exit 0. Fencing keeps
                    # precedence: a revoked epoch raises FencedError
                    # from the handoff flush itself (caught above)
                    _handoff(
                        address, wid=wid, sl=sl, lease_id=lease_id,
                        epoch=epoch, batches_kept=exc.batches_kept,
                        rundir=rundir, ship=ship, flag=_preempt.FLAG,
                    )
                    _fencing.release()
                    return processed
                if resp.get("ok"):
                    _fencing.release()
                    processed += 1
                    continue
                if resp.get("reason") in ("lease_expired", "fenced"):
                    # our lease lapsed mid-slice and the slice was
                    # requeued; the durable checkpoints keep the work —
                    # go get a new lease (possibly for this same slice)
                    observe.emit(
                        "elastic_publish_refused",
                        {"slice": sname, "worker": wid,
                         "reason": str(resp.get("reason"))},
                    )
                    _fencing.release()
                    continue
                raise ElasticError(f"publish refused: {resp}")
    finally:
        _fencing.release()
        hb.stop()
        observe.flush_sinks()
        if private_root is not None:
            shutil.rmtree(private_root, ignore_errors=True)
