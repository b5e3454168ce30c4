"""Run-ledger consumers: summarize / diff / check (the `observe` CLI).

The port's copy of the JAX package's utils/ledger_tools.py (host code, read
over the same ledger lines the two packages write).

A ledger is the JSONL stream utils.observe writes when BSSEQ_TPU_STATS is
set: a run_manifest line first, then events (stage_stats, rule_complete,
pipeline_complete, spill, overlap_pool_disabled, worker_heartbeat, ...).
This module turns ledgers back into the numbers round verdicts kept
re-deriving by hand:

* summarize — per-stage host_s / device_s / stall_s / chip_busy table,
  the rule wall table, and the closure verdict;
* diff      — two summaries side by side (e.g. a cpu-backend run vs an
  on-chip run of the same config);
* check     — schema + invariant validation, non-zero exit on violation,
  so CI can gate on ledger integrity.

The ledger-closure invariant: per-rule wall seconds must sum to the
pipeline wall (pipeline_complete.pipeline_s) within tolerance, and each
stage's owner-thread timeline must be attributed to phases
(stage_stats.unattributed_s small relative to wall_seconds) — together
they prove no share of the run is hiding outside the ledger's numbers.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

#: Required keys per known event type (unknown events only need ts+event).
EVENT_SCHEMA: dict[str, tuple[str, ...]] = {
    "run_manifest": ("git_rev", "version", "backend", "device_count"),
    "stage_stats": ("stage",),
    "rule_complete": ("rule", "seconds", "ran"),
    "pipeline_complete": ("pipeline_s",),
    "spill": ("records", "seconds"),
    "merge_pass": ("pass", "runs"),
    "overlap_pool_disabled": ("reason",),
    "overlap_pool_enabled": ("workers",),
    "overlap_pool_composed": ("stage", "workers", "devices"),
    "host_pool_enabled": ("stage", "workers"),
    "host_pool_disabled": ("stage", "reason"),
    "worker_heartbeat": ("process_index", "seq", "phase"),
    # batch recovery (faults/retry + pipeline/calling): retries, degrades
    # and the stall watchdog — chaos drills count these
    "batch_retry": ("stage", "batch", "attempt"),
    "batch_recovered": ("stage", "batch", "attempts"),
    "batch_degraded": ("stage", "batch", "attempts", "error"),
    "batch_stall_redispatch": ("stage", "batch", "timeout_s"),
    "interstage_fallback": ("reason",),
    "failpoint_fired": ("site", "action"),
    # sort/checkpoint durability (pipeline/bucketemit + pipeline/checkpoint)
    "bucket_plan": ("buckets", "records_per_spill"),
    "bucket_spill": ("bucket", "records", "run", "seconds"),
    "bucket_replayed": ("buckets", "target"),
    "bucket_manifest_resumed": ("replayed", "target"),
    "bucket_manifest_discarded": ("reason", "target"),
    "checkpoint_input_changed": (
        "target", "run_input", "manifest_input", "batches_at_stake",
    ),
    "checkpoint_discarded": (
        "target", "reason", "dropped_batches", "dropped_shards",
    ),
    "shard_quarantined": (
        "target", "shard", "error", "dropped_batches", "dropped_shards",
    ),
    # methyl tally durability (methyl/tally)
    "methyl_spill": ("run", "sites", "upto"),
    "methyl_resume": ("watermark", "runs_kept", "runs_dropped"),
    "methyl_finalize": (),
    # input guard + stream resilience (faults/guard, io/bam, io/bgzf)
    "record_quarantined": ("input", "reason", "record_index"),
    "record_repaired": ("input", "qname", "reason", "record_index"),
    "family_quarantined": ("input", "mi", "reason", "records"),
    "guard_events_truncated": ("input", "dropped"),
    "stream_gap": ("input", "gap_start", "resumed_at", "skipped_bytes"),
    "stream_truncated": ("input", "error"),
    "frame_resync": ("input", "voffset", "discarded_bytes"),
    "frame_lost": ("input", "error"),
    "integrity_mismatch": ("what", "path"),
    # graftserve (serve/): per-tenant lines carry a 'job' field and are
    # mirrored to BSSEQ_TPU_STATS_JOBS sub-sinks
    "job_admitted": ("input", "output", "fingerprint"),
    "job_complete": ("output", "families", "consensus_out"),
    "job_failed": ("error",),
    "serve_listening": ("socket",),
    "serve_drained": ("socket",),
    "serve_warmup": ("families",),
    "serve_frame_refused": ("reason",),
    # graftfleet (serve/fleet + serve/router): replica processes stamp
    # every line with a 'replica' field (BSSEQ_TPU_REPLICA_ID); the
    # router's own lines reconcile placement with per-replica counts
    "fleet_replica_spawn": ("replica_id", "generation"),
    "fleet_replica_down": ("replica_id",),
    "fleet_restart_failed": ("replica_id", "error"),
    "fleet_route": ("rjob", "replica_id"),
    "fleet_requeue": ("rjob", "from_replica", "to_replica"),
    "fleet_counters": (
        "jobs_routed", "jobs_requeued", "affinity_hits",
        "replica_restarts",
    ),
    # graftswarm (elastic/): worker processes stamp every line with a
    # 'worker' field (BSSEQ_TPU_WORKER_ID); the coordinator's ledger
    # events carry the lease/requeue evidence the chaos drills assert on
    "elastic_split": ("slices", "families", "records"),
    "elastic_lease": ("slice", "worker", "lease_id"),
    "elastic_join": ("worker",),
    "elastic_slice_processed": ("slice", "worker"),
    "elastic_slice_done": ("slice",),
    "elastic_publish_refused": ("slice", "worker", "reason"),
    "elastic_slice_reset": ("slice", "worker"),
    "slice_requeued": ("slice", "worker", "reason"),
    "worker_lost": ("worker", "reason"),
    "elastic_worker_spawn": ("worker", "generation"),
    "elastic_ledger_resumed": ("done", "pending"),
    "elastic_merged": ("records", "slices", "ok"),
    "elastic_run_complete": ("slices", "records", "requeues", "ok"),
    # graftnet: epoch fencing + shared-nothing slice shipping
    "publish_fenced": ("slice", "worker", "epoch", "current"),
    "frame_dup_ignored": ("rid", "op"),
    "slice_chunk_resent": ("slice", "offset", "attempt"),
    # graftpreempt: voluntary drain-and-handoff + overload shedding
    "worker_preempted": ("worker", "reason"),
    "handoff_published": ("slice", "worker", "batches_kept",
                          "handoff_latency_s"),
    "jobs_shed": ("depth", "watermark", "retry_after_s"),
    # grafttrace (observability): completed causal spans (root spans
    # carry no 'parent' key; trace/span ids also stamp ordinary events)
    # and the crash-path flight-recorder dump
    "span": ("name", "trace", "span", "t0", "t1", "dur_s"),
    "flight_record": ("reason", "count", "events"),
    # the port's own line (no JAX counterpart): an elastic slice's vote
    # kernel launches on the card, per kernel, and the worker's peak of
    # allocated device memory
    "kernel_launches": ("slice", "worker", "backend"),
}

#: Default closure tolerance: relative share of the wall allowed to go
#: unattributed (plus a small absolute floor for sub-second runs).
CLOSURE_REL_TOL = 0.15
CLOSURE_ABS_TOL = 0.75


class LedgerError(RuntimeError):
    pass


@dataclass
class LedgerSummary:
    path: str = ""
    job: str | None = None  # serve tenant the view is scoped to
    replica: str | None = None  # fleet replica the view is scoped to
    worker: str | None = None  # elastic worker the view is scoped to
    manifest: dict = field(default_factory=dict)
    stages: dict = field(default_factory=dict)  # stage -> stage_stats line
    rules: list = field(default_factory=list)  # rule_complete lines
    pipeline: dict = field(default_factory=dict)  # pipeline_complete line
    events: dict = field(default_factory=dict)  # event -> count
    notes: list = field(default_factory=list)  # overlap disables etc.
    problems: list = field(default_factory=list)  # schema/invariant breaks
    jobs: dict = field(default_factory=dict)  # job id -> tagged-line count
    replicas: dict = field(default_factory=dict)  # replica -> line count
    workers: dict = field(default_factory=dict)  # worker -> line count

    @property
    def ok(self) -> bool:
        return not self.problems


def parse_ledger(path: str) -> tuple[list[dict], list[str]]:
    """(lines, problems): every syntactically valid line, plus a problem
    string per malformed one. An unreadable file raises LedgerError."""
    try:
        raw = open(path).read()
    except OSError as exc:
        raise LedgerError(f"cannot read ledger {path}: {exc}") from exc
    lines: list[dict] = []
    problems: list[str] = []
    for i, text in enumerate(raw.splitlines(), 1):
        if not text.strip():
            continue
        try:
            d = json.loads(text)
        except json.JSONDecodeError as exc:
            problems.append(f"line {i}: not JSON ({exc.msg})")
            continue
        if not isinstance(d, dict):
            problems.append(f"line {i}: not a JSON object")
            continue
        lines.append(d)
    return lines, problems


def _schema_problems(lines: list[dict]) -> list[str]:
    problems: list[str] = []
    if not lines:
        problems.append("empty ledger")
        return problems
    if lines[0].get("event") != "run_manifest":
        problems.append(
            "first event is "
            f"{lines[0].get('event')!r}, expected 'run_manifest' "
            "(every ledger opens with the run manifest)"
        )
    for i, d in enumerate(lines, 1):
        ev = d.get("event")
        if not isinstance(ev, str):
            problems.append(f"event {i}: missing 'event'")
            continue
        if not isinstance(d.get("ts"), (int, float)):
            problems.append(f"event {i} ({ev}): missing numeric 'ts'")
        for key in EVENT_SCHEMA.get(ev, ()):
            if key not in d:
                problems.append(f"event {i} ({ev}): missing required {key!r}")
    return problems


def _closure_problems(
    summary: "LedgerSummary",
    rel_tol: float = CLOSURE_REL_TOL,
    abs_tol: float = CLOSURE_ABS_TOL,
) -> list[str]:
    problems: list[str] = []
    pipeline_s = summary.pipeline.get("pipeline_s")
    # The rule-sum closure invariant is per pipeline run. A view holding
    # several runs (an elastic worker's sub-stream is one run per
    # processed slice) has no single pipeline_s denominator, so only the
    # per-stage phase coverage below is checkable there.
    runs = summary.events.get("pipeline_complete", 0)
    if runs == 1 and isinstance(pipeline_s, (int, float)) and summary.rules:
        rule_sum = sum(
            r.get("seconds", 0.0)
            for r in summary.rules
            if isinstance(r.get("seconds"), (int, float))
        )
        gap = abs(pipeline_s - rule_sum)
        if gap > max(rel_tol * pipeline_s, abs_tol):
            problems.append(
                f"closure: rule seconds sum to {rule_sum:.3f}s but "
                f"pipeline_s is {pipeline_s:.3f}s (gap {gap:.3f}s > "
                f"tolerance)"
            )
    for stage, st in summary.stages.items():
        wall = st.get("wall_seconds")
        unatt = st.get("unattributed_s")
        if not isinstance(wall, (int, float)) or not isinstance(
            unatt, (int, float)
        ):
            continue
        if unatt > max(rel_tol * wall, abs_tol):
            problems.append(
                f"closure: stage {stage!r} has {unatt:.3f}s unattributed "
                f"of a {wall:.3f}s wall (> tolerance) — phases do not "
                "cover the stage"
            )
    return problems


def summarize_ledger(
    path: str,
    rel_tol: float = CLOSURE_REL_TOL,
    abs_tol: float = CLOSURE_ABS_TOL,
    job: str | None = None,
    replica: str | None = None,
    worker: str | None = None,
) -> LedgerSummary:
    """Summarize one ledger.

    job: scope the view to one serve tenant — only lines tagged with
    that job id count (the run_manifest is kept for context). The
    scoped view is a comparison surface, not a validation one, so the
    whole-ledger schema checks are skipped (a BSSEQ_TPU_STATS_JOBS
    sub-sink, which has no run_manifest, summarizes cleanly too).

    replica: scope the view to one fleet replica's sub-stream the same
    way (a shared fleet ledger interleaves N replica processes; each
    stamps its lines via BSSEQ_TPU_REPLICA_ID). Composable with job —
    `--replica r1 --job j0003` is one tenant as served by one replica.

    Untargeted (job=None) views of a shared serve ledger tally
    job-tagged lines per tenant in `.jobs` (and replica-tagged lines
    per replica in `.replicas`) instead of merging them into the
    engine's stages — one tenant's or one replica's numbers never
    masquerade as the run's.

    worker: scope the view to one elastic worker's sub-stream exactly
    like replica (a shared elastic ledger interleaves the coordinator
    and N worker processes; each worker stamps its lines via
    BSSEQ_TPU_WORKER_ID)."""
    lines, problems = parse_ledger(path)
    s = LedgerSummary(path=path, job=job, replica=replica, worker=worker,
                      problems=problems)
    if job is None and replica is None and worker is None:
        s.problems.extend(_schema_problems(lines))
    for d in lines:
        ev = d.get("event")
        if not isinstance(ev, str):
            continue
        line_job = d.get("job")
        line_replica = d.get("replica")
        line_worker = d.get("worker")
        if replica is not None:
            if line_replica != replica:
                if ev == "run_manifest" and not s.manifest:
                    s.manifest = d
                continue
        elif line_replica is not None:
            s.replicas[str(line_replica)] = (
                s.replicas.get(str(line_replica), 0) + 1
            )
            s.events[ev] = s.events.get(ev, 0) + 1
            continue
        if worker is not None:
            if line_worker != worker:
                if ev == "run_manifest" and not s.manifest:
                    s.manifest = d
                continue
        elif line_worker is not None:
            s.workers[str(line_worker)] = (
                s.workers.get(str(line_worker), 0) + 1
            )
            s.events[ev] = s.events.get(ev, 0) + 1
            continue
        if job is not None:
            if ev == "run_manifest":
                if not s.manifest:
                    s.manifest = d
                continue
            if line_job != job:
                continue
        elif line_job is not None:
            s.jobs[str(line_job)] = s.jobs.get(str(line_job), 0) + 1
            s.events[ev] = s.events.get(ev, 0) + 1
            continue
        s.events[ev] = s.events.get(ev, 0) + 1
        if ev == "run_manifest" and not s.manifest:
            s.manifest = d
        elif ev == "stage_stats":
            s.stages[str(d.get("stage"))] = d
        elif ev == "rule_complete":
            s.rules.append(d)
        elif ev == "pipeline_complete":
            s.pipeline = d
        elif ev in ("overlap_pool_disabled", "host_pool_disabled"):
            pool = "overlap" if ev == "overlap_pool_disabled" else "host"
            s.notes.append(
                f"{pool} pool disabled ({d.get('stage', '?')}): "
                f"{d.get('reason', '?')}"
            )
    if job is not None and not s.events:
        s.problems.append(f"no ledger lines tagged job={job!r}")
    if replica is not None and not s.events:
        s.problems.append(f"no ledger lines tagged replica={replica!r}")
    if worker is not None and not s.events:
        s.problems.append(f"no ledger lines tagged worker={worker!r}")
    s.problems.extend(_closure_problems(s, rel_tol, abs_tol))
    return s


def check_ledger(
    path: str,
    rel_tol: float = CLOSURE_REL_TOL,
    abs_tol: float = CLOSURE_ABS_TOL,
) -> list[str]:
    """All schema + invariant problems for one ledger (empty = valid)."""
    return summarize_ledger(path, rel_tol, abs_tol).problems


# ---------------------------------------------------------------------------
# Formatting.

_STAGE_COLS = (
    ("wall_seconds", "wall_s"),
    ("host_s", "host_s"),
    ("device_s", "device_s"),
    ("stall_s", "stall_s"),
    ("chip_busy", "chip_busy"),
    ("unattributed_s", "unattr_s"),
    ("families_per_second", "fam/s"),
)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    if v is None:
        return "-"
    return str(v)


def _table(headers: list[str], rows: list[list[str]]) -> str:
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()

    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


_SW_PREFIX = "sort_write."


def _emit_breakdown_rows(s: LedgerSummary) -> list[list[str]]:
    """Per-stage sort_write sub-phase rows (bucket_route/bucket_sort/
    bucket_concat, deflate, merge...) plus a deflate-worker utilization
    row when the parallel codec tier ran — busy worker-seconds over
    workers x active span, so a 4-worker tier compressing 10% of the
    time reads 10%, not "4 workers". Empty when no stage attributed
    emit sub-phases (old ledgers stay byte-stable)."""
    rows: list[list[str]] = []
    for stage, st in sorted(s.stages.items()):
        subs = {
            k[len(_SW_PREFIX):-len("_seconds")]: st[k]
            for k in st
            if k.startswith(_SW_PREFIX)
            and k.endswith("_seconds")
            and isinstance(st[k], (int, float))
        }
        workers = st.get("pbgzf_workers")
        if not subs and not workers:
            continue
        for name in sorted(subs, key=lambda n: -subs[n]):
            rows.append([stage, name, _fmt(float(subs[name]))])
        if isinstance(workers, (int, float)) and workers:
            busy = subs.get("deflate", 0.0)
            span = subs.get("deflate_span", 0.0)
            util = f"{busy / (span * workers):.0%}" if span else "-"
            blocks = st.get("pbgzf_blocks")
            rows.append([
                stage,
                f"deflate workers={int(workers)} blocks={blocks or 0}",
                f"util {util}",
            ])
        buckets = st.get("bucket_count")
        if isinstance(buckets, (int, float)) and buckets:
            detail = f"buckets={int(buckets)}"
            if st.get("bucket_spill_runs"):
                detail += f" spill_runs={int(st['bucket_spill_runs'])}"
            if st.get("bucket_replayed"):
                detail += f" replayed={int(st['bucket_replayed'])}"
            rows.append([stage, detail, ""])
    return rows


def format_summary(s: LedgerSummary) -> str:
    out: list[str] = []
    m = s.manifest
    if m:
        out.append(
            f"run: rev={m.get('git_rev', '?')} backend={m.get('backend', '?')}"
            f" devices={m.get('device_count', '?')}"
            f" config={m.get('config_digest') or '-'}"
            f" component={m.get('component') or '-'}"
        )
    if s.job is not None:
        out.append(f"scoped to job: {s.job}")
    if s.replica is not None:
        out.append(f"scoped to replica: {s.replica}")
    if s.worker is not None:
        out.append(f"scoped to worker: {s.worker}")
    if s.jobs:
        out.append(
            f"serve jobs in ledger: {len(s.jobs)} "
            f"({', '.join(sorted(s.jobs))}) — scope with --job"
        )
    if s.replicas:
        out.append(
            f"fleet replicas in ledger: {len(s.replicas)} "
            f"({', '.join(sorted(s.replicas))}) — scope with --replica"
        )
    if s.workers:
        out.append(
            f"elastic workers in ledger: {len(s.workers)} "
            f"({', '.join(sorted(s.workers))}) — scope with --worker"
        )
    if s.stages:
        rows = []
        for stage, st in sorted(s.stages.items()):
            rows.append(
                [stage] + [_fmt(st.get(k)) for k, _ in _STAGE_COLS]
            )
        out.append("")
        out.append(_table(["stage"] + [h for _, h in _STAGE_COLS], rows))
    emit_rows = _emit_breakdown_rows(s)
    if emit_rows:
        out.append("")
        out.append(
            _table(["stage", "sort_write sub-phase", "seconds"], emit_rows)
        )
    if s.rules:
        rows = [
            [
                r.get("rule", "?"),
                _fmt(r.get("seconds")),
                "ran" if r.get("ran") else "skip",
            ]
            for r in s.rules
        ]
        out.append("")
        out.append(_table(["rule", "seconds", "status"], rows))
        if s.pipeline:
            out.append(f"pipeline_s: {_fmt(s.pipeline.get('pipeline_s'))}")
    for note in s.notes:
        out.append(f"note: {note}")
    out.append("")
    if s.problems:
        out.append(f"INVALID: {len(s.problems)} problem(s)")
        out.extend(f"  - {p}" for p in s.problems)
    else:
        out.append("ledger OK (schema valid, closure invariant holds)")
    return "\n".join(out)


def format_diff(a: LedgerSummary, b: LedgerSummary) -> str:
    """Two ledgers side by side, per stage and phase, with the B/A ratio —
    the shape of the SCALECPU-vs-SCALE_TPU comparison the verdicts make."""
    out = [
        f"A: {a.path} (backend={a.manifest.get('backend', '?')})",
        f"B: {b.path} (backend={b.manifest.get('backend', '?')})",
        "",
    ]
    stages = sorted(set(a.stages) | set(b.stages))
    rows = []
    for stage in stages:
        sa, sb = a.stages.get(stage, {}), b.stages.get(stage, {})
        for key, label in _STAGE_COLS:
            va, vb = sa.get(key), sb.get(key)
            if va is None and vb is None:
                continue
            ratio = "-"
            if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
                ratio = f"{vb / va:.2f}x" if va else "-"
            rows.append([f"{stage}.{label}", _fmt(va), _fmt(vb), ratio])
    pa = a.pipeline.get("pipeline_s")
    pb = b.pipeline.get("pipeline_s")
    if pa is not None or pb is not None:
        ratio = (
            f"{pb / pa:.2f}x"
            if isinstance(pa, (int, float))
            and isinstance(pb, (int, float))
            and pa
            else "-"
        )
        rows.append(["pipeline_s", _fmt(pa), _fmt(pb), ratio])
    out.append(_table(["metric", "A", "B", "B/A"], rows))
    return "\n".join(out)
