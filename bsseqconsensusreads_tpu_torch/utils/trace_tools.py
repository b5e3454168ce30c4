"""grafttrace consumers: cross-process causal-trace reassembly.

The port's copy of the JAX package's utils/trace_tools.py (host code, read
over the same ledger lines the two packages write).

utils.observe writes spans ("span" ledger lines: name, trace, span,
parent, t0, t1, dur_s) and stamps ordinary events with the bound trace
ctx. One job or slice therefore leaves lines in SEVERAL processes'
ledgers (router + replicas, or coordinator + workers), all sharing one
trace id. This module puts them back together:

* assemble  — load a rundir's ledgers (or explicit paths) and rebuild
  the span forest: every trace's spans keyed by id, parent links
  resolved ACROSS files, stamped non-span events attached.
* checks    — orphan spans (a parent id never seen anywhere: a
  truncated or missing ledger), job/slice traces that never reached a
  terminal event (job_complete/job_failed, elastic_slice_done), and
  trace-vs-counter reconciliation (distinct job traces against
  admitted jobs, distinct slice traces against the split) — the
  `observe check` cross-process tier and the chaos drill's
  killed-process assertion (a killed holder's trace carries a
  fleet_requeue/slice_requeued line and STILL terminates).
* critical path — per trace, the root→leaf chain ending at the
  latest-finishing span (wall-clock t0/t1: monotonic clocks do not
  compare across processes); for the run, the longest such chain.
* overhead buckets — dur_s summed per span name (worker_spawn,
  jax_import (in the port: the torch stack's import and the kernel
  library's load), compile, lease_wait, transport, ingest, merge, ...),
  ranked: the table that turns an ELASTIC_HEAD wall-clock loss into
  named, ordered causes.

Everything here is read-only over ledger files; `cli observe trace`
and the bench/chaos tooling are thin callers.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field

from bsseqconsensusreads_tpu_torch.utils import ledger_tools as _lt
from bsseqconsensusreads_tpu_torch.utils.observe import TRACE_TERMINAL_KINDS

#: Events that close a trace of each terminal-requiring kind. A job is
#: done when it retired or failed; a slice when the coordinator
#: committed its manifest (elastic_merged additionally closes every
#: slice at once, but commit is the per-slice truth).
TERMINAL_EVENTS: dict[str, frozenset] = {
    "job": frozenset({"job_complete", "job_failed"}),
    "slice": frozenset({"elastic_slice_done"}),
}

#: Events that mark a kill/lapse being RESOLVED back onto the queue —
#: a chaos-killed holder's trace must carry one of these before its
#: eventual terminal, never dangle.
REQUEUE_EVENTS = frozenset({"fleet_requeue", "slice_requeued"})


@dataclass
class Span:
    sid: str
    parent: str | None
    name: str
    trace: str
    t0: float
    t1: float
    dur_s: float
    raw: dict = field(default_factory=dict)


@dataclass
class Trace:
    tid: str
    kind: str
    spans: dict[str, Span] = field(default_factory=dict)
    #: stamped non-span ledger lines carrying this trace id
    events: list[dict] = field(default_factory=list)

    @property
    def roots(self) -> list[Span]:
        return [s for s in self.spans.values() if s.parent is None]

    @property
    def t0(self) -> float | None:
        return min((s.t0 for s in self.spans.values()), default=None)

    @property
    def t1(self) -> float | None:
        return max((s.t1 for s in self.spans.values()), default=None)

    def terminal(self) -> bool:
        """True when a terminal event for this kind is attached (or the
        kind never requires one — proc traces live as long as their
        process and are exempt by TRACE_TERMINAL_KINDS)."""
        if self.kind not in TRACE_TERMINAL_KINDS:
            return True
        closing = TERMINAL_EVENTS.get(self.kind, frozenset())
        return any(e.get("event") in closing for e in self.events)

    def requeued(self) -> bool:
        return any(e.get("event") in REQUEUE_EVENTS for e in self.events)

    def critical_path(self) -> list[Span]:
        """Root→leaf chain ending at the latest-finishing span. A
        truncated chain (orphan leaf) walks up as far as the links go —
        the orphan check reports the break separately."""
        if not self.spans:
            return []
        leaf = max(self.spans.values(), key=lambda s: s.t1)
        path = [leaf]
        seen = {leaf.sid}
        cur = leaf
        while cur.parent is not None and cur.parent in self.spans:
            cur = self.spans[cur.parent]
            if cur.sid in seen:  # defensive: a cycle would hang here
                break
            seen.add(cur.sid)
            path.append(cur)
        path.reverse()
        return path


@dataclass
class TraceReport:
    paths: list[str] = field(default_factory=list)
    lines: int = 0
    traces: dict[str, Trace] = field(default_factory=dict)
    #: (trace id, span id, missing parent id, span name)
    orphans: list[tuple] = field(default_factory=list)
    #: malformed-line / unreadable-file strings from parsing
    parse_problems: list[str] = field(default_factory=list)
    #: all raw ledger lines, for counter reconciliation
    raw: list[dict] = field(default_factory=list)

    def by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for t in self.traces.values():
            out[t.kind] = out.get(t.kind, 0) + 1
        return out

    def span_count(self) -> int:
        return sum(len(t.spans) for t in self.traces.values())

    def buckets(self) -> list[tuple[str, int, float]]:
        """(name, span count, total dur_s) ranked by total, descending —
        the overhead attribution table."""
        agg: dict[str, list] = {}
        for t in self.traces.values():
            for s in t.spans.values():
                slot = agg.setdefault(s.name, [0, 0.0])
                slot[0] += 1
                slot[1] += s.dur_s
        return sorted(
            ((n, c, d) for n, (c, d) in agg.items()),
            key=lambda x: (-x[2], x[0]),
        )

    def longest(self) -> Trace | None:
        """The trace whose critical path spans the most wall — the run's
        critical path. Proc traces compete too: a run dominated by one
        process's spawn+import+compile should SAY so."""
        best, best_wall = None, -1.0
        for t in self.traces.values():
            t0, t1 = t.t0, t.t1
            if t0 is None or t1 is None:
                continue
            if t1 - t0 > best_wall:
                best, best_wall = t, t1 - t0
        return best


def resolve_ledgers(target: str | list[str]) -> list[str]:
    """A rundir (every *.jsonl inside, sorted), a single ledger file, or
    an explicit list of paths."""
    if isinstance(target, (list, tuple)):
        return [str(p) for p in target]
    if os.path.isdir(target):
        return sorted(glob.glob(os.path.join(target, "*.jsonl")))
    return [target]


def assemble(target: str | list[str]) -> TraceReport:
    """Load ledgers and rebuild the cross-process span forest."""
    report = TraceReport(paths=resolve_ledgers(target))
    if not report.paths:
        report.parse_problems.append(
            f"no ledgers found under {target!r} (expected *.jsonl)"
        )
        return report
    lines: list[dict] = []
    for path in report.paths:
        try:
            got, problems = _lt.parse_ledger(path)
        except _lt.LedgerError as exc:
            report.parse_problems.append(str(exc))
            continue
        lines.extend(got)
        report.parse_problems.extend(
            f"{os.path.basename(path)}: {p}" for p in problems
        )
    report.lines = len(lines)
    report.raw = lines
    for d in lines:
        tid = d.get("trace")
        if not isinstance(tid, str):
            continue
        trace = report.traces.get(tid)
        if trace is None:
            trace = report.traces[tid] = Trace(
                tid=tid, kind=tid.split("-", 1)[0]
            )
        if d.get("event") == "span":
            sid = d.get("span")
            if not isinstance(sid, str):
                report.parse_problems.append(
                    f"span line in trace {tid} without a span id"
                )
                continue
            parent = d.get("parent")
            trace.spans[sid] = Span(
                sid=sid,
                parent=parent if isinstance(parent, str) else None,
                name=str(d.get("name", "?")),
                trace=tid,
                t0=float(d.get("t0", 0.0)),
                t1=float(d.get("t1", 0.0)),
                dur_s=float(d.get("dur_s", 0.0)),
                raw=d,
            )
        else:
            trace.events.append(d)
    for trace in report.traces.values():
        for s in trace.spans.values():
            if s.parent is not None and s.parent not in trace.spans:
                report.orphans.append((trace.tid, s.sid, s.parent, s.name))
    return report


# ---------------------------------------------------------------------------
# Checks: the `observe check` cross-process tier / chaos-drill gate.


def _reconcile_problems(report: TraceReport) -> list[str]:
    """Distinct trace counts against the run's own counters: every
    admitted job and every split slice must own exactly one trace."""
    problems: list[str] = []
    kinds = report.by_kind()
    # admissions are keyed by TRACE, not job id: queue-local ids
    # ("j0001") collide across replicas in a shared ledger, and a
    # requeued job is re-admitted under a new remote id but the SAME
    # trace — the invariant is one admission stream per job trace.
    untraced = sum(
        1 for d in report.raw
        if d.get("event") == "job_admitted" and "trace" not in d
    )
    if untraced:
        problems.append(
            f"reconcile: {untraced} job admission(s) carry no trace id"
        )
    admitted_traces = {
        str(d["trace"])
        for d in report.raw
        if d.get("event") == "job_admitted" and "trace" in d
    }
    job_traces = {
        t.tid for t in report.traces.values() if t.kind == "job"
    }
    never_admitted = job_traces - admitted_traces
    if admitted_traces and never_admitted:
        problems.append(
            f"reconcile: {len(never_admitted)} job trace(s) with no "
            f"admission event: {', '.join(sorted(never_admitted))}"
        )
    split = max(
        (
            d.get("slices")
            for d in report.raw
            if d.get("event") == "elastic_split"
            and isinstance(d.get("slices"), int)
        ),
        default=None,
    )
    if split is not None and kinds.get("slice", 0) != split:
        problems.append(
            f"reconcile: split produced {split} slices but "
            f"{kinds.get('slice', 0)} slice traces"
        )
    # the router counter `jobs_routed` counts PLACEMENTS (a requeued
    # job is re-routed under the same trace), so totals don't compare
    # against distinct traces — the invariant is that every route event
    # is stamped: a stamped route materialises its job trace, and a
    # routed-but-never-admitted or never-terminated trace is then
    # caught by the admission and terminal checks above.
    unrouted = sum(
        1 for d in report.raw
        if d.get("event") == "fleet_route" and "trace" not in d
    )
    if unrouted:
        problems.append(
            f"reconcile: {unrouted} fleet_route event(s) carry no "
            "trace id"
        )
    return problems


def check_traces(report: TraceReport) -> list[str]:
    """All cross-process trace problems (empty = the forest is whole):
    parse/truncation damage, orphan spans, job/slice traces that never
    reached a terminal state, counter mismatches."""
    problems = list(report.parse_problems)
    for tid, sid, parent, name in report.orphans:
        problems.append(
            f"orphan span {sid} ({name}) in trace {tid}: parent "
            f"{parent} never seen in any loaded ledger"
        )
    for trace in report.traces.values():
        if not trace.terminal():
            problems.append(
                f"trace {trace.tid} ({trace.kind}) never reached a "
                "terminal state"
                + (" (requeued, then lost)" if trace.requeued() else "")
            )
    problems.extend(_reconcile_problems(report))
    return problems


# ---------------------------------------------------------------------------
# Rendering + artifact embedding.


def _fmt_s(v: float) -> str:
    return f"{v:.3f}"


def format_report(report: TraceReport) -> str:
    kinds = report.by_kind()
    out = [
        f"ledgers: {len(report.paths)} file(s), {report.lines} lines",
        "traces: "
        + ", ".join(f"{kinds.get(k, 0)} {k}" for k in ("job", "slice", "proc"))
        + f"; spans: {report.span_count()}; orphans: {len(report.orphans)}",
    ]
    buckets = report.buckets()
    if buckets:
        total = sum(d for _, _, d in buckets) or 1.0
        out.append("")
        out.append("overhead buckets (dur_s summed per span name, ranked)")
        out.append(
            _lt._table(
                ["bucket", "spans", "total_s", "share"],
                [
                    [n, str(c), _fmt_s(d), f"{d / total:.0%}"]
                    for n, c, d in buckets
                ],
            )
        )
    longest = report.longest()
    if longest is not None:
        path = longest.critical_path()
        wall = (longest.t1 or 0.0) - (longest.t0 or 0.0)
        out.append("")
        out.append(
            f"critical path — longest trace {longest.tid} "
            f"({_fmt_s(wall)}s wall)"
        )
        out.append(
            _lt._table(
                ["span", "dur_s", "t0+"],
                [
                    [s.name, _fmt_s(s.dur_s), _fmt_s(s.t0 - (longest.t0 or 0.0))]
                    for s in path
                ],
            )
        )
    rows = []
    for trace in sorted(
        report.traces.values(), key=lambda t: (t.kind, t.tid)
    ):
        if trace.kind not in TRACE_TERMINAL_KINDS:
            continue
        t0, t1 = trace.t0, trace.t1
        wall = (t1 - t0) if t0 is not None and t1 is not None else 0.0
        rows.append(
            [
                trace.tid,
                _fmt_s(wall),
                str(len(trace.spans)),
                "yes" if trace.terminal() else "NO",
                ">".join(s.name for s in trace.critical_path()) or "-",
            ]
        )
    if rows:
        out.append("")
        out.append("per-trace critical paths")
        out.append(
            _lt._table(["trace", "wall_s", "spans", "terminal", "path"], rows)
        )
    return "\n".join(out)


def trace_summary(target: str | list[str]) -> dict:
    """JSON-able trace digest for run artifacts (ELASTIC_HEAD.json /
    FLEET_HEAD.json): the overhead-bucket table, the run's critical
    path, and the check verdict — a fleet/elastic wall-clock number
    without this table attached names a cost it cannot attribute."""
    report = assemble(target)
    problems = check_traces(report)
    longest = report.longest()
    crit = []
    if longest is not None:
        crit = [
            {"span": s.name, "dur_s": round(s.dur_s, 4)}
            for s in longest.critical_path()
        ]
    return {
        "ledgers": len(report.paths),
        "traces": report.by_kind(),
        "spans": report.span_count(),
        "orphans": len(report.orphans),
        "problems": problems,
        "ok": not problems,
        "buckets": {
            name: {"spans": count, "total_s": round(dur, 4)}
            for name, count, dur in report.buckets()
        },
        "critical_path": {
            "trace": longest.tid if longest is not None else None,
            "spans": crit,
        },
    }
