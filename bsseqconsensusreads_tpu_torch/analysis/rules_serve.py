"""graftlint serve-discipline rule: blocking scheduler loops.

The failure class the resident engine (serve/) introduces: a scheduler,
retire, or accept loop that parks on an unbounded blocking primitive —
`time.sleep` instead of an interruptible `Event.wait(timeout)`, a
`queue.Queue()` with no maxsize (one slow tenant backlogs the process
into OOM instead of exerting backpressure at submit), or a
`.get()`/`.put()`/`.join()`/`.wait()`/`.acquire()` with no timeout
inside a polling loop (drain and SIGTERM can then never preempt the
wait, so "graceful shutdown" hangs forever). The sanctioned shapes are
bounded queues, `get_nowait` + wake events, and timeout-sliced waits
re-checked against stop/drain flags each lap.

Scope: files under a `serve` package directory, plus functions anywhere
whose name says they are a scheduler/serve/retire loop. Loops outside
that scope are other rules' business — a worker thread may legitimately
block forever on its feed queue.

A second rule covers the shutdown half of the same failure class:
`unbounded-drain-wait` flags blocking primitives with no timeout bound
inside drain-, preemption-, or signal-reachable functions anywhere in
the tree — a graceful-exit path that can park forever converts a
bounded-handoff guarantee into a hang the supervisor must SIGKILL out
of, losing the checkpoint flush the drain existed to protect.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
    call_basename,
)

#: Function-name fragments that mark a scheduler/serve/retire loop
#: wherever it lives.
_SCOPE_NAME_FRAGMENTS = ("scheduler", "serve", "retire")

#: Blocking primitives that must carry a timeout inside a polling loop.
#: (`accept`/`recv` are deliberately absent: socket loops bound those
#: with `settimeout` on the socket, which this AST pass cannot see.)
_BLOCKING_ATTRS = frozenset({"get", "put", "join", "wait", "acquire"})

#: Positional-argument count at which the call is bounded even without
#: a `timeout=` keyword (e.g. `ev.wait(0.25)`, `q.get(True, 0.25)`).
_BOUND_BY_ARGC = {"wait": 1, "join": 1, "get": 2, "put": 3, "acquire": 2}


def _in_serve_file(sf: SourceFile) -> bool:
    parts = sf.display.replace(os.sep, "/").split("/")
    return "serve" in parts[:-1]


def _scoped_function(name: str) -> bool:
    low = name.lower()
    return any(frag in low for frag in _SCOPE_NAME_FRAGMENTS)


def _in_scope(sf: SourceFile, node: ast.AST) -> bool:
    if _in_serve_file(sf):
        return True
    return any(
        _scoped_function(func.name)
        for func in sf.enclosing_functions(node)
    )


def _is_bounded(call: ast.Call, attr: str) -> bool:
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    return len(call.args) >= _BOUND_BY_ARGC.get(attr, 99)


def check_blocking_scheduler_loop(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            # unbounded queue anywhere in scope: no maxsize, no capacity
            if (
                call_basename(node) == "Queue"
                and not node.args
                and not any(kw.arg == "maxsize" for kw in node.keywords)
                and _in_scope(sf, node)
            ):
                yield Finding(
                    rule="blocking-scheduler-loop",
                    path=sf.display,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        "unbounded queue.Queue() on a serve path — with "
                        "no maxsize a slow tenant backlogs the resident "
                        "process into OOM; give the queue a capacity so "
                        "backpressure lands at submit time"
                    ),
                )
            continue
        if not isinstance(node, ast.While):
            continue
        if not _in_scope(sf, node):
            continue
        for sub in PackageIndex._own_nodes(node):
            if not isinstance(sub, ast.Call):
                continue
            base = call_basename(sub)
            if base == "sleep":
                yield Finding(
                    rule="blocking-scheduler-loop",
                    path=sf.display,
                    line=sub.lineno,
                    col=sub.col_offset,
                    message=(
                        "time.sleep inside a scheduler/retire loop — "
                        "drain and SIGTERM cannot preempt a sleep; poll "
                        "with Event.wait(timeout) and re-check the stop "
                        "flag each lap"
                    ),
                )
            elif (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _BLOCKING_ATTRS
                and not _is_bounded(sub, sub.func.attr)
            ):
                yield Finding(
                    rule="blocking-scheduler-loop",
                    path=sf.display,
                    line=sub.lineno,
                    col=sub.col_offset,
                    message=(
                        f".{sub.func.attr}() with no timeout inside a "
                        "scheduler/retire loop — an unbounded wait here "
                        "wedges graceful drain; pass timeout= and loop "
                        "on the deadline"
                    ),
                )


#: Function-name fragments that mark a drain-/preemption-/signal-
#: reachable path wherever it lives. Deliberately narrower than "stop":
#: a `stop()` may block on work completion by design, but anything
#: named for drain, preemption, or signal handling has promised a
#: bounded exit.
_DRAIN_NAME_FRAGMENTS = (
    "drain",
    "preempt",
    "shutdown",
    "sigterm",
    "sigint",
    "on_signal",
    "reap",
    "handoff",
    "teardown",
)


def _drain_scoped(sf: SourceFile, node: ast.AST) -> bool:
    return any(
        any(frag in func.name.lower() for frag in _DRAIN_NAME_FRAGMENTS)
        for func in sf.enclosing_functions(node)
    )


def check_unbounded_drain_wait(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_ATTRS
        ):
            continue
        if _is_bounded(node, node.func.attr):
            continue
        if node.func.attr == "get" and node.args:
            # q.get() is the canonical unbounded form; a positional
            # argument here is almost always a mapping key — dict.get
            # lookups are not blocking waits
            continue
        if not _drain_scoped(sf, node):
            continue
        yield Finding(
            rule="unbounded-drain-wait",
            path=sf.display,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f".{node.func.attr}() with no timeout on a drain/"
                "preempt/signal path — a graceful exit that can park "
                "forever forfeits the bounded-handoff guarantee and "
                "ends in SIGKILL; pass timeout= and escalate on lapse"
            ),
        )


RULES = [
    Rule(
        name="blocking-scheduler-loop",
        summary="unbounded queue / blocking wait / sleep inside "
        "scheduler, retire, or serve loops",
        check=check_blocking_scheduler_loop,
    ),
    Rule(
        name="unbounded-drain-wait",
        summary="blocking wait with no timeout inside drain-, "
        "preemption-, or signal-reachable functions",
        check=check_unbounded_drain_wait,
    ),
]
