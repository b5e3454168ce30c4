"""graftlint rules for thread discipline in worker callables.

The overlap engine (pipeline.calling's ThreadPoolExecutor), the
heartbeat daemon (parallel.multihost.WorkerHeartbeat) and the native
codec drivers all run Python code off the main thread. Two rules guard
the two failure modes reviews keep finding there: shared state mutated
without the lock, and exceptions that die silently inside a worker
(the pool swallows them until .result(), a bare Thread forever).
"""

from __future__ import annotations

import ast
from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
)
from bsseqconsensusreads_tpu_torch.analysis.rules_torch import _assign_targets

#: Attribute-chain substrings that mark sanctioned per-thread storage
#: (threading.local and friends) — mutation there is the *fix* for
#: shared state, not an instance of it.
_THREAD_LOCAL_MARKERS = ("tls", "thread_local", "threadlocal", "_local")


def _attr_base_name(target: ast.AST) -> tuple[str | None, str]:
    """For an Attribute target, the base-most Name and the full dotted
    source ('self._seq' -> ('self', 'self._seq'))."""
    src = ast.unparse(target)
    cur = target
    while isinstance(cur, ast.Attribute):
        cur = cur.value
    if isinstance(cur, ast.Name):
        return cur.id, src
    return None, src


def _local_names(func: ast.AST) -> set[str]:
    """Names bound inside the function: params + assignment/for/with
    targets (nested defs included — they share the worker's frame only
    via closure, but a name bound anywhere local is not shared state)."""
    out: set[str] = set()
    assert isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef))
    for a in (
        func.args.posonlyargs
        + func.args.args
        + func.args.kwonlyargs
        + ([func.args.vararg] if func.args.vararg else [])
        + ([func.args.kwarg] if func.args.kwarg else [])
    ):
        out.add(a.arg)
    for sub in ast.walk(func):
        out.update(_assign_targets(sub))
        if isinstance(sub, ast.withitem):
            out.update(_assign_targets(sub))
    return out


def check_thread_mutation(sf: SourceFile, index: PackageIndex) -> Iterator[Finding]:
    """thread-unsafe-mutation: attribute assignment on shared objects
    (self, closures, globals) inside worker-reachable code without an
    enclosing `with <lock>:`."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fi = index.info(node)
        if fi is None or fi.qualname not in index.worker_reachable:
            continue
        if node.name in ("__init__", "__post_init__", "__setattr__") or any(
            isinstance(d, ast.Attribute) and d.attr == "setter"
            for d in node.decorator_list
        ):
            # constructors and property setters mutate the object they
            # were handed — confinement there is the caller's contract,
            # not this function's
            continue
        local = _local_names(node)
        for sub in PackageIndex._own_nodes(node):
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, ast.AugAssign):
                targets = [sub.target]
            else:
                continue
            for t in targets:
                if not isinstance(t, ast.Attribute):
                    continue
                base, dotted = _attr_base_name(t)
                if base is None:
                    continue
                lowered = dotted.lower()
                if any(m in lowered for m in _THREAD_LOCAL_MARKERS):
                    continue  # threading.local storage is per-thread
                shared = base == "self" or base not in local
                if not shared:
                    continue
                if sf.in_lock_block(sub):
                    continue
                yield Finding(
                    rule="thread-unsafe-mutation",
                    path=sf.display,
                    line=sub.lineno,
                    col=sub.col_offset,
                    message=(
                        f"assignment to shared attribute {dotted!r} in "
                        "worker-reachable code without holding a lock — "
                        "concurrent workers race here; guard it with the "
                        "owning object's lock (cf. observe.Metrics."
                        "_accumulate) or move the write to the main "
                        "thread"
                    ),
                )


def check_swallowed_exception(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    """swallowed-exception: an except handler whose body is only
    pass/continue inside worker-reachable code — the pool already defers
    exceptions to .result(); a handler that also eats them leaves no
    trace anywhere."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        fi = index.info(node)
        if fi is None or fi.qualname not in index.worker_reachable:
            continue
        for sub in PackageIndex._own_nodes(node):
            if not isinstance(sub, ast.ExceptHandler):
                continue
            body = [s for s in sub.body if not isinstance(s, ast.Expr) or not (
                isinstance(s.value, ast.Constant)  # docstring-style comment
            )]
            if body and all(
                isinstance(s, (ast.Pass, ast.Continue)) for s in body
            ):
                what = (
                    ast.unparse(sub.type) if sub.type is not None else "BaseException"
                )
                yield Finding(
                    rule="swallowed-exception",
                    path=sf.display,
                    line=sub.lineno,
                    col=sub.col_offset,
                    message=(
                        f"except {what} swallowed (body is only "
                        "pass/continue) in worker-reachable code — a "
                        "failing worker dies silently; record it (ledger "
                        "event, collected error list like "
                        "tools/tsan_stress.py) or re-raise"
                    ),
                )


RULES = [
    Rule(
        name="thread-unsafe-mutation",
        summary="unlocked shared-attribute mutation in worker callables",
        check=check_thread_mutation,
    ),
    Rule(
        name="swallowed-exception",
        summary="except-pass in worker-reachable code",
        check=check_swallowed_exception,
    ),
]
