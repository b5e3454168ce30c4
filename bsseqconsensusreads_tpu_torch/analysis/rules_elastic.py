"""graftlint elastic-discipline rule: unleased work dispatch.

The failure class graftswarm (elastic/) introduces: a coordinator or
worker loop that hands a work slice to a transport send without a
lease in scope. An unleased dispatch is work the ledger cannot
recover — when the receiving process dies, no lease expires, no
`slice_requeued` fires, and the run hangs or silently drops the
slice's families. The sanctioned shape is the elastic lease protocol:
the dispatching scope holds a lease id AND tracks its expiry (or runs
the renewal pump that does), so every in-flight slice is reclaimable.

Scope: files that import `serve.transport` (the elastic wire). A loop
is flagged when it sends a payload mentioning a slice through
`request`/`send_message` while its enclosing function binds no
lease-id name and no expiry/renewal name.
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

#: Transport send entry points a dispatch loop hands work to.
_SEND_NAMES = frozenset({"request", "send_message"})

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


def _imports_serve_transport(sf: SourceFile) -> bool:
    """True when the file imports `<package>.serve.transport`, whatever
    the package root is called."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            if any(
                a.name.split(".")[1:] == ["serve", "transport"]
                for a in node.names
            ):
                return True
        elif isinstance(node, ast.ImportFrom):
            tail = (node.module or "").split(".")[1:]
            if tail == ["serve", "transport"]:
                return True
            if tail == ["serve"] and any(
                a.name == "transport" for a in node.names
            ):
                return True
    return False


def _bound_names(fn: ast.AST) -> set[str]:
    """Names a function binds: parameters plus every Store-context Name
    (assignments, loop targets, withitems)."""
    names: set[str] = set()
    if isinstance(fn, _FUNCS):
        args = fn.args
        for a in (*args.posonlyargs, *args.args, *args.kwonlyargs):
            names.add(a.arg)
        if args.vararg:
            names.add(args.vararg.arg)
        if args.kwarg:
            names.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _holds_lease(names: set[str]) -> bool:
    low = [n.lower() for n in names]
    has_lease = any("lease" in n for n in low)
    has_expiry = any("expir" in n or "renew" in n for n in low)
    return has_lease and has_expiry


def _loops_outside_nested(scope: ast.AST) -> list[ast.AST]:
    """Loop statements belonging to this scope (nested function bodies
    are their own scopes and are visited separately)."""
    out: list[ast.AST] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCS):
                continue
            if isinstance(child, _LOOPS):
                out.append(child)
            visit(child)

    visit(scope)
    return out


def _mentions_slice(call: ast.Call) -> bool:
    """The payload names a work slice: a wire-field string constant
    containing 'slice' (e.g. {'slice': ...}) or a value named exactly
    slice/slices. Deliberately NOT a substring match on identifiers —
    a `slice_s` time-slice is not a work slice."""
    for node in ast.walk(call):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and "slice" in node.value.lower()
        ):
            return True
        if isinstance(node, ast.Name) and node.id.lower() in (
            "slice", "slices"
        ):
            return True
    return False


def _send_calls(loop: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(loop):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = (
            func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name)
            else ""
        )
        if name in _SEND_NAMES:
            yield node


def check_unleased_work_dispatch(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    if not _imports_serve_transport(sf):
        return
    scopes: list[ast.AST] = [sf.tree]
    scopes.extend(
        n for n in ast.walk(sf.tree) if isinstance(n, _FUNCS)
    )
    for scope in scopes:
        # module-level dispatch loops have no lease scope by definition
        leased = isinstance(scope, _FUNCS) and _holds_lease(
            _bound_names(scope)
        )
        if leased:
            continue
        for loop in _loops_outside_nested(scope):
            for call in _send_calls(loop):
                if not _mentions_slice(call):
                    continue
                yield Finding(
                    rule="unleased-work-dispatch",
                    path=sf.display,
                    line=call.lineno,
                    col=call.col_offset,
                    message=(
                        "loop hands a work slice to a transport send "
                        "with no lease id + expiry in scope — if the "
                        "receiver dies, no lease expires, no "
                        "slice_requeued fires, and the slice's "
                        "families are silently lost; dispatch under "
                        "the elastic lease protocol (hold a lease_id "
                        "and track lease_expires / run the renewal "
                        "pump)"
                    ),
                )


RULES = [
    Rule(
        name="unleased-work-dispatch",
        summary="slice handed to a transport send without a lease id + "
        "expiry in scope (unrecoverable on receiver death)",
        check=check_unleased_work_dispatch,
    ),
]
