"""graftlint fencing-discipline rule: unfenced commit.

The failure class graftnet's epoch fencing exists to close: a process
that publishes work — a `publish` / `slice_push` commit frame — from a
scope that carries no fence epoch. Lease expiry alone cannot stop such
a sender: a worker partitioned away from the coordinator keeps
computing, the slice is requeued, and when the partition heals the
zombie's commit races the new holder's. The sanctioned shape is the
fence protocol: the committing scope holds the epoch its lease grant
minted (and echoes it in the frame), so the coordinator can refuse the
stale writer with `publish_fenced` and the worker can self-fence via
`fencing.revoke` the moment its renewal pump loses the lease.

Scope: files that import `serve.transport` (the elastic wire). A
transport send is flagged when its payload names a commit-shaped op
(`publish` / `slice_push` / `commit`) while the enclosing function
binds no fence-epoch name (`epoch` / `fence*`). Read-shaped ops
(`lease`, `heartbeat`, `slice_fetch`, `status`) commit nothing and are
never flagged.
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
from bsseqconsensusreads_tpu_torch.analysis.rules_elastic import (
    _FUNCS,
    _bound_names,
    _imports_serve_transport,
)

#: Transport send entry points (same wire surface the elastic rule
#: watches).
_SEND_NAMES = frozenset({"request", "send_message"})

#: Op literals that make a frame a COMMIT: they transition durable
#: coordinator state (manifest commit, shipped-output bytes).
_COMMIT_OPS = frozenset({"publish", "slice_push", "commit"})


def _holds_fence(names: set[str]) -> bool:
    low = [n.lower() for n in names]
    return any("epoch" in n or "fence" in n for n in low)


def _commit_op(call: ast.Call) -> str | None:
    """The commit-shaped op literal a send's payload carries, if any."""
    for node in ast.walk(call):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and node.value in _COMMIT_OPS
        ):
            return node.value
    return None


def _sends_outside_nested(scope: ast.AST) -> list[ast.Call]:
    """Transport send calls belonging to this scope (nested function
    bodies are their own scopes — a closure may bind its own epoch —
    and are visited separately)."""
    out: list[ast.Call] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCS):
                continue
            if isinstance(child, ast.Call):
                func = child.func
                name = (
                    func.attr if isinstance(func, ast.Attribute)
                    else func.id if isinstance(func, ast.Name)
                    else ""
                )
                if name in _SEND_NAMES:
                    out.append(child)
            visit(child)

    visit(scope)
    return out


def check_unfenced_commit(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    if not _imports_serve_transport(sf):
        return
    scopes: list[ast.AST] = [sf.tree]
    scopes.extend(n for n in ast.walk(sf.tree) if isinstance(n, _FUNCS))
    for scope in scopes:
        fenced = isinstance(scope, _FUNCS) and _holds_fence(
            _bound_names(scope)
        )
        if fenced:
            continue
        for node in _sends_outside_nested(scope):
            op = _commit_op(node)
            if op is None:
                continue
            yield Finding(
                rule="unfenced-commit",
                path=sf.display,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"{op!r} frame sent with no fence epoch in scope — "
                    "a partitioned zombie holding this code path can "
                    "commit over the requeued holder after the "
                    "partition heals; carry the lease grant's "
                    "fence_epoch in the payload and abort locally via "
                    "fencing.revoke when the renewal pump loses the "
                    "lease"
                ),
            )


RULES = [
    Rule(
        name="unfenced-commit",
        summary="commit-shaped frame (publish/slice_push) sent without "
        "a fence epoch in scope (zombie writer can race the requeued "
        "holder)",
        check=check_unfenced_commit,
    ),
]
