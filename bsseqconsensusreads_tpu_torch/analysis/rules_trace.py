"""graftlint tracing-discipline rule: untraced transport send.

The failure class grafttrace (trace-context propagation) introduces: a
process hands WORK — a job spec, a slice, a chunk — to another process
over the framed transport without a trace context in scope. The
receiver then mints a fresh trace for work that already has one, the
causal tree breaks at the process boundary, and `observe trace` cannot
attribute the receiver's wall back to the sender's job/slice — exactly
the cross-process blindness the tracing plane exists to remove. The
sanctioned shape: the dispatching scope binds the work's trace context
(`observe.bind_trace(...) as trace_ctx`, `slice_trace = sl["trace"]`,
...) so transport.request ships it as the `_trace` wire field.

Scope: files that import `serve.transport`. A `request`/`send_message`
call is flagged when a dict-literal argument carries a work-payload key
("spec", "slice", "chunk") and the enclosing function binds no name
containing 'trace'. Control-plane sends (ping, wait, status, lease
polls, heartbeats) carry no work key and stay clean; payloads passed as
bare variables are conservatively skipped — the rule targets the
literal dispatch sites where the work being shipped is visible.
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
    _bound_names,
    _imports_serve_transport,
    _SEND_NAMES,
)

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)

#: Dict-literal keys that mark a payload as carrying WORK (not control
#: traffic): a serve job spec, an elastic slice, a batch chunk.
_WORK_KEYS = frozenset({"spec", "slice", "chunk"})


def _work_keys_in(call: ast.Call) -> set[str]:
    """Work-payload keys among the dict LITERALS of this call's
    arguments (bare-variable payloads are skipped by construction)."""
    found: set[str] = set()
    for arg in (*call.args, *(kw.value for kw in call.keywords)):
        for node in ast.walk(arg):
            if not isinstance(node, ast.Dict):
                continue
            for key in node.keys:
                if (
                    isinstance(key, ast.Constant)
                    and isinstance(key.value, str)
                    and key.value in _WORK_KEYS
                ):
                    found.add(key.value)
    return found


def _holds_trace(names: set[str]) -> bool:
    return any("trace" in n.lower() for n in names)


def _scope_of(sf: SourceFile, node: ast.AST) -> ast.AST:
    for func in sf.enclosing_functions(node):
        return func
    return sf.tree


def check_untraced_transport_send(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    if not _imports_serve_transport(sf):
        return
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = (
            func.attr if isinstance(func, ast.Attribute)
            else func.id if isinstance(func, ast.Name)
            else ""
        )
        if name not in _SEND_NAMES:
            continue
        keys = _work_keys_in(node)
        if not keys:
            continue
        scope = _scope_of(sf, node)
        if isinstance(scope, _FUNCS) and _holds_trace(_bound_names(scope)):
            continue
        yield Finding(
            rule="untraced-transport-send",
            path=sf.display,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"work payload ({', '.join(sorted(keys))}) handed to a "
                "transport send with no trace context in scope — the "
                "receiver cannot join the sender's causal tree and "
                "`observe trace` loses the cross-process attribution; "
                "bind the work's context first "
                "(observe.bind_trace(...) as trace_ctx) so the `_trace` "
                "wire field ships with the request"
            ),
        )


RULES = [
    Rule(
        name="untraced-transport-send",
        summary="job/slice/chunk payload sent over the transport with "
        "no trace context bound in the dispatching scope",
        check=check_untraced_transport_send,
    ),
]
