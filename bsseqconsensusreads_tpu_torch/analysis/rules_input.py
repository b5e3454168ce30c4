"""graftlint input-hardening rule: bare `assert` on input-derived values.

The failure class this PR's robustness review named (ROADMAP open item:
grow a rule per new failure class): a bare `assert` guarding a value
that came from the input stream — a record field, a buffer length, a
tag — COMPILES AWAY under `python -O`. The check that looked like
validation becomes a no-op, and the corrupt value flows on into the
encoders as silent corruption, the exact outcome the graftguard layer
exists to prevent. Input validation must be a typed raise
(faults.guard.GuardError and friends) that survives every interpreter
mode.

Scope: ingest-owned code — files under `io/` or `pipeline/` — plus any
hot-path-reachable function (so fixtures can seed a violation with a
`hot_`-prefixed function, engine.HOT_PATH_PREFIX). An assert is flagged
when its test touches a plausibly input-derived value: a parameter of
an enclosing function, or any attribute/subscript load (record fields
and buffer indexing both read that way). `assert <constant>` and
asserts over purely local literals stay clean — compiling those away
loses nothing.
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
)

#: path segments whose files are ingest-owned: everything in them
#: handles bytes that came from outside the process
_INPUT_SEGMENTS = frozenset({"io", "pipeline"})


def _in_input_module(sf: SourceFile) -> bool:
    segments = sf.display.replace(os.sep, "/").split("/")
    return bool(_INPUT_SEGMENTS.intersection(segments[:-1]))


def _param_names(sf: SourceFile, node: ast.AST) -> set[str]:
    names: set[str] = set()
    for func in sf.enclosing_functions(node):
        a = func.args
        for arg in (
            a.posonlyargs + a.args + a.kwonlyargs
            + ([a.vararg] if a.vararg else [])
            + ([a.kwarg] if a.kwarg else [])
        ):
            names.add(arg.arg)
    return names


def _tainted_locals(sf: SourceFile, node: ast.AST,
                    params: set[str]) -> set[str]:
    """Names in the innermost enclosing function assigned from a
    plausibly input-derived expression: a parameter, an attribute or
    subscript load (record fields and buffer indexing both read that
    way), or an already-tainted name — fixpoint over simple assigns."""
    funcs = sf.enclosing_functions(node)
    if not funcs:
        return set()
    tainted = set(params)
    changed = True
    while changed:
        changed = False
        for sub in ast.walk(funcs[0]):
            if not isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            value = sub.value
            if value is None or not _expr_tainted(value, tainted):
                continue
            targets = (
                sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            )
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id not in tainted:
                        tainted.add(n.id)
                        changed = True
    return tainted


def _expr_tainted(expr: ast.AST, tainted: set[str]) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, (ast.Attribute, ast.Subscript)):
            return True
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return True
    return False


def check_assert_on_input(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    in_module = _in_input_module(sf)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Assert):
            continue
        if not (in_module or index.in_hot_path(sf, node)):
            continue
        params = _param_names(sf, node)
        if not _expr_tainted(node.test, _tainted_locals(sf, node, params)):
            continue
        yield Finding(
            rule="assert-on-input",
            path=sf.display,
            line=node.lineno,
            col=node.col_offset,
            message=(
                "bare `assert` on an input-derived value in ingest/hot-"
                "path code — asserts compile away under `python -O`, "
                "turning this validation into silent corruption; raise "
                "a typed error instead (faults.guard.GuardError or a "
                "subclass)"
            ),
        )


RULES = [
    Rule(
        name="assert-on-input",
        summary="bare assert on input-derived values in io/pipeline "
        "or hot-path code (vanishes under python -O)",
        check=check_assert_on_input,
    ),
]
