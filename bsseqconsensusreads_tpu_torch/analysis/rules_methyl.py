"""graftlint rule guarding the fused methylation extraction (PR 10).

`unfused-methyl-scan` flags a host-side per-record scan over consensus
base planes on a methyl-reachable hot path: a Python `for` loop that
subscripts a plane array (`bases` / `planes` / `cover` / ...) with its
own loop variable, one record or one site at a time. The methyl
subsystem's contract is that per-column classification and counting
happen INSIDE the vote kernel epilogue (methyl.context.methyl_epilogue,
device or vectorized numpy twin) and only dense [F, 2, W] tallies cross
to the host — a per-record loop re-deriving calls from the planes is
the unfused scan the subsystem exists to delete, and it serializes the
batch loop behind Python interpretation of device-shaped data.

Scope is deliberately narrow: the loop must be hot-path-reachable
(batch-loop roots, engine.HOT_PATH_ROOTS) AND methyl-scoped — in a
`methyl` package file or inside a function whose name says methyl.
The cold emit surface (methyl/emit.py's per-site text writers) runs
once at finalize, off the batch loop, and stays clean by scoping, not
by suppression.
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

#: Array names that carry per-column consensus evidence ([F, R, W] base
#: planes and their methyl products). Subscripting one of these with a
#: loop variable is the per-record scan signature.
_PLANE_NAMES = frozenset(
    {"bases", "planes", "mplanes", "quals", "cover", "cons", "cons_base"}
)

#: Function-name fragment that marks methyl scope outside the package.
_SCOPE_FRAGMENT = "methyl"


def _in_methyl_file(sf: SourceFile) -> bool:
    parts = sf.display.replace(os.sep, "/").split("/")
    return "methyl" in parts[:-1]


def _in_scope(sf: SourceFile, node: ast.AST) -> bool:
    if _in_methyl_file(sf):
        return True
    return any(
        _SCOPE_FRAGMENT in func.name.lower()
        for func in sf.enclosing_functions(node)
    )


def _loop_target_names(target: ast.AST) -> set[str]:
    return {
        sub.id for sub in ast.walk(target) if isinstance(sub, ast.Name)
    }


def _plane_base_name(value: ast.AST) -> str | None:
    """`planes[...]` and `self.planes[...]` both count; deeper chains
    (`batch.meta[i]`) resolve by the final attribute name."""
    if isinstance(value, ast.Name):
        return value.id
    if isinstance(value, ast.Attribute):
        return value.attr
    return None


def check_unfused_methyl_scan(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    """unfused-methyl-scan: hot-path `for` loop subscripting a consensus
    plane array with its loop variable inside methyl scope."""
    for loop in ast.walk(sf.tree):
        if not isinstance(loop, ast.For):
            continue
        if not _in_scope(sf, loop):
            continue
        if not index.in_hot_path(sf, loop):
            continue
        targets = _loop_target_names(loop.target)
        if not targets:
            continue
        for node in ast.walk(loop):
            if not isinstance(node, ast.Subscript):
                continue
            if _plane_base_name(node.value) not in _PLANE_NAMES:
                continue
            idx_names = {
                sub.id
                for sub in ast.walk(node.slice)
                if isinstance(sub, ast.Name)
            }
            if not (idx_names & targets):
                continue
            yield Finding(
                rule="unfused-methyl-scan",
                path=sf.display,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    "host-side per-record scan over consensus base "
                    "planes on a methyl-reachable hot path: "
                    "classification and counting belong in the fused "
                    "kernel epilogue (methyl.context.methyl_epilogue) "
                    "or its vectorized numpy twin — only dense tallies "
                    "should cross the batch loop"
                ),
            )
            break  # one finding per loop


RULES = [
    Rule(
        name="unfused-methyl-scan",
        summary="per-record Python loop over consensus base planes on a "
        "methyl hot path",
        check=check_unfused_methyl_scan,
    ),
]
