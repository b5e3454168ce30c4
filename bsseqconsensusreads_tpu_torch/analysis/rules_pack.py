"""graftlint rule guarding the segment-packed kernel layout (PR 9).

`padded-batch-flops` flags a padding-envelope allocation on the hot
path: a literal shape tuple densifying three or more ragged dimensions
at once (the [F, T, 2, W] signature — family count x templates x
window all padded to their batch maxima, so device FLOPs scale with
the worst family instead of the real read count). The packed layout
(ops.encode.pack_molecular_rows) replaced that envelope with one dense
row axis + segment ids; new hot-path code should pack, and the two
sanctioned fallback encoders carry reviewed suppressions.

Structural dims stay clean on purpose: `(f, 4, w)` (duplex strand
rows), `(n, 2, w)` (packed rows: read axis is dense, only the bucket
rounds), and `(f, 2, NUM_BASES, w)` (ALL_CAPS names count as
constants) each densify at most two ragged dims.
"""

from __future__ import annotations

import ast
from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
    call_basename,
)

#: Allocators that materialize the envelope. `concatenate`/`stack` grow
#: from real rows and are exempt; so is `empty` handed a computed shape
#: expression (not a literal tuple — those sites shape to an existing
#: array, not to batch maxima).
_ALLOCATORS = frozenset({"full", "zeros", "empty", "ones"})


def _ragged_dim(elt: ast.AST) -> bool:
    """A shape element is ragged when it reads a runtime value: any
    non-ALL_CAPS name anywhere in it (`t_pad`, `w_pad + 1`, `len(x)`).
    Constants and ALL_CAPS module constants (NUM_BASES, LANE) are
    structural."""
    for sub in ast.walk(elt):
        if isinstance(sub, ast.Name) and sub.id != sub.id.upper():
            return True
    return False


def _shape_tuple(call: ast.Call) -> ast.Tuple | None:
    if call.args and isinstance(call.args[0], ast.Tuple):
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "shape" and isinstance(kw.value, ast.Tuple):
            return kw.value
    return None


def check_padded_batch_flops(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    """padded-batch-flops: >=3 ragged dims densified in one allocation
    on a batch-loop-reachable path."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        if call_basename(node) not in _ALLOCATORS:
            continue
        shape = _shape_tuple(node)
        if shape is None or len(shape.elts) < 3:
            continue
        if sum(1 for e in shape.elts if _ragged_dim(e)) < 3:
            continue
        if not index.in_hot_path(sf, node):
            continue
        yield Finding(
            rule="padded-batch-flops",
            path=sf.display,
            line=node.lineno,
            col=node.col_offset,
            message=(
                "padding-envelope allocation on the hot path: this "
                "shape densifies 3+ ragged dims to their batch maxima, "
                "so kernel FLOPs scale with the worst family — use the "
                "segment-packed layout (ops.encode.pack_molecular_rows: "
                "dense row axis + segment ids) instead"
            ),
        )


#: Attributes that mark a segment-packed plan in scope on the batch object.
_PLAN_ATTRS = frozenset({"packed", "packed_shards"})


def _is_envelope_dispatcher(basename: str | None) -> bool:
    """Call basenames that ship input tensors to a multi-device or wire
    route: the sharded shard_map wrappers, the wire input packers, and
    the mesh family padder. Packed-aware callees ('packed'/'rows' in the
    name — pack_molecular_rows_wire, sharded_molecular_rows) are the fix,
    not the finding."""
    if not basename or "packed" in basename or "rows" in basename:
        return False
    return (
        basename.startswith(("sharded_", "pack_"))
        or "wire" in basename
        or basename == "pad_families"
    )


def _own_nodes(func: ast.AST):
    """Walk a function body without descending into nested defs — plan
    availability is judged per closure, not per module."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def check_padded_envelope_dispatch(
    sf: SourceFile, index: PackageIndex
) -> Iterator[Finding]:
    """padded-envelope-dispatch: a hot-path multi-device/wire dispatch
    handed the dense `[F, T, 2, W]` tensors (`<batch>.bases`) inside a
    function where that batch's segment-packed plan (`<batch>.packed` /
    `.packed_shards`) is available."""
    for func in ast.walk(sf.tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        own = list(_own_nodes(func))
        plan_objs = {
            n.value.id
            for n in own
            if isinstance(n, ast.Attribute)
            and n.attr in _PLAN_ATTRS
            and isinstance(n.value, ast.Name)
        }
        if not plan_objs:
            continue
        for call in own:
            if not isinstance(call, ast.Call):
                continue
            if not _is_envelope_dispatcher(call_basename(call)):
                continue
            args = list(call.args) + [kw.value for kw in call.keywords]
            envelope = any(
                isinstance(sub, ast.Attribute)
                and sub.attr == "bases"
                and isinstance(sub.value, ast.Name)
                and sub.value.id in plan_objs
                for a in args
                for sub in ast.walk(a)
            )
            if not envelope or not index.in_hot_path(sf, call):
                continue
            yield Finding(
                rule="padded-envelope-dispatch",
                path=sf.display,
                line=call.lineno,
                col=call.col_offset,
                message=(
                    "padded-envelope dispatch: this multi-device/wire "
                    "call ships the dense [F, T, 2, W] tensors while the "
                    "batch's segment-packed plan (.packed) is in scope — "
                    "dispatch the packed rows instead "
                    "(parallel.sharding.sharded_molecular_rows / "
                    "ops.wire.pack_molecular_rows_wire)"
                ),
            )


RULES = [
    Rule(
        name="padded-batch-flops",
        summary="3+ ragged dims padded to batch maxima in one hot-path "
        "allocation",
        check=check_padded_batch_flops,
    ),
    Rule(
        name="padded-envelope-dispatch",
        summary="dense [F,T,2,W] tensors handed to a multi-device/wire "
        "dispatch while a segment-packed plan is in scope",
        check=check_padded_envelope_dispatch,
    ),
]
