"""graftlint rules for card-hostile torch code: unaccounted host syncs
on the hot path, kernel builds on the batch loop, Python branches on
device tensors, and set-order shapes.

The port's counterpart of the JAX package's rules_jax.py. All four
rules work from the run ledger's premise: the batch loop's time must be
attributable. A device-to-host sync the ledger cannot see (`host-sync`),
an nvcc build or library load per batch (`kernel-rebuild`), a Python
branch that silently syncs on a device tensor (`device-branch`), or a
shape that changes with the hash seed (`unordered-shape-iter`) each
breaks that in a different way.

Device taint: a name is a device tensor when it is bound from a vote
kernel wrapper (ops/cuda_vote: seg_vote, seg_vote_partials,
vote_finalize), from a call with a `device=` keyword that is not the
CPU, from `.to(<device>)` / `.cuda()` (a tensor factory's `device=`, not
any call's: a helper taking `device=` may hand back numpy), or from an
expression over
device names. numpy arrays and CPU tensors never are, and taint stops
at `.shape` / `len()`-style reads and at the sinks themselves (an
`.item()` is a host value).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterator

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    Finding,
    PackageIndex,
    Rule,
    SourceFile,
    call_basename,
)

#: each JAX rule of the JAX package's linter -> the port rule that takes
#: its place; every other rule name is shared verbatim
JAX_COUNTERPART = {
    "jit-recompile": "kernel-rebuild",
    "tracer-leak": "device-branch",
}

#: the vote kernel wrappers (ops/cuda_vote.py): their results live on
#: the card whenever the inputs do
KERNEL_WRAPPERS = frozenset({"seg_vote", "seg_vote_partials", "vote_finalize"})

#: torch tensor factories: with a non-CPU `device=` they make a tensor
#: on the card (any other call taking `device=` may return host data)
_TENSOR_FACTORIES = frozenset({
    "tensor", "as_tensor", "zeros", "ones", "empty", "full", "arange",
    "zeros_like", "ones_like", "empty_like", "full_like", "rand", "randn",
    "randint", "linspace", "eye", "empty_strided",
})

#: attributes of a tensor that are tensors themselves
_TENSOR_VIEWS = frozenset({"T", "mT", "H", "data", "real", "imag"})

#: methods that copy a device tensor to the host (or read it there)
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
#: methods / torch functions whose output size depends on the data, so
#: the host waits for the device to learn it
_SIZE_SYNCS = frozenset({"nonzero", "unique", "masked_select"})
#: Python builtins that coerce a tensor to a host scalar
_COERCIONS = frozenset({"float", "int", "bool"})
#: calls that build a boolean mask
_MASK_CALLS = frozenset({
    "isnan", "isfinite", "isinf", "isin", "logical_and", "logical_or",
    "logical_not", "logical_xor", "eq", "ne", "gt", "ge", "lt", "le",
})

#: Expression markers that make a derived value host/static.
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "device",
                           "is_cuda", "numel"})

#: kernel builds and library loads: basenames, and dotted call sources
_BUILD_BASENAMES = frozenset({"_nvcc", "CDLL", "LoadLibrary", "load_library",
                              "load_inline"})
_BUILD_DOTTED = frozenset({"torch.compile", "torch.jit.script",
                           "torch.jit.trace", "cpp_extension.load",
                           "torch.utils.cpp_extension.load"})
_CACHE_DECORATORS = frozenset({"lru_cache", "cache", "cached_property"})

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


def _assign_targets(node: ast.AST) -> list[str]:
    """Plain-name targets of an Assign/AugAssign/For/comprehension/with."""
    out: list[str] = []

    def grab(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                grab(e)
        elif isinstance(t, ast.Starred):
            grab(t.value)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            grab(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        grab(node.target)
    elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
        grab(node.target)
    elif isinstance(node, ast.withitem) and node.optional_vars is not None:
        grab(node.optional_vars)
    return out


def _is_cpu(expr: ast.AST) -> bool:
    """`"cpu"`, `torch.device("cpu")`, `CPU`-named constants."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cpu")
    if isinstance(expr, ast.Call) and call_basename(expr) == "device":
        return bool(expr.args) and _is_cpu(expr.args[0])
    if isinstance(expr, ast.Name):
        return expr.id.lower() in ("cpu", "_cpu", "cpu_device")
    return False


def _device_arg(expr: ast.AST) -> bool:
    """True when `.to(expr)` moves to a device: a non-CPU device string,
    torch.device(...), or a device-named variable (never a dtype)."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and not _is_cpu(expr)
    if _is_cpu(expr):
        return False
    if isinstance(expr, ast.Call):
        return call_basename(expr) == "device"
    src = ast.unparse(expr).lower()
    return "device" in src or src.split(".")[-1] in ("dev", "devices")


@dataclass(frozen=True)
class Calls:
    """What the linted set says about its own functions' results, by
    basename: `producers` return a device tensor whatever their
    arguments (every definition of the name does), `hosted` never return
    one (defined in the set, and device arguments do not reach the
    result). A call to anything else (a torch op, a tensor method, a
    function of the set whose result follows its arguments) carries the
    taint of its arguments and receiver."""

    producers: frozenset = frozenset()
    hosted: frozenset = frozenset()


def _is_device_source(call: ast.Call, calls: Calls) -> bool:
    base = call_basename(call)
    if base in KERNEL_WRAPPERS or base in calls.producers:
        return True
    if base == "cuda" and isinstance(call.func, ast.Attribute):
        return True
    torch_call = base in _TENSOR_FACTORIES or (
        _root_name(call.func) == "torch"
        and not (base and base[0].isupper())  # Stream, Event: no tensor
    )
    for kw in call.keywords:
        if kw.arg == "device" and torch_call and not _is_cpu(kw.value) and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ):
            return True
    if base == "to" and isinstance(call.func, ast.Attribute):
        return any(_device_arg(a) for a in call.args)
    return False


def _is_sink(call: ast.Call) -> bool:
    """Calls whose result is a host value whatever their input."""
    base = call_basename(call)
    if isinstance(call.func, ast.Attribute) and base in _SYNC_METHODS:
        return True
    if base in _COERCIONS:
        return True
    if base == "to" and any(_is_cpu(a) for a in call.args):
        return True
    # a tensor made on, or moved to, the CPU is a host value
    return any(kw.arg == "device" and _is_cpu(kw.value) for kw in call.keywords)


def _host_call(call: ast.Call, calls: Calls) -> bool:
    """Calls whose result is never a device tensor: host reads
    (len, isinstance), sinks, numpy, objects built around tensors (a
    capitalized constructor), and the set's own host functions."""
    base = call_basename(call)
    if base in ("len", "isinstance") or _is_sink(call) or base in calls.hosted:
        return True
    if base and base[0].isupper():
        return True
    return _root_name(call.func) in ("np", "numpy")


def _root_name(expr: ast.AST) -> str | None:
    """`torch` for `torch.cuda.synchronize`, None for a call's result."""
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _device_refs(expr: ast.AST, device: set[str],
                 calls: Calls) -> set[str]:
    """Device names `expr` reads as tensors: not through a static read
    (`.shape`, len()), an object's field, a `None` test, or a call that
    yields a host value (`.item()`, int(), numpy, a host function)."""
    hits: set[str] = set()
    callees: set[int] = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Name):
            if node.id in device:
                hits.add(node.id)
            continue
        if isinstance(node, ast.Attribute) and (
            node.attr in _STATIC_ATTRS
            or (node.attr not in _TENSOR_VIEWS and id(node) not in callees)
        ):
            continue  # a shape, or a field of an object (`store.length`)
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            continue  # `x is None` tests structure, not a value
        if isinstance(node, ast.Call):
            if _host_call(node, calls):
                continue
            callees.add(id(node.func))
        stack.extend(ast.iter_child_nodes(node))
    return hits


def _device_names(func: ast.AST, calls: Calls,
                  seed: frozenset = frozenset()) -> set[str]:
    """Names in `func`'s scope (closures included) bound to device
    tensors, starting from `seed`. Propagates through assignments, tuple
    packs and iteration (``for v in out`` taints v) in two passes, so
    loop-carried bindings settle too."""
    device: set[str] = set(seed)
    for _ in range(2):
        for node in _bindings(func):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if node.value is not None and _is_device_expr(
                        node.value, device, calls):
                    device.update(_assign_targets(node))
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                if _device_refs(node.iter, device, calls):
                    device.update(_assign_targets(node))
            elif isinstance(node, ast.withitem):
                if _device_refs(node.context_expr, device, calls):
                    device.update(_assign_targets(node))
    return device


_BINDERS = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.For, ast.AsyncFor,
            ast.comprehension, ast.withitem)


def _bindings(func: ast.AST) -> list:
    """The binding nodes of `func`'s whole tree, in walk order (kept on
    the node: the taint passes revisit every function many times)."""
    found = getattr(func, "_graft_bindings", None)
    if found is None:
        found = [n for n in ast.walk(func) if isinstance(n, _BINDERS)]
        func._graft_bindings = found
    return found


def _returns(func: ast.AST) -> list:
    found = getattr(func, "_graft_returns", None)
    if found is None:
        found = [n.value for n in PackageIndex._own_nodes(func)
                 if isinstance(n, ast.Return) and n.value is not None]
        func._graft_returns = found
    return found


def _is_device_expr(expr: ast.AST, device: set[str], calls: Calls) -> bool:
    """True when `expr` evaluates to (or packs) a device tensor: a device
    source not wrapped in a host call, or a read of a device name."""
    if isinstance(expr, ast.Call) and _host_call(expr, calls):
        return False
    if _device_refs(expr, device, calls):
        return True
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            if _is_device_source(node, calls):
                return True
            if _host_call(node, calls):
                continue
        stack.extend(ast.iter_child_nodes(node))
    return False


def device_calls(index: PackageIndex) -> Calls:
    """The Calls of the linted set, to a fixpoint: a producer returns a
    kernel wrapper's result, a tensor made on the card, or another
    producer's, so `out = molecular_consensus_packed(...)` taints `out`
    as the wrapper call inside it does; a function is hosted when its
    result stays host even with every argument on the card. Computed
    once per index."""
    cached = getattr(index, "_torch_calls", None)
    if cached is not None:
        return cached
    defined = frozenset(index.functions) - KERNEL_WRAPPERS
    producers: set[str] = set()
    follows: set[str] = set()  # result follows the arguments
    callers: dict[str, set[str]] = {}
    for name, fis in index.functions.items():
        for fi in fis:
            for callee in fi.calls:
                callers.setdefault(callee, set()).add(name)
    # a worklist: a name is looked at again only when one it calls moved
    pending = set(index.functions) - KERNEL_WRAPPERS
    while pending:
        calls = Calls(frozenset(producers),
                      defined - producers - follows)
        moved = set()
        for name in sorted(pending):
            fis = index.functions[name]
            if name in producers:
                continue
            if all(_returns_device(fi.node, calls, frozenset()) for fi in fis):
                producers.add(name)
                moved.add(name)
            elif name not in follows and any(
                _returns_device(fi.node, calls, _params(fi.node)) for fi in fis
            ):
                follows.add(name)
                moved.add(name)
        pending = set().union(*(callers.get(m, ()) for m in moved)) - producers
    calls = Calls(frozenset(producers) | KERNEL_WRAPPERS,
                  defined - producers - follows)
    index._torch_calls = calls
    return calls


def _params(func: ast.AST) -> frozenset:
    args = func.args
    names = {a.arg for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)}
    return frozenset(names - {"self", "cls"})


def _returns_device(func: ast.AST, calls: Calls, seed: frozenset) -> bool:
    values = _returns(func)
    if not values:
        return False
    device = _device_names(func, calls, seed)
    return any(_is_device_expr(v, device, calls) for v in values)


def _mask_names(func: ast.AST) -> set[str]:
    """Names bound to a boolean mask: a comparison, `~m`, `m & n`, or a
    mask-building call."""
    masks: set[str] = set()
    for _ in range(2):
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and _is_mask(node.value, masks):
                masks.update(_assign_targets(node))
    return masks


def _is_mask(expr: ast.AST, masks: set[str]) -> bool:
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in masks
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _is_mask(expr.operand, masks)
    if isinstance(expr, ast.BinOp) and isinstance(
        expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return _is_mask(expr.left, masks) or _is_mask(expr.right, masks)
    if isinstance(expr, ast.Call):
        return call_basename(expr) in _MASK_CALLS
    return False


def _toplevel_hot(sf: SourceFile, index: PackageIndex) -> Iterator[ast.AST]:
    """Top-level (non-nested) hot-reachable functions: nested defs share
    the enclosing scope's bindings, so analysis is at this granularity."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, _FUNCS) or sf.enclosing_functions(node):
            continue
        reach = [node] + [
            sub for sub in ast.walk(node) if isinstance(sub, _FUNCS)
        ]
        if any(
            (fi := index.info(f)) is not None
            and fi.qualname in index.hot_reachable
            for f in reach
        ):
            yield node


def _sync_of(call: ast.Call, device: set[str], calls: Calls) -> str | None:
    """Why `call` synchronizes the host with the card, or None."""
    base = call_basename(call)
    func = call.func
    dotted = ast.unparse(func)
    if base == "synchronize":
        return f"{dotted}()"
    if isinstance(func, ast.Attribute):
        recv = _device_refs(func.value, device, calls)
        if base in _SYNC_METHODS and recv:
            return f".{base}() on a device tensor"
        if base == "to" and recv and (
            any(_is_cpu(a) for a in call.args)
            or any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in call.keywords)
        ):
            return ".to('cpu') on a device tensor"
        if base in _SIZE_SYNCS and (
            recv or any(_device_refs(a, device, calls) for a in call.args)
        ):
            return f"{base}() on a device tensor (data-dependent size)"
    elif base in _SIZE_SYNCS and any(_device_refs(a, device, calls) for a in call.args):
        return f"{base}() on a device tensor (data-dependent size)"
    if base in _COERCIONS and isinstance(func, ast.Name) and call.args and (
        _device_refs(call.args[0], device, calls)
    ):
        return f"{base}() on a device tensor"
    return None


class _Scope:
    """The device names visible at a node of a top-level function: a
    nested def's parameters shadow the enclosing scope's bindings (a
    `wire` flag parameter is not the outer function's wire tensor)."""

    def __init__(self, sf: SourceFile, top: ast.AST, device: set[str]):
        self.sf, self.top, self.all = sf, top, device
        self._by_func: dict[int, set[str]] = {}

    def device(self, node: ast.AST) -> set[str]:
        inner = self.sf.enclosing_functions(node)
        if not inner or inner[0] is self.top:
            return self.all
        key = id(inner[0])
        if key not in self._by_func:
            shadow: set[str] = set()
            for f in inner:
                if f is self.top:
                    break
                args = f.args
                shadow.update(a.arg for a in (*args.posonlyargs, *args.args,
                                              *args.kwonlyargs))
            self._by_func[key] = self.all - shadow
        return self._by_func[key]


def check_host_sync(sf: SourceFile, index: PackageIndex) -> Iterator[Finding]:
    """host-sync: device->host synchronization on a batch-loop-reachable
    path outside an accounted ledger span."""
    calls = device_calls(index)
    for func in _toplevel_hot(sf, index):
        scope = _Scope(sf, func, _device_names(func, calls))
        masks = _mask_names(func)
        for sub in ast.walk(func):
            device = scope.device(sub)
            flagged = None
            if isinstance(sub, ast.Call):
                flagged = _sync_of(sub, device, calls)
            elif (
                isinstance(sub, ast.Subscript)
                and isinstance(sub.ctx, ast.Load)
                and _device_refs(sub.value, device, calls)
                and _is_mask(sub.slice, masks)
                and _device_refs(sub.slice, device, calls)
            ):
                flagged = "boolean-mask index of a device tensor"
            if flagged is None or sf.in_accounted_span(sub):
                continue
            yield Finding(
                rule="host-sync",
                path=sf.display,
                line=sub.lineno,
                col=sub.col_offset,
                message=(
                    f"{flagged} in batch-loop-reachable code — the card "
                    "stalls the host here invisibly; move it under "
                    "`with metrics.timed(\"device_wait\")` (or another "
                    "accounted span) or off the hot path"
                ),
            )


def _module_names(sf: SourceFile) -> set[str]:
    out: set[str] = set()
    for node in sf.tree.body:
        out.update(_assign_targets(node))
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _has_module_cache(func: ast.AST, module_names: set[str]) -> bool:
    """True when `func` keeps what it builds at module level: a cache
    decorator, a `global` rebinding, or a store into a module-level
    container (`_libs[key] = lib`)."""
    for deco in func.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        name = target.attr if isinstance(target, ast.Attribute) else getattr(
            target, "id", None)
        if name in _CACHE_DECORATORS:
            return True
    for sub in ast.walk(func):
        if isinstance(sub, ast.Global):
            return True
        if (isinstance(sub, ast.Subscript) and isinstance(sub.ctx, ast.Store)
                and isinstance(sub.value, ast.Name)
                and sub.value.id in module_names):
            return True
    return False


def _uncached_hot(index: PackageIndex) -> set[str]:
    """Hot-path reachability that stops at functions with a module-level
    cache: a build helper that only a cached loader calls runs once per
    process, not once per batch."""
    found = getattr(index, "_torch_uncached_hot", None)
    if found is not None:
        return found
    names: dict[int, set[str]] = {}
    by_qual = {fi.qualname: fi for fis in index.functions.values() for fi in fis}
    roots = [q for q in index.hot_reachable
             if q in by_qual and by_qual[q].basename in index.hot_root_names]
    seen: set[str] = set()
    frontier = list(roots)
    while frontier:
        q = frontier.pop()
        if q in seen:
            continue
        fi = by_qual[q]
        key = id(fi.sf)
        if key not in names:
            names[key] = _module_names(fi.sf)
        if _has_module_cache(fi.node, names[key]):
            continue
        seen.add(q)
        for callee in fi.calls:
            frontier.extend(n.qualname for n in index.functions.get(callee, ()))
    index._torch_uncached_hot = seen
    return seen


def _is_build(call: ast.Call) -> bool:
    if call_basename(call) in _BUILD_BASENAMES:
        return True
    dotted = ast.unparse(call.func)
    return any(dotted == d or dotted.endswith("." + d) for d in _BUILD_DOTTED)


def check_kernel_rebuild(sf: SourceFile, index: PackageIndex) -> Iterator[Finding]:
    """kernel-rebuild: an nvcc build, a library load, torch.compile or
    torch.jit on the batch loop or inside a loop, with no module-level
    cache in front of it: every batch (or iteration) pays the build."""
    module_names = _module_names(sf)
    uncached = _uncached_hot(index)
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call) or not _is_build(node):
            continue
        funcs = sf.enclosing_functions(node)
        in_loop = False
        cur = sf.parents.get(node)
        while cur is not None and not isinstance(cur, _FUNCS):
            if isinstance(cur, _LOOPS):
                in_loop = True
                break
            cur = sf.parents.get(cur)
        if any(_has_module_cache(f, module_names) for f in funcs):
            continue
        hot = any(
            (fi := index.info(f)) is not None and fi.qualname in uncached
            for f in funcs
        )
        if not (in_loop or hot):
            continue
        where = "inside a loop" if in_loop else "in batch-loop-reachable code"
        yield Finding(
            rule="kernel-rebuild",
            path=sf.display,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"{ast.unparse(node.func)}() {where} with no module-level "
                "cache — every batch pays the build or load; keep the "
                "result in a module cache (cf. ops.cuda_vote._load)"
            ),
        )


def _is_none_check(test: ast.AST) -> bool:
    """`x is None` / `x is not None` (and and/or/not combinations) test
    argument structure, not tensor values."""
    if isinstance(test, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
    if isinstance(test, ast.BoolOp):
        return all(_is_none_check(v) for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_none_check(test.operand)
    return False


def check_device_branch(sf: SourceFile, index: PackageIndex) -> Iterator[Finding]:
    """device-branch: Python `if` / `while` / `assert` / ternary /
    `and` / `or` on a device tensor in batch-loop-reachable code — each
    is a hidden bool() that waits for the card."""
    calls = device_calls(index)
    tests_of = (ast.If, ast.While, ast.Assert, ast.IfExp)
    for func in _toplevel_hot(sf, index):
        scope = _Scope(sf, func, _device_names(func, calls))
        for sub in ast.walk(func):
            device = scope.device(sub)
            tests: list[tuple[ast.AST, str]] = []
            if isinstance(sub, (ast.If, ast.While)):
                tests = [(sub.test, type(sub).__name__.lower())]
            elif isinstance(sub, ast.Assert):
                tests = [(sub.test, "assert")]
            elif isinstance(sub, ast.IfExp):
                tests = [(sub.test, "ternary")]
            elif isinstance(sub, ast.BoolOp) and not (
                isinstance(sf.parents.get(sub), tests_of)
                and sf.parents[sub].test is sub
            ):  # a branch's own test is reported as the branch
                kind = "and" if isinstance(sub.op, ast.And) else "or"
                tests = [(v, kind) for v in sub.values
                         if not isinstance(v, (ast.BoolOp, ast.Compare,
                                               ast.UnaryOp))]
            for test, what in tests:
                if _is_none_check(test) or sf.in_accounted_span(sub):
                    continue
                hits = _device_refs(test, device, calls)
                if not hits:
                    continue
                yield Finding(
                    rule="device-branch",
                    path=sf.display,
                    line=sub.lineno,
                    col=sub.col_offset,
                    message=(
                        f"Python {what} on device tensor(s) {sorted(hits)} "
                        "in batch-loop-reachable code — a hidden bool() "
                        "that waits for the card, which the ledger cannot "
                        "see; use torch.where / a host-side count, or "
                        "fetch under an accounted span"
                    ),
                )
                break


def _setish(expr: ast.AST, set_names: set[str]) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call) and call_basename(expr) in ("set", "frozenset"):
        return True
    if isinstance(expr, ast.Name) and expr.id in set_names:
        return True
    if isinstance(expr, ast.BinOp):  # s1 | s2 unions
        return _setish(expr.left, set_names) or _setish(expr.right, set_names)
    return False


def check_unordered_iter(sf: SourceFile, index: PackageIndex) -> Iterator[Finding]:
    """unordered-shape-iter: iterating a set on a hot/jit-reachable path
    — order varies with hash seed, so anything shape-bearing downstream
    (bucket boundaries, pad widths, device placement) changes between
    runs or diverges between the ranks of a multi-process job."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, _FUNCS):
            continue
        fi = index.info(node)
        if fi is None:
            continue
        if (
            fi.qualname not in index.hot_reachable
            and fi.qualname not in index.jit_reachable
        ):
            continue
        set_names: set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _setish(sub.value, set_names):
                set_names.update(_assign_targets(sub))
        for sub in ast.walk(node):
            iters = []
            if isinstance(sub, (ast.For, ast.AsyncFor)):
                iters = [sub.iter]
            elif isinstance(sub, ast.comprehension):
                iters = [sub.iter]
            for it in iters:
                if _setish(it, set_names):
                    yield Finding(
                        rule="unordered-shape-iter",
                        path=sf.display,
                        line=it.lineno,
                        col=it.col_offset,
                        message=(
                            "iterating a set on a hot/jit-reachable path "
                            "— iteration order follows the hash seed, so "
                            "downstream batch shapes and device placement "
                            "become run-dependent; iterate "
                            "sorted(...) instead"
                        ),
                    )


RULES = [
    Rule(
        name="host-sync",
        summary="device->host sync on the batch loop outside an "
        "accounted ledger span",
        check=check_host_sync,
    ),
    Rule(
        name="kernel-rebuild",
        summary="nvcc build, library load, torch.compile or torch.jit on "
        "the batch loop or in a loop, with no module-level cache",
        check=check_kernel_rebuild,
    ),
    Rule(
        name="device-branch",
        summary="Python if/while/assert/ternary/and/or on a device tensor "
        "on the batch loop (a hidden sync)",
        check=check_device_branch,
    ),
    Rule(
        name="unordered-shape-iter",
        summary="set iteration feeding shapes on a hot/jit path",
        check=check_unordered_iter,
    ),
]
