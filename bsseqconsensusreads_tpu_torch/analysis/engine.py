"""graftlint engine: source model, suppressions, call graph, runner.

The port's copy of the JAX package's analysis/engine.py: the same
source model, suppression grammar and reachability, with the torch
rules (rules_torch) in place of the JAX ones.

The engine is deliberately self-contained stdlib (ast + tokenize): it
must run in the tier-1 suite on every PR with zero extra deps, and it
must be able to lint arbitrary file sets (the seeded-violation fixtures
under tests/data/torch_lint_fixtures/) — so all cross-file context (call
graph, hot-path/jit/worker reachability) is rebuilt from exactly the
files being linted, never from imports.

Two naming layers coexist:

* Reachability stays basename-level on purpose: `events()` calling
  `dispatch_fetch` resolves to pipeline.calling's nested def without a
  type system. That makes reachability generous (a shared basename
  links both definitions), which is the right bias for a linter gating
  a hot path — a missed edge hides a stall, a spurious edge costs at
  most one reviewed suppression.
* Extraction facts (the graftcontract pass in analysis.contracts)
  need the opposite bias: `observe.emit(...)` must attribute to
  utils.observe.emit and nowhere else, or a same-named helper would
  pollute the ledger-event census. For that, every SourceFile carries
  a module name derived from its display path plus import/alias maps
  (`import x as y`, `from m import n`, relative imports resolved
  against the module), and PackageIndex exposes a qualified function
  table and `resolve_call`, which returns the dotted target of a call
  when the aliases pin it down and None when they don't.
"""

from __future__ import annotations

import ast
import io
import os
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

SUPPRESS_TAG = "graftlint:"

#: Ledger span names under which a host sync is *accounted* — the
#: ledger's device/stall phases (utils.observe.DEVICE_PHASES) plus the
#: host-side spans the pipeline books synchronous waits under
#: ('stall' = main-thread join on an overlapped batch, 'host_vote' =
#: the T==1 path that never touches the device, 'degrade' = the
#: CPU-twin fallback of a persistently failing batch, faults.retry).
ACCOUNTED_SPANS = frozenset(
    {"kernel", "device_wait", "fetch", "stall", "host_vote", "degrade",
     "methyl"}
)

#: Functions treated as batch-loop roots for hot-path reachability: the
#: two stage drivers, their flat-record wrappers — and, by convention,
#: any function whose name starts with `hot_` (so new hot paths opt in
#: by naming, and fixtures can seed one without package knowledge).
HOT_PATH_ROOTS = frozenset(
    {
        "call_molecular_batches",
        "call_duplex_batches",
        "call_molecular",
        "call_duplex",
    }
)
HOT_PATH_PREFIX = "hot_"


class LintError(Exception):
    """Usage error: unknown rule name (in --rules or a suppression),
    unparseable file, bad path. Distinct from findings — the CLI exits
    2 for these, 1 for findings."""


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # display (relative) path
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclass
class Rule:
    name: str
    summary: str
    check: Callable[["SourceFile", "PackageIndex"], Iterator[Finding]]


def module_name(display: str) -> str:
    """Dotted module name derived from a display path:
    `bsseqconsensusreads_tpu_torch/utils/observe.py` -> the obvious dotted
    form, `pkg/__init__.py` -> `pkg`. Paths outside any package still
    get a stable dotted name (fixtures resolve against themselves)."""
    p = display.replace(os.sep, "/").lstrip("./")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [seg for seg in p.split("/") if seg]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class SourceFile:
    """One parsed file: AST with parent links, suppression tables, and
    the import/alias maps qualified-name resolution reads."""

    def __init__(self, path: str, display: str, source: str,
                 known_rules: Iterable[str],
                 aliases: dict[str, str] | None = None):
        self.path = path
        self.display = display
        self.source = source
        try:
            self.tree = ast.parse(source, filename=display)
        except SyntaxError as exc:
            raise LintError(f"{display}: cannot parse: {exc}") from exc
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.module = module_name(display)
        #: local name -> dotted module (`import x.y as z` => z: x.y)
        self.import_aliases: dict[str, str] = {}
        #: local name -> (dotted module, original name) for
        #: `from m import n as k` => k: (m, n); relative imports are
        #: resolved against self.module
        self.from_imports: dict[str, tuple[str, str]] = {}
        #: top-level def/class names defined in this module
        self.toplevel_defs: set[str] = set()
        self._scan_imports()
        self.line_suppress: dict[int, set[str]] = {}
        self.file_suppress: set[str] = set()
        #: lines whose Thread(...) call is a declared single-owner
        #: thread (`# graftlint: owned-thread`) — not a worker root
        self.owned_thread_lines: set[int] = set()
        #: a suppression naming an alias (a JAX rule name) covers the
        #: rule it maps to, so the JAX package's own directives read
        #: right in audit mode
        self._aliases = dict(aliases or {})
        self._scan_suppressions(set(known_rules) | set(self._aliases))

    # -- imports / qualified names ---------------------------------------

    def _resolve_relative(self, level: int, mod: str | None) -> str | None:
        """Anchor a `from ...x import y` against self.module. level=1 is
        the containing package; each extra level climbs one more."""
        parts = self.module.split(".")
        # self.module names the file itself unless it is an __init__
        # (module_name already stripped that), so the containing
        # package is everything but the last component
        base = parts[:-1] if parts else []
        climb = level - 1
        if climb > len(base):
            return None
        anchor = base[: len(base) - climb]
        if mod:
            anchor = anchor + mod.split(".")
        return ".".join(anchor) if anchor else None

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    self.import_aliases[local] = target
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    mod = self._resolve_relative(node.level, node.module)
                else:
                    mod = node.module
                if mod is None:
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.from_imports[local] = (mod, alias.name)
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.toplevel_defs.add(node.name)

    def resolve_name(self, name: str) -> str | None:
        """Dotted target a bare name binds to in this module, when the
        import maps pin it down: a from-import resolves to module.orig,
        an `import x as y` alias to x, a top-level def to
        self.module.name. Unknown names resolve to None."""
        if name in self.from_imports:
            mod, orig = self.from_imports[name]
            return f"{mod}.{orig}"
        if name in self.import_aliases:
            return self.import_aliases[name]
        if name in self.toplevel_defs:
            return f"{self.module}.{name}"
        return None

    def resolve_expr(self, expr: ast.AST) -> str | None:
        """Dotted name for a Name/Attribute chain (`observe.emit`,
        `pkg.utils.observe.emit`), resolving the root through the
        import maps. None for anything else (calls, subscripts)."""
        if isinstance(expr, ast.Name):
            return self.resolve_name(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.resolve_expr(expr.value)
            if base is not None:
                return f"{base}.{expr.attr}"
        return None

    # -- suppressions ----------------------------------------------------

    def _scan_suppressions(self, known: set[str]) -> None:
        """tokenize pass: `# graftlint: disable=a,b` binds to its own
        line; on a standalone comment line it binds to the next code
        line instead. `disable-file=` covers the whole file. Unknown
        rule names raise — a typo must not silently disable nothing.

        `# graftlint: owned-thread -- why` on a Thread(...) call
        declares a single-owner thread: its target owns its state for
        the thread's whole life (a resident engine loop, a per-job
        reader), so the instance-blind worker-reachability closure must
        not treat it as one of N racing pool workers."""
        code_lines: set[int] = set()
        comments: list[tuple[int, bool, str]] = []  # line, standalone, text
        tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
        try:
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    standalone = tok.line[: tok.start[1]].strip() == ""
                    comments.append((tok.start[0], standalone, tok.string))
                elif tok.type not in (
                    tokenize.NL,
                    tokenize.NEWLINE,
                    tokenize.INDENT,
                    tokenize.DEDENT,
                    tokenize.ENDMARKER,
                ):
                    for ln in range(tok.start[0], tok.end[0] + 1):
                        code_lines.add(ln)
        except tokenize.TokenError as exc:
            raise LintError(f"{self.display}: tokenize failed: {exc}") from exc

        for line, standalone, text in comments:
            body = text.lstrip("#").strip()
            if not body.startswith(SUPPRESS_TAG):
                continue
            directive = body[len(SUPPRESS_TAG):].strip()
            # allow a trailing justification after ` -- `
            directive = directive.split("--", 1)[0].strip()
            if directive.startswith("disable-file="):
                names = directive[len("disable-file="):]
                target: set[str] | None = self.file_suppress
            elif directive.startswith("disable="):
                names = directive[len("disable="):]
                target = None  # line-scoped, resolved below
            elif directive == "owned-thread":
                bind = line
                if standalone:  # applies to the next code line
                    later = [ln for ln in code_lines if ln > line]
                    bind = min(later) if later else line
                self.owned_thread_lines.add(bind)
                continue
            else:
                raise LintError(
                    f"{self.display}:{line}: bad graftlint directive "
                    f"{body!r} (want disable=<rule[,rule]>, "
                    f"disable-file=<rule[,rule]>, or owned-thread)"
                )
            rules = {n.strip() for n in names.split(",") if n.strip()}
            unknown = rules - known
            if not rules or unknown:
                raise LintError(
                    f"{self.display}:{line}: unknown graftlint rule(s) "
                    f"{sorted(unknown) if unknown else '<empty>'} in "
                    f"suppression (known: {', '.join(sorted(known))})"
                )
            rules = {self._aliases.get(n, n) for n in rules}
            if target is not None:
                target.update(rules)
                continue
            bind = line
            if standalone:  # applies to the next code line
                later = [ln for ln in code_lines if ln > line]
                bind = min(later) if later else line
            self.line_suppress.setdefault(bind, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppress:
            return True
        return rule in self.line_suppress.get(line, set())

    # -- AST helpers -----------------------------------------------------

    def enclosing_functions(self, node: ast.AST) -> list[ast.AST]:
        """Innermost-first chain of def/asyncdef nodes containing node."""
        out = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parents.get(cur)
        return out

    def in_accounted_span(self, node: ast.AST) -> bool:
        """True when node sits lexically inside `with <x>.timed("<name>")`
        for an ACCOUNTED_SPANS name — the ledger owns that wait."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    name = timed_span_name(item.context_expr)
                    if name is not None and name in ACCOUNTED_SPANS:
                        return True
            cur = self.parents.get(cur)
        return False

    def in_lock_block(self, node: ast.AST) -> bool:
        """True when node sits inside a `with <lock>:` block — any
        context expression whose source mentions a lock/mutex name."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    src = ast.unparse(item.context_expr).lower()
                    if "lock" in src or "mutex" in src:
                        return True
            cur = self.parents.get(cur)
        return False


def timed_span_name(expr: ast.AST) -> str | None:
    """`<anything>.timed("name")` -> "name" (literal args only)."""
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "timed"
        and expr.args
        and isinstance(expr.args[0], ast.Constant)
        and isinstance(expr.args[0].value, str)
    ):
        return expr.args[0].value
    return None


def call_basename(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def is_jit_expr(expr: ast.AST) -> bool:
    """Matches jax.jit / jit / partial(jax.jit, ...) /
    functools.partial(jit, ...) expressions."""
    if isinstance(expr, ast.Attribute) and expr.attr == "jit":
        return True
    if isinstance(expr, ast.Name) and expr.id == "jit":
        return True
    if isinstance(expr, ast.Call):
        base = call_basename(expr)
        if base == "partial" and expr.args:
            return is_jit_expr(expr.args[0])
        if base == "jit":
            return True
    return False


def jit_static_names(deco: ast.AST, func: ast.AST) -> set[str]:
    """Parameter names declared static on a jit decorator
    (static_argnames literal, or static_argnums resolved positionally)."""
    out: set[str] = set()
    if not isinstance(deco, ast.Call):
        return out
    params = [a.arg for a in func.args.posonlyargs + func.args.args]
    for kw in deco.keywords:
        v = kw.value
        if kw.arg == "static_argnames":
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                out.add(v.value)
            elif isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                out.update(
                    e.value
                    for e in v.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                )
        elif kw.arg == "static_argnums":
            nums = []
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                nums = [v.value]
            elif isinstance(v, (ast.Tuple, ast.List)):
                nums = [
                    e.value
                    for e in v.elts
                    if isinstance(e, ast.Constant) and isinstance(e.value, int)
                ]
            for n in nums:
                if 0 <= n < len(params):
                    out.add(params[n])
    return out


@dataclass
class FuncInfo:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    sf: SourceFile
    qualname: str
    calls: set[str] = field(default_factory=set)  # called/ referenced basenames
    is_jit: bool = False
    static_names: set[str] = field(default_factory=set)

    @property
    def basename(self) -> str:
        return self.node.name


class PackageIndex:
    """Cross-file context rebuilt from the linted file set: function
    table, basename call graph, and the three reachability sets the
    rules consult (hot path, jit, worker). jit reachability is kept for
    unordered-shape-iter, so the rule reads JAX sources as the JAX
    package's linter does; the port itself has no jit roots."""

    def __init__(self, files: list[SourceFile]):
        self.files = files
        self.functions: dict[str, list[FuncInfo]] = {}
        self._info_by_node: dict[ast.AST, FuncInfo] = {}
        #: dotted module name -> SourceFile (last one wins on collision)
        self.modules: dict[str, SourceFile] = {sf.module: sf for sf in files}
        #: fully-qualified dotted name -> FuncInfo for *top-level* defs
        #: (the targets import aliases can actually name)
        self.functions_qual: dict[str, FuncInfo] = {}
        for sf in files:
            self._index_file(sf)
        self.hot_reachable = self._reach(self._hot_roots())
        self.jit_reachable = self._reach(
            {fi.qualname for fis in self.functions.values() for fi in fis
             if fi.is_jit}
        )
        self.worker_roots = self._worker_roots()
        self.worker_reachable = self._reach(self.worker_roots)

    def _index_file(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qual = f"{sf.display}::{node.name}@{node.lineno}"
            fi = FuncInfo(node=node, sf=sf, qualname=qual)
            for deco in node.decorator_list:
                if is_jit_expr(deco):
                    fi.is_jit = True
                    fi.static_names |= jit_static_names(deco, node)
            # body-own statements only: nested defs index separately, and
            # their calls must not leak into the parent's edge set
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    # still record the nested def as a referenced name so
                    # reachability descends into it
                    fi.calls.add(sub.name)
            for sub in self._own_nodes(node):
                if isinstance(sub, ast.Call):
                    base = call_basename(sub)
                    if base:
                        fi.calls.add(base)
                elif isinstance(sub, ast.Name) and isinstance(
                    sub.ctx, ast.Load
                ):
                    fi.calls.add(sub.id)  # functions passed as values
            self.functions.setdefault(node.name, []).append(fi)
            self._info_by_node[node] = fi
            if node in sf.tree.body or (
                isinstance(sf.parents.get(node), ast.ClassDef)
                and sf.parents[sf.parents[node]] is sf.tree
            ):
                dotted = (
                    f"{sf.module}.{sf.parents[node].name}.{node.name}"
                    if isinstance(sf.parents.get(node), ast.ClassDef)
                    else f"{sf.module}.{node.name}"
                )
                self.functions_qual.setdefault(dotted, fi)

    @staticmethod
    def _own_nodes(func: ast.AST) -> Iterator[ast.AST]:
        """Walk a function body without descending into nested defs."""
        stack = list(ast.iter_child_nodes(func))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))

    def info(self, node: ast.AST) -> FuncInfo | None:
        return self._info_by_node.get(node)

    def resolve_call(self, sf: SourceFile, call: ast.Call) -> str | None:
        """Fully-qualified dotted name of a call target, when the
        module's import aliases pin it down: `observe.emit(...)` under
        `from ..utils import observe` resolves to
        `<pkg>.utils.observe.emit`; a bare `emit(...)` under
        `from .observe import emit` resolves the same way; a local
        top-level def resolves to `<module>.<name>`. Returns None when
        the target is dynamic (methods on instances, subscripts,
        shadowed names) — callers fall back to basename heuristics."""
        return sf.resolve_expr(call.func)

    def resolves_to(self, sf: SourceFile, call: ast.Call,
                    *dotted: str) -> bool:
        """True when resolve_call lands exactly on one of `dotted`."""
        target = self.resolve_call(sf, call)
        return target is not None and target in dotted

    @property
    def hot_root_names(self) -> set[str]:
        return {name for name in self.functions
                if name in HOT_PATH_ROOTS or name.startswith(HOT_PATH_PREFIX)}

    def _hot_roots(self) -> set[str]:
        return {fi.qualname for name in self.hot_root_names
                for fi in self.functions[name]}

    def _worker_roots(self) -> set[str]:
        """Functions handed to Thread(target=...) / pool.submit(f, ...)
        / pool.map(f, ...) anywhere in the linted set."""
        roots: set[str] = set()

        def resolve(expr: ast.AST) -> None:
            name = None
            if isinstance(expr, ast.Name):
                name = expr.id
            elif isinstance(expr, ast.Attribute):
                name = expr.attr
            if name:
                roots.update(fi.qualname for fi in self.functions.get(name, ()))

        for sf in self.files:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                base = call_basename(node)
                if base == "Thread":
                    span = range(
                        node.lineno, (node.end_lineno or node.lineno) + 1
                    )
                    if any(ln in sf.owned_thread_lines for ln in span):
                        continue  # declared single-owner, not a worker
                    for kw in node.keywords:
                        if kw.arg == "target":
                            resolve(kw.value)
                elif base in ("submit", "map", "apply_async") and isinstance(
                    node.func, ast.Attribute
                ):
                    if node.args:
                        resolve(node.args[0])
        return roots

    def _reach(self, roots: set[str]) -> set[str]:
        """BFS over basename edges from qualname roots -> qualname set."""
        by_qual = {
            fi.qualname: fi
            for fis in self.functions.values()
            for fi in fis
        }
        seen = set(roots)
        frontier = [by_qual[q] for q in roots if q in by_qual]
        while frontier:
            fi = frontier.pop()
            for callee in fi.calls:
                for nxt in self.functions.get(callee, ()):
                    if nxt.qualname not in seen:
                        seen.add(nxt.qualname)
                        frontier.append(nxt)
        return seen

    # -- membership helpers used by rules --------------------------------

    def _member(self, sf: SourceFile, node: ast.AST, pool: set[str]) -> bool:
        for func in sf.enclosing_functions(node):
            fi = self._info_by_node.get(func)
            if fi is not None and fi.qualname in pool:
                return True
        return False

    def in_hot_path(self, sf: SourceFile, node: ast.AST) -> bool:
        return self._member(sf, node, self.hot_reachable)

    def in_worker(self, sf: SourceFile, node: ast.AST) -> bool:
        return self._member(sf, node, self.worker_reachable)


# --------------------------------------------------------------------------
# registry + runner


def all_rules() -> dict[str, Rule]:
    from bsseqconsensusreads_tpu_torch.analysis import (
        rules_contract,
        rules_deflate,
        rules_elastic,
        rules_emit,
        rules_fence,
        rules_hostphase,
        rules_input,
        rules_io,
        rules_methyl,
        rules_pack,
        rules_retry,
        rules_serve,
        rules_thread,
        rules_torch,
        rules_trace,
        rules_transport,
    )

    rules: dict[str, Rule] = {}
    for mod in (rules_torch, rules_thread, rules_io, rules_retry,
                rules_hostphase, rules_input, rules_emit, rules_serve,
                rules_pack, rules_methyl, rules_transport, rules_deflate,
                rules_elastic, rules_fence, rules_trace, rules_contract):
        for rule in mod.RULES:
            rules[rule.name] = rule
    return rules


def _collect_py(paths: Iterable[str]) -> list[tuple[str, str]]:
    """[(abs path, display path)] for every .py under the given paths."""
    out: list[tuple[str, str]] = []
    cwd = os.getcwd()
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap):
            out.append((ap, os.path.relpath(ap, cwd)))
        elif os.path.isdir(ap):
            for root, dirs, names in os.walk(ap):
                dirs[:] = sorted(
                    d for d in dirs if d != "__pycache__" and not d.startswith(".")
                )
                for name in sorted(names):
                    if name.endswith(".py"):
                        fp = os.path.join(root, name)
                        out.append((fp, os.path.relpath(fp, cwd)))
        else:
            raise LintError(f"no such file or directory: {p}")
    return out


def run_lint(
    paths: Iterable[str],
    rules: Iterable[str] | None = None,
    include_suppressed: bool = False,
) -> list[Finding]:
    """Lint every .py under `paths` with the named rules (default all).

    Returns unsuppressed findings sorted by (path, line, rule); raises
    LintError for unknown rule names — whether given here or referenced
    by a `# graftlint: disable=` comment in the sources."""
    from bsseqconsensusreads_tpu_torch.analysis.rules_torch import (
        JAX_COUNTERPART,
    )

    registry = all_rules()
    if rules is None:
        selected = list(registry.values())
    else:
        unknown = sorted(set(rules) - set(registry))
        if unknown:
            raise LintError(
                f"unknown rule(s) {unknown} (known: "
                f"{', '.join(sorted(registry))})"
            )
        selected = [registry[name] for name in rules]

    files = []
    for ap, display in _collect_py(paths):
        with open(ap, encoding="utf-8") as fh:
            source = fh.read()
        files.append(SourceFile(ap, display, source, registry,
                                JAX_COUNTERPART))
    index = PackageIndex(files)

    findings: list[Finding] = []
    for sf in files:
        for rule in selected:
            for f in rule.check(sf, index):
                if include_suppressed or not sf.suppressed(f.rule, f.line):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
