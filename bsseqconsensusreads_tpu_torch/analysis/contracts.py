"""graftcontract: declared-surface registry + whole-program drift check.

The port's copy of the JAX package's analysis/contracts.py, rooted at
bsseqconsensusreads_tpu_torch and declaring the port's own surface. Where
the port's registry differs from the JAX package's, the difference is
named in JAX_ONLY / PORT_ONLY with its reason; `diff_against` holds the
two registries to exactly that table (the JAX registry is handed in by
the caller, since the port never imports the JAX package).

Everything that makes fleet/elastic numbers admissible hangs on
stringly-typed names crossing process and module boundaries: the
`BSSEQ_TPU_*` env knobs, failpoint sites, ledger event names and their
required payload fields, the StageStats counters the run summaries
surface, the wire-protocol ops each serve plane dispatches, the CLI
surface, and the graftlint rule names themselves. graftlint's per-file
rules verify shapes; nothing verified that these *contracts* agree
between emitter, consumer, refusal matrix, and README — a renamed
event or an undocumented knob silently rotted a reconciliation gate.

This module is that verifier. It holds the one registry of every
declared surface, extracts every *use* of each surface from the
package AST (via the qualified-name layer in engine.py, so
`observe.emit(...)` attributes to utils.observe.emit and not to a
same-named helper), and reports drift in either direction:

* ``undeclared``   — used but not in the registry
* ``unused``       — declared but no use anywhere in the package
* ``unconsumed``   — emitted but no consumer knows the name
  (for ledger events the universal consumer is
  ledger_tools.EVENT_SCHEMA, so this is "missing from the schema")
* ``unemitted``    — a consumer matches on a name nothing emits
* ``undocumented`` — declared but absent from the README tables
* ``mismatch``     — registry and an in-code literal mirror disagree
  (failpoints.SITES, ledger_tools.EVENT_SCHEMA field tuples)
* ``unwired``      — a graftlint rule without a seeded fixture or not
  imported by engine.all_rules

A drift is silenced only by a :class:`Waiver` naming its exact
(kind, surface) pair with a justification; a waiver that matches no
drift is itself a hard error (exit 2), mirroring the suppression
discipline of the per-file rules — stale waivers must not outlive the
drift they excused.

Extraction skips the ``analysis`` subpackage itself: the registry
literals and rule pattern strings in here are declarations, not uses.

Run it as ``cli lint --contracts`` (human or ``--json``; exit 0 clean,
1 drift, 2 registry/waiver/usage error), or ``python -m
bsseqconsensusreads_tpu_torch.analysis.contracts --dump`` to print the
extracted surfaces when declaring a new one.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from bsseqconsensusreads_tpu_torch.analysis.engine import (
    LintError,
    PackageIndex,
    SourceFile,
    _collect_py,
    all_rules,
    call_basename,
)

PKG = "bsseqconsensusreads_tpu_torch"

#: dotted suffixes that pin a call to the real definition no matter
#: what path prefix the lint invocation's cwd put on the module names
OBSERVE_EMIT = f"{PKG}.utils.observe.emit"
OBSERVE_EVENT = f"{PKG}.utils.observe.event"
FAILPOINT_FIRE = f"{PKG}.faults.failpoints.fire"
FAILPOINT_EVAL = f"{PKG}.faults.failpoints.evaluate"
NETCHAOS_PLAN = f"{PKG}.faults.netchaos.plan"

ENV_RE = re.compile(r"^BSSEQ_TPU_[A-Z0-9_]+$")
#: one `site=action[...]` term of a failpoint schedule, with an
#: optional `worker:` routing prefix (faults.failpoints grammar);
#: the second alternation group is the net-fault vocabulary, legal at
#: net_* sites only (parse_schedule enforces the site gating — here we
#: only need to RECOGNIZE the literal as a schedule)
SCHEDULE_TERM_RE = re.compile(
    r"^(?:[A-Za-z0-9_.-]+:)?([a-z_]+)="
    r"(?:raise|io_error|stall|exit"
    r"|delay|drop|dup|corrupt|half_open|partition)\b"
)

#: basenames whose literal first argument is a ledger event name: the
#: sanctioned sink plus the budget-gated / callback wrappers that
#: forward to it (faults.guard._emit / .stream_event, io.bgzf._event), and the
#: port's never-silent `observe.event` (the ledger line plus a stderr line)
EMIT_WRAPPERS = frozenset({"emit", "_emit", "stream_event", "_event",
                           "event"})

#: modules whose string comparisons against an `event`/`ev` variable
#: are consumer-side event matches (kept narrow: elsewhere those names
#: are ordinary locals)
EVENT_CONSUMER_MODULES = (
    f"{PKG}.utils.ledger_tools",
    f"{PKG}.utils.trace_tools",
    f"{PKG}.utils.observe",
)

#: wire-protocol dispatch planes, keyed by serving module
PLANES = {
    f"{PKG}.serve.server": "serve",
    f"{PKG}.serve.router": "router",
    f"{PKG}.elastic.coordinator": "coordinator",
}


def _mod_is(module: str, dotted: str) -> bool:
    """Suffix-tolerant module match: a lint run from an unrelated cwd
    prefixes display-derived module names with path segments."""
    return module == dotted or module.endswith("." + dotted)


def _target_is(target: str | None, dotted: str) -> bool:
    return target is not None and (
        target == dotted or target.endswith("." + dotted)
    )


# ---------------------------------------------------------------------------
# registry model


@dataclass(frozen=True)
class EnvVar:
    name: str
    kind: str      # flag | int | float | str | path | choice
    default: str   # human-readable default ("unset", "auto", a value)
    owner: str     # package-relative owning module
    doc: str       # one line for the README table


@dataclass(frozen=True)
class LedgerEvent:
    name: str
    fields: tuple[str, ...]  # required payload keys (EVENT_SCHEMA mirror)
    owner: str               # package-relative emitting module


@dataclass(frozen=True)
class ProtocolOp:
    name: str
    planes: tuple[str, ...]  # dispatch planes serving it
    doc: str


@dataclass(frozen=True)
class Waiver:
    kind: str     # drift class this excuses
    surface: str  # e.g. "op:fleet", "env:BSSEQ_TPU_X"
    why: str      # justification; empty is a registry error


@dataclass(frozen=True)
class Drift:
    kind: str
    surface: str
    detail: str
    path: str = ""
    line: int = 0

    def format(self) -> str:
        loc = f"{self.path}:{self.line}: " if self.path else ""
        return f"{loc}{self.kind}: {self.surface}: {self.detail}"

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "surface": self.surface,
            "detail": self.detail,
            "path": self.path,
            "line": self.line,
        }


# ---------------------------------------------------------------------------
# use extraction

Site = tuple[str, int]  # (display path, line)


def _record(table: dict[str, list[Site]], name: str, sf: SourceFile,
            node: ast.AST) -> None:
    table.setdefault(name, []).append(
        (sf.display, getattr(node, "lineno", 0))
    )


class Extraction:
    """Every use of every declared-surface kind, pulled from the ASTs
    of a linted file set. Each table maps name -> [(path, line)]."""

    def __init__(self) -> None:
        self.env_uses: dict[str, list[Site]] = {}
        self.event_emits: dict[str, list[Site]] = {}
        self.event_consumes: dict[str, list[Site]] = {}
        self.dynamic_emits: list[Site] = []
        self.counter_writes: dict[str, list[Site]] = {}
        self.counter_reads: dict[str, list[Site]] = {}
        self.fire_sites: dict[str, list[Site]] = {}
        self.schedule_sites: dict[str, list[Site]] = {}
        self.refusal_uses: dict[str, list[Site]] = {}
        #: (plane, op) -> sites for server-side dispatch matches
        self.ops_dispatched: dict[tuple[str, str], list[Site]] = {}
        self.ops_sent: dict[str, list[Site]] = {}
        self.cli_commands: dict[str, list[Site]] = {}
        self.cli_subops: dict[str, list[Site]] = {}
        self.cli_flags: dict[str, list[Site]] = {}
        self.rule_defs: dict[str, list[Site]] = {}
        #: rules_* module basename -> file display path
        self.rule_modules: dict[str, str] = {}
        #: EVENT_SCHEMA literal as found in utils.ledger_tools
        self.event_schema: dict[str, tuple[str, ...]] = {}
        #: SITES literal as found in faults.failpoints
        self.sites_literal: set[str] = set()
        #: engine.py source (for the all_rules wiring check)
        self.engine_source: str = ""

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def _docstrings(tree: ast.Module) -> set[ast.AST]:
        out: set[ast.AST] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                body = node.body
                if (body and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    out.add(body[0].value)
        return out

    @staticmethod
    def _module_constants(tree: ast.Module) -> dict[str, str]:
        """NAME = "literal" assignments at module level."""
        out: dict[str, str] = {}
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                out[node.targets[0].id] = node.value.value
        return out

    @staticmethod
    def _str_elements(node: ast.AST) -> list[str]:
        """All string constants inside a set/tuple/list/frozenset(...)
        or dict-of-collections literal."""
        return [
            sub.value
            for sub in ast.walk(node)
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str)
        ]

    @staticmethod
    def _lit_str_arg(call: ast.Call) -> str | None:
        if (call.args and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            return call.args[0].value
        return None

    # -- per-file walk ---------------------------------------------------

    def scan(self, index: PackageIndex) -> "Extraction":
        for sf in index.files:
            parts = sf.module.split(".")
            if "analysis" in parts:
                self._scan_analysis(sf)
                continue
            self._scan_file(sf, index)
        return self

    def _scan_analysis(self, sf: SourceFile) -> None:
        """The analysis subpackage holds declarations, not uses — but
        it is where rule definitions and the engine wiring live."""
        base = sf.module.split(".")[-1]
        if base == "engine":
            self.engine_source = sf.source
        if not base.startswith("rules_"):
            return
        self.rule_modules[base] = sf.display
        constants = self._module_constants(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_basename(node) != "Rule":
                continue
            name = self._lit_str_arg(node)
            if name is None:
                for kw in node.keywords:
                    if kw.arg != "name":
                        continue
                    if (isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)):
                        name = kw.value.value
                    elif isinstance(kw.value, ast.Name):
                        name = constants.get(kw.value.id)
            if name is not None:
                _record(self.rule_defs, name, sf, node)

    def _scan_file(self, sf: SourceFile, index: PackageIndex) -> None:
        docstrings = self._docstrings(sf.tree)
        constants = self._module_constants(sf.tree)
        in_cli = _mod_is(sf.module, f"{PKG}.cli")
        plane = next(
            (p for mod, p in PLANES.items() if _mod_is(sf.module, mod)),
            None,
        )
        consumer_mod = any(
            _mod_is(sf.module, m) for m in EVENT_CONSUMER_MODULES
        )
        if consumer_mod:
            self._scan_consumer_sets(sf)
        if _mod_is(sf.module, f"{PKG}.utils.ledger_tools"):
            self._scan_event_schema(sf)
        if _mod_is(sf.module, f"{PKG}.faults.failpoints"):
            self._scan_sites_literal(sf)

        #: name -> True for locals assigned from <x>.get("op") /
        #: <x>.get("event") in the function currently being walked;
        #: rebuilt per function body (ast.walk order makes the Assign
        #: visit precede the Compare visits inside the same function)
        opvars: set[str] = set()
        evvars: set[str] = set()

        for node in ast.walk(sf.tree):
            # -- env vars: any full-name literal or keyword-arg name --
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node not in docstrings):
                if ENV_RE.match(node.value):
                    _record(self.env_uses, node.value, sf, node)
                self._scan_schedule(node, sf)
            elif isinstance(node, ast.keyword):
                if node.arg and ENV_RE.match(node.arg):
                    _record(self.env_uses, node.arg, sf, node.value)

            if isinstance(node, ast.Assign):
                self._scan_counter_dict(node, sf)
                tracked = self._get_key_assign(node)
                if tracked == "op" and isinstance(
                    node.targets[0], ast.Name
                ):
                    opvars.add(node.targets[0].id)
                elif tracked == "event" and isinstance(
                    node.targets[0], ast.Name
                ):
                    evvars.add(node.targets[0].id)

            if isinstance(node, ast.AugAssign):
                self._scan_counter_sub(node.target, sf, write=True)
            if isinstance(node, ast.Subscript):
                self._scan_counter_sub(node, sf,
                                       write=isinstance(node.ctx, ast.Store))

            if isinstance(node, ast.Compare):
                self._scan_compare(node, sf, plane, opvars,
                                   evvars, consumer_mod)

            if isinstance(node, ast.Dict):
                self._scan_op_dict(node, sf)

            if not isinstance(node, ast.Call):
                continue
            base = call_basename(node)
            lit = self._lit_str_arg(node)

            if base in EMIT_WRAPPERS:
                if base in ("emit", "event"):
                    target = index.resolve_call(sf, node)
                    sink = OBSERVE_EMIT if base == "emit" else OBSERVE_EVENT
                    is_emit = _target_is(target, sink) or (
                        target is None
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "observe"
                    )
                else:
                    is_emit = isinstance(node.func, ast.Attribute)
                if is_emit:
                    if lit is not None:
                        _record(self.event_emits, lit, sf, node)
                        if base in ("stream_event", "_event"):
                            # stream-resilience kinds are counted under
                            # the same name (guard.stream_event, which
                            # bgzf's _event callback forwards into)
                            _record(self.counter_writes, lit, sf, node)
                    else:
                        self.dynamic_emits.append((sf.display, node.lineno))

            if base == "count" and lit is not None and isinstance(
                node.func, ast.Attribute
            ):
                _record(self.counter_writes, lit, sf, node)

            if base == "get" and lit is not None and isinstance(
                node.func, ast.Attribute
            ):
                recv = ast.unparse(node.func.value)
                if recv == "counters" or recv.endswith(".counters"):
                    _record(self.counter_reads, lit, sf, node)

            if base in ("fire", "evaluate", "plan"):
                # evaluate() is the non-raising fire (netchaos folds its
                # results into a WirePlan); plan() is netchaos's own
                # front door — all three are failpoint-site USES
                target = index.resolve_call(sf, node)
                if (target is None
                        or _target_is(target, FAILPOINT_FIRE)
                        or _target_is(target, FAILPOINT_EVAL)
                        or _target_is(target, NETCHAOS_PLAN)):
                    site = lit
                    if site is None and node.args and isinstance(
                        node.args[0], ast.Name
                    ):
                        site = constants.get(node.args[0].id)
                    if site is not None:
                        _record(self.fire_sites, site, sf, node)

            if base == "TransportError":
                for kw in node.keywords:
                    if (kw.arg == "reason"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)):
                        _record(self.refusal_uses, kw.value.value, sf, node)

            if in_cli:
                self._scan_cli_call(node, sf, base, lit)

        # the TransportError def's `reason` default is itself a use
        if _mod_is(sf.module, f"{PKG}.serve.transport"):
            self._scan_refusal_default(sf)

    # -- focused sub-scans ----------------------------------------------

    def _scan_schedule(self, node: ast.Constant, sf: SourceFile) -> None:
        """A literal is a failpoint schedule iff every ;-term parses as
        one (cli help text carries real example schedules — those are
        uses too, and a stale example is exactly the drift we want)."""
        text = node.value
        if "=" not in text or " " in text.strip():
            return
        terms = [t for t in text.split(";") if t]
        if not terms:
            return
        sites = []
        for term in terms:
            m = SCHEDULE_TERM_RE.match(term)
            if m is None:
                return
            sites.append(m.group(1))
        for site in sites:
            _record(self.schedule_sites, site, sf, node)

    @staticmethod
    def _get_key_assign(node: ast.Assign) -> str | None:
        """`x = <expr>.get("op"|"event")` -> the key, else None."""
        v = node.value
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr == "get" and v.args
                and isinstance(v.args[0], ast.Constant)
                and v.args[0].value in ("op", "event")
                and len(node.targets) == 1):
            return v.args[0].value
        return None

    def _scan_compare(self, node: ast.Compare, sf: SourceFile,
                      plane: str | None, opvars: set[str],
                      evvars: set[str], consumer_mod: bool) -> None:
        left = node.left
        key: str | None = None
        if isinstance(left, ast.Name):
            if left.id in opvars or left.id == "op":
                key = "op"
            elif left.id in evvars or (
                consumer_mod and left.id in ("event", "ev")
            ):
                key = "event"
        elif (isinstance(left, ast.Call)
              and isinstance(left.func, ast.Attribute)
              and left.func.attr == "get" and left.args
              and isinstance(left.args[0], ast.Constant)
              and left.args[0].value in ("op", "event")):
            key = left.args[0].value
        if key is None:
            return
        names: list[str] = []
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, (ast.Eq, ast.NotEq)) and isinstance(
                comp, ast.Constant
            ) and isinstance(comp.value, str):
                names.append(comp.value)
            elif isinstance(op, (ast.In, ast.NotIn)):
                names.extend(self._str_elements(comp))
        for name in names:
            if key == "op":
                if plane is not None:
                    self.ops_dispatched.setdefault(
                        (plane, name), []
                    ).append((sf.display, node.lineno))
            else:
                _record(self.event_consumes, name, sf, node)

    def _scan_op_dict(self, node: ast.Dict, sf: SourceFile) -> None:
        for k, v in zip(node.keys, node.values):
            if (isinstance(k, ast.Constant) and k.value == "op"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)):
                _record(self.ops_sent, v.value, sf, node)

    def _scan_counter_dict(self, node: ast.Assign, sf: SourceFile) -> None:
        if not isinstance(node.value, ast.Dict):
            return
        if not any(
            ast.unparse(t).endswith("counters") for t in node.targets
        ):
            return
        for k in node.value.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                _record(self.counter_writes, k.value, sf, k)

    def _scan_counter_sub(self, node: ast.AST, sf: SourceFile,
                          write: bool) -> None:
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            return
        recv = ast.unparse(node.value)
        if not (recv == "counters" or recv.endswith(".counters")):
            return
        table = self.counter_writes if write else self.counter_reads
        _record(table, node.slice.value, sf, node)

    def _scan_cli_call(self, node: ast.Call, sf: SourceFile,
                       base: str | None, lit: str | None) -> None:
        if base == "add_parser" and lit is not None:
            top = (isinstance(node.func, ast.Attribute)
                   and isinstance(node.func.value, ast.Name)
                   and node.func.value.id == "sub")
            table = self.cli_commands if top else self.cli_subops
            _record(table, lit, sf, node)
        elif base == "add_argument":
            for a in node.args:
                if (isinstance(a, ast.Constant) and isinstance(a.value, str)
                        and a.value.startswith("--")):
                    _record(self.cli_flags, a.value, sf, node)
            if lit == "op":
                for kw in node.keywords:
                    if kw.arg == "choices":
                        for name in self._str_elements(kw.value):
                            _record(self.ops_sent, name, sf, node)

    @staticmethod
    def _toplevel_assigns(sf: SourceFile):
        """(name, value) for module-level Assign/AnnAssign statements."""
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                yield node.targets[0].id, node.value
            elif (isinstance(node, ast.AnnAssign)
                    and isinstance(node.target, ast.Name)
                    and node.value is not None):
                yield node.target.id, node.value

    def _scan_event_schema(self, sf: SourceFile) -> None:
        for name, value in self._toplevel_assigns(sf):
            if name == "EVENT_SCHEMA" and isinstance(value, ast.Dict):
                for k, v in zip(value.keys, value.values):
                    if isinstance(k, ast.Constant):
                        self.event_schema[k.value] = tuple(
                            self._str_elements(v)
                        )

    def _scan_consumer_sets(self, sf: SourceFile) -> None:
        """Module-level `<X>_EVENTS = {...}` name sets in the consumer
        modules (trace_tools' terminal/requeue tables) — every string
        in them is a consumed event name."""
        for name, value in self._toplevel_assigns(sf):
            if name.isupper() and name.endswith("_EVENTS"):
                # dict-shaped tables ({"job": {"job_complete", ...}})
                # key by *kind*, not event — only the values are names
                sources = value.values if isinstance(value, ast.Dict) \
                    else [value]
                for src in sources:
                    for ev in self._str_elements(src):
                        _record(self.event_consumes, ev, sf, value)

    def _scan_sites_literal(self, sf: SourceFile) -> None:
        for node in sf.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "SITES"):
                self.sites_literal = set(self._str_elements(node.value))

    def _scan_refusal_default(self, sf: SourceFile) -> None:
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.FunctionDef)
                    and node.name == "__init__"):
                args = node.args
                names = [a.arg for a in args.args + args.kwonlyargs]
                if "reason" not in names:
                    continue
                for a, d in list(
                    zip(reversed(args.args), reversed(args.defaults))
                ) + list(zip(args.kwonlyargs, args.kw_defaults)):
                    if (a.arg == "reason" and isinstance(d, ast.Constant)
                            and isinstance(d.value, str)):
                        _record(self.refusal_uses, d.value, sf, d)


def extract(index: PackageIndex) -> Extraction:
    return Extraction().scan(index)


# ---------------------------------------------------------------------------
# the registry


@dataclass(frozen=True)
class Registry:
    env_vars: tuple[EnvVar, ...]
    failpoint_sites: frozenset[str]
    events: tuple[LedgerEvent, ...]
    counters: frozenset[str]
    ops: tuple[ProtocolOp, ...]
    refusal_reasons: frozenset[str]
    cli_commands: frozenset[str]
    cli_subops: frozenset[str]
    cli_flags: frozenset[str]
    rules: frozenset[str]
    waivers: tuple[Waiver, ...]

    def env_names(self) -> frozenset[str]:
        return frozenset(v.name for v in self.env_vars)

    def event_names(self) -> frozenset[str]:
        return frozenset(e.name for e in self.events)

    def event_fields(self) -> dict[str, tuple[str, ...]]:
        return {e.name: e.fields for e in self.events}

    def op_planes(self) -> dict[str, tuple[str, ...]]:
        return {o.name: o.planes for o in self.ops}


# ---------------------------------------------------------------------------
# the declared surfaces
#
# Declaring a new surface: add the entry here, make the in-code mirror
# agree (faults.failpoints.SITES for sites, ledger_tools.EVENT_SCHEMA
# for events — field tuples must match verbatim), document it in the
# README where the kind is doc-checked (env vars, rules, subcommands),
# and for a new lint rule seed a fixture with a `# seeded: <rule>`
# marker. `python -m bsseqconsensusreads_tpu_torch.analysis.contracts --dump`
# prints every extracted use when hunting the other side of a drift.

ENV_VARS: tuple[EnvVar, ...] = (
    # core / pipeline
    EnvVar("BSSEQ_TPU_KERNEL_LAYOUT", "choice", "packed", "pipeline.calling",
           "molecular vote input layout (packed segment rows vs padded); "
           "the duplex stage votes packed rows only"),
    EnvVar("BSSEQ_TPU_SINGLETON", "flag", "1", "pipeline.calling",
           "include single-read families in consensus calling"),
    EnvVar("BSSEQ_TPU_OVERLAP_THREADS", "int", "auto", "pipeline.calling",
           "overlap pool size for host/device pipelining; 0 disables"),
    EnvVar("BSSEQ_TPU_STALL_TIMEOUT_S", "float", "auto", "faults.retry",
           "batch stall watchdog before redispatch"),
    EnvVar("BSSEQ_TPU_METHYL_ENGINE", "choice", "auto", "pipeline.calling",
           "methylation epilogue engine (auto, device, host) when "
           "--methyl-engine is not given"),
    EnvVar("BSSEQ_TPU_METHYL_MERGE", "choice", "engine default",
           "methyl.tally", "merge strategy for spilled methyl runs"),
    EnvVar("BSSEQ_TPU_SORT_ENGINE", "choice", "config default",
           "pipeline.extsort", "sort engine (extsort or bucket)"),
    EnvVar("BSSEQ_TPU_SORT_BUCKETS", "int", "auto", "pipeline.bucketemit",
           "bucket count for sort_engine=bucket"),
    EnvVar("BSSEQ_TPU_VERIFY_SPILLS", "flag", "1", "pipeline.extsort",
           "CRC-verify spill runs on merge read-back"),
    # io / native
    EnvVar("BSSEQ_TPU_BGZF_THREADS", "int", "auto", "io.native",
           "native BGZF codec thread count"),
    EnvVar("BSSEQ_TPU_PBGZF", "str", "unset", "io.pbgzf",
           "parallel BGZF writer config (workers[,queue])"),
    # parallel
    EnvVar("BSSEQ_TPU_HOST_WORKERS", "int", "auto", "parallel.hostpool",
           "host pool worker count for encode/rawize/emit phases"),
    EnvVar("BSSEQ_TPU_HEARTBEAT_S", "float", "30", "parallel.multihost",
           "multihost liveness heartbeat period"),
    # faults / input guard
    EnvVar("BSSEQ_TPU_FAILPOINTS", "str", "unset", "faults.failpoints",
           "failpoint schedule (site=action[:arg][@pred=value];...)"),
    EnvVar("BSSEQ_TPU_INPUT_POLICY", "choice", "strict", "faults.guard",
           "ingest guard policy (strict, lenient, or drop)"),
    EnvVar("BSSEQ_TPU_MAX_FAMILY_RECORDS", "int", "module cap",
           "faults.guard", "family-size admission cap"),
    EnvVar("BSSEQ_TPU_MAX_READ_LEN", "int", "module cap", "faults.guard",
           "per-read length admission cap"),
    EnvVar("BSSEQ_TPU_GUARD_EVENT_CAP", "int", "module cap", "faults.guard",
           "per-input budget of quarantine/repair ledger events"),
    EnvVar("BSSEQ_TPU_RETRY_MAX", "int", "3", "faults.retry",
           "total attempts per batch before degrade"),
    EnvVar("BSSEQ_TPU_RETRY_BACKOFF_S", "float", "0.05",
           "faults.retry", "first backoff between retries, doubling"),
    # observability
    EnvVar("BSSEQ_TPU_STATS", "path", "unset", "utils.observe",
           "run-ledger JSONL sink; unset disables emission"),
    EnvVar("BSSEQ_TPU_STATS_JOBS", "flag", "0", "utils.observe",
           "mirror per-job ledger lines into per-job sub-sinks"),
    EnvVar("BSSEQ_TPU_STATS_REPLICAS", "flag", "0", "utils.observe",
           "mirror per-replica ledger lines into sub-sinks"),
    EnvVar("BSSEQ_TPU_STATS_WORKERS", "flag", "0", "utils.observe",
           "mirror per-worker ledger lines into sub-sinks"),
    EnvVar("BSSEQ_TPU_TRACE", "flag", "0", "utils.observe",
           "per-stage torch.profiler Chrome trace with the program's spans beside the "
           "device's; per-batch span lines on the ledger"),
    EnvVar("BSSEQ_TPU_FLIGHT_RING", "int", "256", "utils.observe",
           "flight-recorder ring capacity (crash-path event dump)"),
    EnvVar("BSSEQ_TPU_COMPILE_CACHE_DIR", "path", "unset",
           "utils.compilecache",
           "persistent XLA compile cache directory; unset disables"),
    # serve / fleet
    EnvVar("BSSEQ_TPU_SERVE_TLS_CERT", "path", "unset", "serve.transport",
           "TLS certificate enabling the TLS transport"),
    EnvVar("BSSEQ_TPU_SERVE_TLS_KEY", "path", "unset", "serve.transport",
           "TLS private key paired with the certificate"),
    EnvVar("BSSEQ_TPU_REPLICA_ID", "str", "unset", "serve.fleet",
           "replica identity stamped on every ledger line"),
    # elastic
    EnvVar("BSSEQ_TPU_WORKER_ID", "str", "unset", "elastic.coordinator",
           "elastic worker identity stamped on every ledger line"),
    EnvVar("BSSEQ_TPU_COORDINATOR_ADDR", "str", "unset",
           "elastic.coordinator",
           "coordinator address elastic workers dial"),
    EnvVar("BSSEQ_TPU_ELASTIC_LEASE_S", "float", "module default",
           "elastic.coordinator",
           "slice lease duration before the coordinator requeues"),
    EnvVar("BSSEQ_TPU_SPAWNED_AT", "float", "unset", "elastic.coordinator",
           "spawn timestamp handed to respawned workers (internal)"),
    EnvVar("BSSEQ_TPU_ELASTIC_CHUNK_B", "int", "1048576",
           "elastic.coordinator",
           "ship-mode transfer chunk size in bytes (clamped to 4 MiB "
           "so a chunk always fits one frame)"),
    EnvVar("BSSEQ_TPU_PREEMPT_GRACE_S", "float", "30", "elastic.preempt",
           "drain-and-handoff budget after SIGTERM: finish the in-flight "
           "batch, flush, release the lease — then exit regardless"),
    EnvVar("BSSEQ_TPU_ADMIT_WATERMARK", "int", "queue capacity",
           "serve.jobs",
           "admission queue depth at which submit sheds with a typed "
           "`overloaded` refusal instead of blocking (0 disables on "
           "the router; the engine queue defaults to its capacity)"),
)

FAILPOINT_SITES: frozenset[str] = frozenset({
    "dispatch_kernel", "fetch_out", "retire_future",
    "hostpool_task",
    "extsort_spill", "extsort_merge",
    "bucket_spill", "bucket_finalize",
    "ckpt_shard_write", "ckpt_manifest_rename", "ckpt_finalize",
    "bgzf_inflate", "bgzf_write", "native_load",
    "multihost_heartbeat", "multihost_collective",
    "serve_submit", "serve_ingest", "serve_retire",
    "fleet_route", "fleet_replica_exit",
    "elastic_slice", "elastic_publish", "elastic_manifest_commit",
    "elastic_merge",
    "net_send", "net_recv", "net_accept",
})

EVENTS: tuple[LedgerEvent, ...] = (
    # run lifecycle (utils.observe / pipeline)
    LedgerEvent("run_manifest",
                ("git_rev", "version", "backend", "device_count"),
                "utils.observe"),
    LedgerEvent("stage_stats", ("stage",), "utils.observe"),
    LedgerEvent("rule_complete", ("rule", "seconds", "ran"), "cli"),
    LedgerEvent("pipeline_complete", ("pipeline_s",), "cli"),
    LedgerEvent("span", ("name", "trace", "span", "t0", "t1", "dur_s"),
                "utils.observe"),
    LedgerEvent("flight_record", ("reason", "count", "events"),
                "utils.observe"),
    # pipeline recovery (faults.retry / pipeline.calling)
    LedgerEvent("batch_retry", ("stage", "batch", "attempt"),
                "faults.retry"),
    LedgerEvent("batch_recovered", ("stage", "batch", "attempts"),
                "faults.retry"),
    LedgerEvent("batch_degraded", ("stage", "batch", "attempts", "error"),
                "faults.retry"),
    LedgerEvent("batch_stall_redispatch", ("stage", "batch", "timeout_s"),
                "pipeline.calling"),
    LedgerEvent("interstage_fallback", ("reason",), "pipeline.stages"),
    # host/overlap pools
    LedgerEvent("overlap_pool_enabled", ("workers",), "pipeline.calling"),
    LedgerEvent("overlap_pool_disabled", ("reason",), "pipeline.calling"),
    LedgerEvent("overlap_pool_composed", ("stage", "workers", "devices"),
                "pipeline.calling"),
    LedgerEvent("host_pool_enabled", ("stage", "workers"),
                "parallel.hostpool"),
    LedgerEvent("host_pool_disabled", ("stage", "reason"),
                "parallel.hostpool"),
    LedgerEvent("worker_heartbeat", ("process_index", "seq", "phase"),
                "parallel.multihost"),
    # sort / spill / checkpoint durability
    LedgerEvent("spill", ("records", "seconds"), "pipeline.extsort"),
    LedgerEvent("merge_pass", ("pass", "runs"), "pipeline.extsort"),
    LedgerEvent("bucket_plan", ("buckets", "records_per_spill"),
                "pipeline.bucketemit"),
    LedgerEvent("bucket_spill", ("bucket", "records", "run", "seconds"),
                "pipeline.bucketemit"),
    LedgerEvent("bucket_replayed", ("buckets", "target"),
                "pipeline.bucketemit"),
    LedgerEvent("bucket_manifest_resumed", ("replayed", "target"),
                "pipeline.bucketemit"),
    LedgerEvent("bucket_manifest_discarded", ("reason", "target"),
                "pipeline.bucketemit"),
    LedgerEvent("checkpoint_input_changed",
                ("target", "run_input", "manifest_input",
                 "batches_at_stake"), "pipeline.checkpoint"),
    LedgerEvent("checkpoint_discarded",
                ("target", "reason", "dropped_batches", "dropped_shards"),
                "pipeline.checkpoint"),
    LedgerEvent("shard_quarantined",
                ("target", "shard", "error", "dropped_batches",
                 "dropped_shards"), "pipeline.checkpoint"),
    # methyl tally durability
    LedgerEvent("methyl_spill", ("run", "sites", "upto"), "methyl.tally"),
    LedgerEvent("methyl_resume",
                ("watermark", "runs_kept", "runs_dropped"), "methyl.tally"),
    LedgerEvent("methyl_finalize", (), "methyl.tally"),
    # input guard / stream resilience (faults.guard, io.bam, io.bgzf)
    LedgerEvent("record_quarantined", ("input", "reason", "record_index"),
                "faults.guard"),
    LedgerEvent("record_repaired",
                ("input", "qname", "reason", "record_index"),
                "faults.guard"),
    LedgerEvent("family_quarantined", ("input", "mi", "reason", "records"),
                "faults.guard"),
    LedgerEvent("guard_events_truncated", ("input", "dropped"),
                "faults.guard"),
    LedgerEvent("stream_gap",
                ("input", "gap_start", "resumed_at", "skipped_bytes"),
                "io.bgzf"),
    LedgerEvent("stream_truncated", ("input", "error"), "io.bgzf"),
    LedgerEvent("frame_resync", ("input", "voffset", "discarded_bytes"),
                "io.bam"),
    LedgerEvent("frame_lost", ("input", "error"), "io.bam"),
    LedgerEvent("integrity_mismatch", ("what", "path"),
                "faults.integrity"),
    LedgerEvent("failpoint_fired", ("site", "action"),
                "faults.failpoints"),
    # graftserve
    LedgerEvent("job_admitted", ("input", "output", "fingerprint"),
                "serve.scheduler"),
    LedgerEvent("job_complete", ("output", "families", "consensus_out"),
                "serve.scheduler"),
    LedgerEvent("job_failed", ("error",), "serve.scheduler"),
    LedgerEvent("serve_listening", ("socket",), "serve.server"),
    LedgerEvent("serve_drained", ("socket",), "serve.server"),
    LedgerEvent("serve_warmup", ("families",), "serve.server"),
    LedgerEvent("serve_frame_refused", ("reason",), "serve.server"),
    # graftfleet
    LedgerEvent("fleet_replica_spawn", ("replica_id", "generation"),
                "serve.fleet"),
    LedgerEvent("fleet_replica_down", ("replica_id",), "serve.fleet"),
    LedgerEvent("fleet_restart_failed", ("replica_id", "error"),
                "serve.router"),
    LedgerEvent("fleet_route", ("rjob", "replica_id"), "serve.router"),
    LedgerEvent("fleet_requeue", ("rjob", "from_replica", "to_replica"),
                "serve.router"),
    LedgerEvent("fleet_counters",
                ("jobs_routed", "jobs_requeued", "affinity_hits",
                 "replica_restarts"), "serve.router"),
    # graftswarm (elastic)
    LedgerEvent("elastic_split", ("slices", "families", "records"),
                "elastic.coordinator"),
    LedgerEvent("elastic_lease", ("slice", "worker", "lease_id"),
                "elastic.coordinator"),
    LedgerEvent("elastic_join", ("worker",), "elastic.coordinator"),
    LedgerEvent("elastic_slice_processed", ("slice", "worker"),
                "elastic.worker"),
    LedgerEvent("elastic_slice_done", ("slice",), "elastic.coordinator"),
    LedgerEvent("elastic_publish_refused", ("slice", "worker", "reason"),
                "elastic.coordinator"),
    LedgerEvent("elastic_slice_reset", ("slice", "worker"),
                "elastic.coordinator"),
    LedgerEvent("slice_requeued", ("slice", "worker", "reason"),
                "elastic.coordinator"),
    LedgerEvent("worker_lost", ("worker", "reason"),
                "elastic.coordinator"),
    LedgerEvent("elastic_worker_spawn", ("worker", "generation"),
                "elastic.supervisor"),
    LedgerEvent("elastic_ledger_resumed", ("done", "pending"),
                "elastic.coordinator"),
    LedgerEvent("elastic_merged", ("records", "slices", "ok"),
                "elastic.merge"),
    LedgerEvent("elastic_run_complete",
                ("slices", "records", "requeues", "ok"),
                "elastic.coordinator"),
    # graftnet (fencing + shared-nothing shipping)
    LedgerEvent("publish_fenced", ("slice", "worker", "epoch", "current"),
                "elastic.coordinator"),
    LedgerEvent("frame_dup_ignored", ("rid", "op"), "serve.server"),
    LedgerEvent("slice_chunk_resent", ("slice", "offset", "attempt"),
                "elastic.worker"),
    # graftpreempt (voluntary drain-and-handoff + overload shedding)
    LedgerEvent("worker_preempted", ("worker", "reason"),
                "elastic.coordinator"),
    LedgerEvent("handoff_published",
                ("slice", "worker", "batches_kept", "handoff_latency_s"),
                "elastic.preempt"),
    LedgerEvent("jobs_shed", ("depth", "watermark", "retry_after_s"),
                "serve.jobs"),
    # the port's own
    LedgerEvent("kernel_launches", ("slice", "worker", "backend"),
                "elastic.worker"),
)

#: counters read across a layer boundary (StageStats surface fields,
#: serve scheduler sharing stats, router fleet counters). Counter
#: *writes* are open-ended — only cross-layer reads need declaring.
COUNTERS: frozenset[str] = frozenset({
    "batches_retried", "batches_recovered", "batches_degraded",
    "batches_stalled", "batches_shared_jobs",
    "records_seen", "records_quarantined", "records_repaired",
    "families_quarantined", "family_records_quarantined",
    "stream_gap", "stream_truncated", "frame_resync", "frame_lost",
    "jobs_routed", "jobs_requeued", "affinity_hits", "replica_restarts",
    "jobs_shed",
})

OPS: tuple[ProtocolOp, ...] = (
    ProtocolOp("ping", ("serve", "router", "coordinator"),
               "liveness probe"),
    ProtocolOp("submit", ("serve", "router"), "admit a job spec"),
    ProtocolOp("status", ("serve", "router", "coordinator"),
               "job / run status snapshot"),
    ProtocolOp("wait", ("serve", "router"), "block until a job settles"),
    ProtocolOp("stats", ("serve", "router"), "counters + queue depths"),
    ProtocolOp("fleet", ("router",),
               "router stats alias used by external tooling"),
    ProtocolOp("metrics", ("serve", "router", "coordinator"),
               "live metrics snapshot for `observe top`"),
    ProtocolOp("drain", ("serve", "router"),
               "stop admitting, finish in-flight, exit"),
    ProtocolOp("elastic_join", ("coordinator",),
               "worker announces itself"),
    ProtocolOp("lease", ("coordinator",), "worker asks for a slice lease"),
    ProtocolOp("heartbeat", ("coordinator",), "worker lease keep-alive"),
    ProtocolOp("publish", ("coordinator",),
               "worker publishes a finished slice"),
    ProtocolOp("slice_fetch", ("coordinator",),
               "ship mode: one CRC'd chunk of a slice input (stateless, "
               "resumable at any offset)"),
    ProtocolOp("slice_push", ("coordinator",),
               "ship mode: one CRC'd chunk of a slice output (fenced, "
               "sequential stream with resync replies)"),
    ProtocolOp("preempt", ("coordinator", "router"),
               "voluntary drain: a worker releases its lease early "
               "(coordinator requeues immediately), or an operator "
               "drains one router replica onto survivors"),
)

REFUSAL_REASONS: frozenset[str] = frozenset({
    "transport", "bad_address", "truncated_frame", "oversized_frame",
    "bad_json",
    "overloaded", "drain_timeout",
})

CLI_COMMANDS: frozenset[str] = frozenset({
    "run", "molecular", "duplex", "sort", "group", "metrics",
    "filter-consensus", "zipper", "sam-to-fastq", "filter-mapped",
    "serve", "route", "submit", "serve-ctl", "elastic", "lint",
    "observe",
})

CLI_SUBOPS: frozenset[str] = frozenset({
    # elastic <op>
    "run", "worker",
    # observe <op>
    "summarize", "diff", "check", "trace", "top",
})

CLI_FLAGS: frozenset[str] = frozenset({
    "--address", "--aligner", "--bam", "--batch-families", "--batching",
    "--chemistry", "--compact", "--config", "--contracts", "--count",
    "--device",
    "--edits", "--emit", "--error-rate-post-umi", "--error-rate-pre-umi",
    "--failpoints", "--force", "--fq1", "--fq2", "--grouping",
    "--idle-flush-ms", "--include-suppressed", "--indel-policy",
    "--ingest", "--inline", "--input", "--interval", "--job", "--job-a",
    "--job-b", "--join", "--json", "--list-rules", "--max-active",
    "--max-base-error-rate", "--max-no-call-fraction", "--max-pending",
    "--max-read-error-rate", "--max-restarts", "--max-window",
    "--methyl", "--methyl-engine", "--methyl-out", "--min-base-quality",
    "--min-consensus-base-quality", "--min-input-base-quality",
    "--min-map-q", "--min-mean-base-quality", "--min-reads", "--mode",
    "--no-affinity", "--no-consensus-call-overlapping-bases",
    "--no-respawn", "--order", "--outdir", "--output", "--passthrough",
    "--policy", "--pos0", "--raw-tag", "--ready-file", "--reference",
    "--replica", "--replica-address", "--replica-failpoints",
    "--replica-host", "--replicas", "--require-single-strand-agreement",
    "--rules", "--rundir", "--ship", "--single-strand", "--slices",
    "--socket",
    "--sort-buckets", "--sort-engine", "--strategy",
    "--stream-interstage", "--stride", "--timeout", "--tolerance",
    "--transport", "--unmapped", "--wait", "--warmup",
    "--worker", "--worker-failpoints", "--worker-id", "--workers",
})

RULES: frozenset[str] = frozenset({
    "serial-deflate", "unleased-work-dispatch", "per-record-alloc",
    "serialized-host-phase", "assert-on-input", "io-in-device-span",
    "stderr-print", "host-sync", "kernel-rebuild", "device-branch",
    "unordered-shape-iter", "unfused-methyl-scan", "padded-batch-flops",
    "padded-envelope-dispatch", "unbounded-retry",
    "blocking-scheduler-loop", "thread-unsafe-mutation",
    "swallowed-exception", "untraced-transport-send",
    "unframed-socket-read", "contract-drift", "unfenced-commit",
    "unbounded-drain-wait",
})

WAIVERS: tuple[Waiver, ...] = (
    Waiver("unused", "op:fleet",
           "router stats alias reached over the wire by out-of-package "
           "tooling (tools/serve_loadgen, tools/chaos_drill, fleet "
           "tests); in-package clients send `stats`"),
)


@dataclass(frozen=True)
class Difference:
    """One named difference between this registry and the JAX package's:
    a surface of `kind` (env, failpoint, event, event-fields, counter,
    op, refusal, command, subop, flag, rule) by `name`, with its reason."""

    kind: str
    name: str
    why: str


#: surfaces the JAX package declares and the port does not
JAX_ONLY: tuple[Difference, ...] = (
    Difference("env", "BSSEQ_TPU_BACKEND",
               "the JAX platform; the port's device is --device / the "
               "config's backend: (cuda or cpu)"),
    Difference("env", "BSSEQ_TPU_VOTE_KERNEL",
               "chooses XLA or Pallas; the port has one vote kernel per "
               "device (csrc/vote.cu on the card, its plain twin on the CPU)"),
    Difference("env", "BSSEQ_TPU_BAMIO_SO",
               "a path to the JAX natives' BAM library; the port builds "
               "its own from csrc/host at first use"),
    Difference("env", "BSSEQ_TPU_WIREPACK_SO",
               "a path to the JAX natives' wire library; the port builds "
               "its own from csrc/host at first use"),
    Difference("env", "BSSEQ_TPU_NATIVE_WIRE",
               "turns the JAX wire library off as if unbuilt; the port's "
               "library is a build requirement (no unbuilt fallback) and "
               "its numpy twins are chosen per engine (--emit python, "
               "sort_engine python, BSSEQ_TPU_METHYL_MERGE=python)"),
    Difference("env", "BSSEQ_TPU_NATIVE_GROUPING",
               "selects native decode with Python grouping; the port's "
               "native ingest decodes and groups in one C pass, and "
               "--ingest python is its Python engine"),
    Difference("flag", "--vote-kernel",
               "the XLA / Pallas choice (as BSSEQ_TPU_VOTE_KERNEL)"),
    Difference("rule", "jit-recompile",
               "a jax.jit hazard; the port's counterpart is kernel-rebuild"),
    Difference("rule", "tracer-leak",
               "a jit tracer hazard; the port's counterpart is device-branch"),
)

#: surfaces the port declares and the JAX package does not
PORT_ONLY: tuple[Difference, ...] = (
    Difference("flag", "--device",
               "the port's device choice (cuda or cpu) on the stage "
               "subcommands"),
    Difference("flag", "--methyl-engine",
               "the methyl epilogue's engine on `duplex` (the JAX package "
               "reads only BSSEQ_TPU_METHYL_ENGINE)"),
    Difference("event", "kernel_launches",
               "an elastic slice's vote kernel launches on the card"),
    Difference("rule", "kernel-rebuild",
               "the counterpart of jit-recompile: nvcc builds and library "
               "loads on the batch loop"),
    Difference("rule", "device-branch",
               "the counterpart of tracer-leak: Python branches on device "
               "tensors (hidden syncs)"),
)


REGISTRY = Registry(
    env_vars=ENV_VARS,
    failpoint_sites=FAILPOINT_SITES,
    events=EVENTS,
    counters=COUNTERS,
    ops=OPS,
    refusal_reasons=REFUSAL_REASONS,
    cli_commands=CLI_COMMANDS,
    cli_subops=CLI_SUBOPS,
    cli_flags=CLI_FLAGS,
    rules=RULES,
    waivers=WAIVERS,
)


def surfaces(registry) -> dict[str, dict[str, tuple]]:
    """kind -> {name: value} for a registry of this shape (the port's or,
    handed in, the JAX package's): the value is what must also agree
    (an event's field tuple), () where the name is all there is."""
    return {
        "env": {v.name: () for v in registry.env_vars},
        "failpoint": {n: () for n in registry.failpoint_sites},
        "event": {e.name: () for e in registry.events},
        "event-fields": {e.name: tuple(e.fields) for e in registry.events},
        "counter": {n: () for n in registry.counters},
        "op": {o.name: tuple(sorted(o.planes)) for o in registry.ops},
        "refusal": {n: () for n in registry.refusal_reasons},
        "command": {n: () for n in registry.cli_commands},
        "subop": {n: () for n in registry.cli_subops},
        "flag": {n: () for n in registry.cli_flags},
        "rule": {n: () for n in registry.rules},
    }


def diff_against(jax_registry, registry: Registry = None) -> list[str]:
    """Every difference between `registry` (default: the port's) and the
    JAX package's registry that JAX_ONLY / PORT_ONLY do not name, and
    every table entry that names no real difference (a stale entry).
    Empty when the two registries differ by exactly the table."""
    reg = registry if registry is not None else REGISTRY
    ours, theirs = surfaces(reg), surfaces(jax_registry)
    listed = {("jax", d.kind, d.name) for d in JAX_ONLY} | {
        ("port", d.kind, d.name) for d in PORT_ONLY}
    found = set()
    for kind in ours:
        a, b = ours[kind], theirs[kind]
        for name in set(b) - set(a):
            found.add(("jax", kind, name))
        for name in set(a) - set(b):
            found.add(("port", kind, name))
        for name in set(a) & set(b):
            if a[name] != b[name]:
                found.add(("port", kind, name))
    # an event only one side has differs in its fields by construction
    found = {f for f in found if not (
        f[1] == "event-fields" and (f[0], "event", f[2]) in found)}
    problems = [f"unlisted {side}-only {kind}: {name}"
                for side, kind, name in sorted(found - listed)]
    problems += [f"stale {side}-only entry {kind}: {name} (no such difference)"
                 for side, kind, name in sorted(listed - found)]
    return problems


# ---------------------------------------------------------------------------
# drift verification


def _first(sites: list[Site]) -> Site:
    return min(sites) if sites else ("", 0)


class ContractReport:
    """Outcome of one whole-program verification: surviving drift plus
    the bookkeeping the CLI/bench legs embed."""

    def __init__(self, drifts: list[Drift], waived: list[tuple[Waiver, int]],
                 checked: dict[str, int]):
        self.drifts = drifts
        self.waived = waived
        self.checked = checked

    @property
    def ok(self) -> bool:
        return not self.drifts

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "drift": [d.as_dict() for d in self.drifts],
            "waived": [
                {"kind": w.kind, "surface": w.surface, "why": w.why,
                 "matched": n}
                for w, n in self.waived
            ],
            "checked": self.checked,
        }


def verify(extraction: Extraction, registry: Registry = None,
           readme_text: str | None = None,
           fixtures_dir: str | None = None) -> ContractReport:
    """Cross-reference declared surfaces against extracted uses and
    return every drift a waiver does not excuse.

    Doc checks run only when `readme_text` is given; fixture wiring
    checks only when `fixtures_dir` is given — scratch copies of the
    package verify their internal contracts without either.

    Raises LintError for registry errors: a waiver without a why, or a
    waiver matching no drift (stale waivers must not outlive the drift
    they excused)."""
    reg = registry if registry is not None else REGISTRY
    drifts: list[Drift] = []

    def drift(kind: str, surface: str, detail: str,
              sites: list[Site] | None = None) -> None:
        path, line = _first(sites or [])
        drifts.append(Drift(kind, surface, detail, path, line))

    # -- env vars --------------------------------------------------------
    env_declared = reg.env_names()
    for name, sites in sorted(extraction.env_uses.items()):
        if name not in env_declared:
            drift("undeclared", f"env:{name}",
                  f"read/set at {len(sites)} site(s) but not in ENV_VARS",
                  sites)
    for name in sorted(env_declared - set(extraction.env_uses)):
        drift("unused", f"env:{name}",
              "declared in ENV_VARS but never read or set in the package")

    # -- failpoints ------------------------------------------------------
    for name in sorted(extraction.sites_literal - reg.failpoint_sites):
        drift("mismatch", f"failpoint:{name}",
              "in faults.failpoints.SITES but not in the registry")
    for name in sorted(reg.failpoint_sites - extraction.sites_literal):
        drift("mismatch", f"failpoint:{name}",
              "in the registry but not in faults.failpoints.SITES")
    fired = set(extraction.fire_sites) | set(extraction.schedule_sites)
    for name, sites in sorted(extraction.fire_sites.items()):
        if name not in reg.failpoint_sites:
            drift("undeclared", f"failpoint:{name}",
                  "fire() on a site the registry does not declare", sites)
    for name, sites in sorted(extraction.schedule_sites.items()):
        if name not in reg.failpoint_sites:
            drift("undeclared", f"failpoint:{name}",
                  "schedule string names an undeclared site", sites)
    for name in sorted(reg.failpoint_sites - fired):
        drift("unused", f"failpoint:{name}",
              "declared site with no fire() and no schedule mention")

    # -- ledger events ---------------------------------------------------
    ev_declared = reg.event_names()
    ev_fields = reg.event_fields()
    for name, sites in sorted(extraction.event_emits.items()):
        if name not in ev_declared:
            drift("undeclared", f"event:{name}",
                  f"emitted at {len(sites)} site(s) but not in EVENTS",
                  sites)
    for name in sorted(ev_declared - set(extraction.event_emits)):
        drift("unemitted", f"event:{name}",
              "declared in EVENTS but nothing in the package emits it")
    for name, sites in sorted(extraction.event_consumes.items()):
        if name not in ev_declared:
            drift("unemitted", f"event:{name}",
                  "a consumer matches on this name but no declared "
                  "event carries it", sites)
    schema = extraction.event_schema
    for name in sorted(ev_declared - set(schema)):
        drift("unconsumed", f"event:{name}",
              "declared event missing from ledger_tools.EVENT_SCHEMA "
              "(the universal consumer) — `observe check` cannot "
              "validate its payload")
    for name in sorted(set(schema) - ev_declared):
        drift("mismatch", f"event:{name}",
              "in ledger_tools.EVENT_SCHEMA but not in the registry")
    for name in sorted(set(schema) & ev_declared):
        if tuple(schema[name]) != tuple(ev_fields[name]):
            drift("mismatch", f"event:{name}",
                  f"required fields disagree: EVENT_SCHEMA "
                  f"{tuple(schema[name])!r} vs registry "
                  f"{tuple(ev_fields[name])!r}")

    # -- counters --------------------------------------------------------
    for name, sites in sorted(extraction.counter_reads.items()):
        if name not in reg.counters:
            drift("undeclared", f"counter:{name}",
                  "read cross-layer but not in COUNTERS", sites)
    for name in sorted(reg.counters - set(extraction.counter_writes)):
        drift("unemitted", f"counter:{name}",
              "declared counter that nothing in the package increments")

    # -- protocol ops ----------------------------------------------------
    planes = reg.op_planes()
    for (plane, name), sites in sorted(extraction.ops_dispatched.items()):
        if plane not in planes.get(name, ()):
            drift("undeclared", f"op:{name}",
                  f"dispatched by the {plane} plane but not declared "
                  f"for it", sites)
    for name, sites in sorted(extraction.ops_sent.items()):
        if name not in planes:
            drift("undeclared", f"op:{name}",
                  "sent by a client but not a declared op", sites)
    dispatched = {}
    for (plane, name) in extraction.ops_dispatched:
        dispatched.setdefault(name, set()).add(plane)
    for op in reg.ops:
        for plane in op.planes:
            if plane not in dispatched.get(op.name, set()):
                drift("unused", f"op:{op.name}",
                      f"declared for the {plane} plane but that plane "
                      f"never dispatches it")
        if op.name not in extraction.ops_sent:
            drift("unused", f"op:{op.name}",
                  "no in-package client ever sends it")

    # -- refusal reasons -------------------------------------------------
    for name, sites in sorted(extraction.refusal_uses.items()):
        if name not in reg.refusal_reasons:
            drift("undeclared", f"refusal:{name}",
                  "TransportError reason not in REFUSAL_REASONS", sites)
    for name in sorted(reg.refusal_reasons - set(extraction.refusal_uses)):
        drift("unused", f"refusal:{name}",
              "declared refusal reason never raised")

    # -- CLI surface -----------------------------------------------------
    cli_pairs = (
        (extraction.cli_commands, reg.cli_commands, "command"),
        (extraction.cli_subops, reg.cli_subops, "subop"),
        (extraction.cli_flags, reg.cli_flags, "flag"),
    )
    for extracted, declared, what in cli_pairs:
        for name, sites in sorted(extracted.items()):
            if name not in declared:
                drift("undeclared", f"cli:{name}",
                      f"cli.py defines this {what} but the registry "
                      f"does not declare it", sites)
        for name in sorted(declared - set(extracted)):
            drift("unused", f"cli:{name}",
                  f"declared {what} that cli.py does not define")

    # -- graftlint rules -------------------------------------------------
    for name, sites in sorted(extraction.rule_defs.items()):
        if name not in reg.rules:
            drift("undeclared", f"rule:{name}",
                  "Rule() defined but not in the registry", sites)
    for name in sorted(reg.rules - set(extraction.rule_defs)):
        drift("unused", f"rule:{name}",
              "declared rule with no Rule() definition")
    if extraction.engine_source:
        for mod in sorted(extraction.rule_modules):
            if mod not in extraction.engine_source:
                drift("unwired", f"rule-module:{mod}",
                      "rules module not imported by engine.all_rules — "
                      "its rules never run")
    if fixtures_dir is not None:
        seeded = _seeded_fixture_rules(fixtures_dir)
        for name in sorted(reg.rules - seeded):
            drift("unwired", f"rule:{name}",
                  f"no fixture under {fixtures_dir} carries a "
                  f"`# seeded: {name}` marker")

    # -- docs ------------------------------------------------------------
    if readme_text is not None:
        for v in reg.env_vars:
            if v.name not in readme_text:
                drift("undocumented", f"env:{v.name}",
                      "declared env var missing from the README table")
        for name in sorted(reg.rules):
            if name not in readme_text:
                drift("undocumented", f"rule:{name}",
                      "declared rule missing from the README")
        for name in sorted(reg.cli_commands):
            if name not in readme_text:
                drift("undocumented", f"cli:{name}",
                      "declared subcommand never mentioned in the README")

    # -- waivers ---------------------------------------------------------
    kept: list[Drift] = []
    matched: dict[Waiver, int] = {w: 0 for w in reg.waivers}
    for w in reg.waivers:
        if not w.why.strip():
            raise LintError(
                f"contract waiver for {w.surface!r} has no why — every "
                f"waiver must justify itself"
            )
    for d in drifts:
        hit = None
        for w in reg.waivers:
            if w.kind == d.kind and w.surface == d.surface:
                hit = w
                break
        if hit is None:
            kept.append(d)
        else:
            matched[hit] += 1
    stale = [w for w, n in matched.items() if n == 0]
    if stale:
        names = ", ".join(f"{w.kind}:{w.surface}" for w in stale)
        raise LintError(
            f"stale contract waiver(s) matching no drift: {names} — "
            f"remove them, they excuse nothing"
        )
    checked = {
        "env_vars": len(reg.env_vars),
        "failpoint_sites": len(reg.failpoint_sites),
        "events": len(reg.events),
        "counters": len(reg.counters),
        "ops": len(reg.ops),
        "refusal_reasons": len(reg.refusal_reasons),
        "cli_commands": len(reg.cli_commands),
        "cli_subops": len(reg.cli_subops),
        "cli_flags": len(reg.cli_flags),
        "rules": len(reg.rules),
    }
    kept.sort(key=lambda d: (d.kind, d.surface))
    return ContractReport(kept, sorted(matched.items(),
                                       key=lambda kv: kv[0].surface), checked)


def _seeded_fixture_rules(fixtures_dir: str) -> set[str]:
    out: set[str] = set()
    marker = re.compile(r"#\s*seeded:\s*([a-z-]+)")
    try:
        names = sorted(os.listdir(fixtures_dir))
    except OSError as exc:
        raise LintError(f"cannot list fixtures dir: {exc}") from exc
    for name in names:
        if not name.endswith(".py"):
            continue
        with open(os.path.join(fixtures_dir, name), encoding="utf-8") as fh:
            for m in marker.finditer(fh.read()):
                out.add(m.group(1))
    return out


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def verify_package(paths: list[str] | None = None,
                   registry: Registry = None) -> ContractReport:
    """Run the whole-program pass over `paths` (default: the installed
    package directory). README / fixture checks activate only when the
    expected repo-layout siblings exist next to the linted tree."""
    pkg_dir = package_root()
    roots = list(paths) if paths else [pkg_dir]
    known = all_rules()
    files = []
    for ap, display in _collect_py_lazy(roots):
        with open(ap, encoding="utf-8") as fh:
            files.append(SourceFile(ap, display, fh.read(), known))
    index = PackageIndex(files)
    anchor = os.path.dirname(os.path.abspath(roots[0]))
    readme = os.path.join(anchor, "README.md")
    readme_text = None
    if os.path.isfile(readme):
        with open(readme, encoding="utf-8") as fh:
            readme_text = fh.read()
    fixtures = os.path.join(anchor, "tests", "data", "torch_lint_fixtures")
    fixtures_dir = fixtures if os.path.isdir(fixtures) else None
    return verify(extract(index), registry, readme_text, fixtures_dir)


def _collect_py_lazy(roots: list[str]):
    return _collect_py(roots)


# ---------------------------------------------------------------------------
# README generation + dump


def render_env_table() -> str:
    """The README env-var table, generated from the registry so the
    two can never drift (the README check asserts every name appears;
    regenerating keeps type/default/effect columns honest too)."""
    rows = ["| Variable | Type | Default | Owner | Effect |",
            "| --- | --- | --- | --- | --- |"]
    for v in sorted(REGISTRY.env_vars, key=lambda v: v.name):
        rows.append(
            f"| `{v.name}` | {v.kind} | {v.default} | `{v.owner}` "
            f"| {v.doc} |"
        )
    for d in sorted(JAX_ONLY, key=lambda d: d.name):
        if d.kind == "env":
            rows.append(f"| `{d.name}` | — | — | JAX only | {d.why} |")
    return "\n".join(rows)


def _dump() -> None:
    report = verify_package()
    ex = extract(PackageIndex([
        SourceFile(ap, d, open(ap, encoding="utf-8").read(), all_rules())
        for ap, d in _collect_py_lazy([package_root()])
    ]))
    print("# extracted surfaces (paste-ready)")
    print("env:", sorted(ex.env_uses))
    print("events:", sorted(ex.event_emits))
    print("consumes:", sorted(ex.event_consumes))
    print("counters read:", sorted(ex.counter_reads))
    print("fire:", sorted(ex.fire_sites))
    print("schedules:", sorted(ex.schedule_sites))
    print("refusals:", sorted(ex.refusal_uses))
    print("ops dispatched:", sorted(ex.ops_dispatched))
    print("ops sent:", sorted(ex.ops_sent))
    print("cli commands:", sorted(ex.cli_commands))
    print("cli subops:", sorted(ex.cli_subops))
    print("cli flags:", sorted(ex.cli_flags))
    print("rules:", sorted(ex.rule_defs))
    print()
    print(f"# drift: {len(report.drifts)}  waived: {len(report.waived)}")
    for d in report.drifts:
        print(d.format())


if __name__ == "__main__":  # pragma: no cover - debugging aid
    import sys

    if "--dump" in sys.argv:
        _dump()
    else:
        print(__doc__)
