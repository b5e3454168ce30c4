"""A small file-DAG workflow engine with Snakemake-like rerun semantics.

The port's copy of the JAX package's pipeline/workflow.py (pure Python,
the same behaviour). The reference orchestrates its rules with Snakemake
(main.snake.py:40-189), relying on three behaviors this engine reproduces:

* file-based checkpointing — every rule's outputs are durable checkpoints;
* mtime-based rerun — a rule runs iff an output is missing or any input is
  newer than the oldest output (`--rerun-triggers mtime`); once a rule
  re-ran, every rule after it re-runs ("upstream rule re-ran");
* temp() cleanup — outputs marked temporary are deleted once every consumer
  has run (main.snake.py:125 marks the converted BAM temp()).

A rule that raises leaves no partial outputs behind. Rules are concrete:
inputs/outputs are resolved paths. Execution is sequential in topological
order — the reference's DAG is a pure chain per sample.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable


class WorkflowError(RuntimeError):
    pass


@dataclasses.dataclass
class Rule:
    name: str
    inputs: list[str]
    outputs: list[str]
    run: Callable[["Rule"], None]
    temp_outputs: set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class RuleResult:
    name: str
    ran: bool
    seconds: float = 0.0
    reason: str = ""


class Workflow:
    def __init__(self) -> None:
        self.rules: list[Rule] = []

    def rule(
        self,
        name: str,
        inputs: Iterable[str],
        outputs: Iterable[str],
        run: Callable[[Rule], None],
        temp_outputs: Iterable[str] = (),
    ) -> Rule:
        r = Rule(name, list(inputs), list(outputs), run, set(temp_outputs))
        for out in r.outputs:
            owner = self._producer(out)
            if owner is not None:
                raise WorkflowError(
                    f"output {out} produced by both {owner.name} and {name}"
                )
        self.rules.append(r)
        return r

    def _producer(self, path: str) -> Rule | None:
        for r in self.rules:
            if path in r.outputs:
                return r
        return None

    def _order_for(self, targets: list[str]) -> list[Rule]:
        """Topological order of the rules needed to produce targets."""
        order: list[Rule] = []
        visiting: set[str] = set()
        done: set[str] = set()

        def visit(rule: Rule) -> None:
            if rule.name in done:
                return
            if rule.name in visiting:
                raise WorkflowError(f"cycle through rule {rule.name}")
            visiting.add(rule.name)
            for inp in rule.inputs:
                dep = self._producer(inp)
                if dep is not None:
                    visit(dep)
                elif not os.path.exists(inp):
                    raise WorkflowError(
                        f"rule {rule.name} needs {inp}: no rule produces it "
                        "and it does not exist"
                    )
            visiting.discard(rule.name)
            done.add(rule.name)
            order.append(rule)

        for t in targets:
            p = self._producer(t)
            if p is None:
                if not os.path.exists(t):
                    raise WorkflowError(f"no rule produces target {t}")
                continue
            visit(p)
        return order

    @staticmethod
    def _needs_run(rule: Rule) -> tuple[bool, str]:
        missing = [o for o in rule.outputs if not os.path.exists(o)]
        if missing:
            return True, f"missing output {missing[0]}"
        out_mtime = min(os.path.getmtime(o) for o in rule.outputs)
        for inp in rule.inputs:
            if os.path.exists(inp) and os.path.getmtime(inp) > out_mtime:
                return True, f"input {inp} newer than outputs"
        return False, "up to date"

    def run(
        self, targets: list[str], force: bool = False, keep_temp: bool = False
    ) -> list[RuleResult]:
        order = self._order_for(targets)
        results: list[RuleResult] = []
        ran_any = False
        for rule in order:
            need, reason = (True, "forced") if force else self._needs_run(rule)
            # once an upstream rule re-ran, everything downstream re-runs
            if not need and ran_any:
                need, reason = True, "upstream rule re-ran"
            if not need:
                results.append(RuleResult(rule.name, False, 0.0, reason))
                continue
            for out in rule.outputs:
                parent = os.path.dirname(out)
                if parent:
                    os.makedirs(parent, exist_ok=True)
            t0 = time.monotonic()
            try:
                rule.run(rule)
            except BaseException:
                # never leave partial outputs behind: a later run would see
                # them as valid checkpoints and skip the rule
                for out in rule.outputs:
                    if os.path.exists(out):
                        os.unlink(out)
                raise
            dt = time.monotonic() - t0
            for out in rule.outputs:
                if not os.path.exists(out):
                    raise WorkflowError(
                        f"rule {rule.name} finished without creating {out}"
                    )
            ran_any = True
            results.append(RuleResult(rule.name, True, dt, reason))
        if not keep_temp:
            self._cleanup_temp(order, targets)
        return results

    def _cleanup_temp(self, order: list[Rule], targets: list[str]) -> None:
        for rule in order:
            for out in rule.temp_outputs:
                if out in targets:
                    continue
                if os.path.exists(out):
                    os.unlink(out)
