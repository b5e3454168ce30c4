"""The port's graftlint (bsseqconsensusreads_tpu_torch/analysis/): every
rule on its seeded fixture, the rules it shares with the JAX package held
to the JAX linter (on the fixtures and, in audit mode, over the JAX
package's own source), the torch rules' positive and negative cases, the
suppression grammar, the `lint` CLI, and the port's self-application.

Whole-package passes are shared through module-scoped fixtures."""

import json
import os
import re
import subprocess
import sys

import pytest

from bsseqconsensusreads_tpu.analysis import all_rules as jax_all_rules
from bsseqconsensusreads_tpu.analysis import run_lint as jax_run_lint
from bsseqconsensusreads_tpu_torch.analysis import (
    Finding,
    LintError,
    all_rules,
    run_lint,
)
from bsseqconsensusreads_tpu_torch.analysis.rules_torch import JAX_COUNTERPART

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXDIR = os.path.join(HERE, "data", "torch_lint_fixtures")
JAX_FIXDIR = os.path.join(HERE, "data", "lint_fixtures")
PKG = os.path.join(REPO, "bsseqconsensusreads_tpu_torch")
JAX_PKG = os.path.join(REPO, "bsseqconsensusreads_tpu")

#: rule -> the port fixture carrying its one seeded violation
FIXTURES = {
    "host-sync": "fx_host_sync.py",
    "kernel-rebuild": "fx_kernel_rebuild.py",
    "device-branch": "fx_device_branch.py",
    "thread-unsafe-mutation": "fx_thread_mutation.py",
    "io-in-device-span": "fx_io_in_device_span.py",
    "unordered-shape-iter": "fx_unordered_iter.py",
    "stderr-print": "fx_stderr_print.py",
    "swallowed-exception": "fx_swallowed_exception.py",
    "unbounded-retry": "fx_unbounded_retry.py",
    "serialized-host-phase": "fx_serialized_host_phase.py",
    "assert-on-input": "fx_assert_on_input.py",
    "per-record-alloc": "fx_per_record_alloc.py",
    "blocking-scheduler-loop": "fx_blocking_scheduler_loop.py",
    "padded-batch-flops": "fx_padded_batch_flops.py",
    "padded-envelope-dispatch": "fx_padded_envelope_dispatch.py",
    "unfused-methyl-scan": "fx_unfused_methyl_scan.py",
    "unframed-socket-read": "fx_unframed_socket_read.py",
    "serial-deflate": "fx_serial_deflate.py",
    "unfenced-commit": "fx_unfenced_commit.py",
    "unleased-work-dispatch": "fx_unleased_work_dispatch.py",
    "untraced-transport-send": "fx_untraced_transport_send.py",
    "contract-drift": "fx_contract_drift.py",
    "unbounded-drain-wait": "fx_unbounded_drain_wait.py",
}

#: the rules both linters have by name, whose meaning is the same; the
#: port's host-sync keeps its name but reads torch's sources and sinks,
#: so it is held to its own fixture and cases instead
SHARED = sorted(set(all_rules()) & set(jax_all_rules()) - {"host-sync"})

#: shared rules left out of the audit over the JAX package's source, and why
AUDIT_EXCLUDED = {
    "contract-drift": "checks each use against the linting package's own registry "
                      "(analysis.contracts.REGISTRY): the port's registry declares the "
                      "port's surface, so the JAX package's JAX-only knobs read as "
                      "undeclared there by design",
}

#: the JAX package's Thread(...) sites marked owned-thread, by file, and
#: how many the port's counterpart must carry
OWNED_THREADS = {
    "serve/router.py": 1, "serve/scheduler.py": 2, "serve/server.py": 2,
    "elastic/worker.py": 1, "elastic/coordinator.py": 2,
}


def seeded_line(fixdir: str, fixture: str, rule: str) -> int:
    with open(os.path.join(fixdir, fixture)) as fh:
        for i, line in enumerate(fh, 1):
            if f"# seeded: {rule}" in line:
                return i
    raise AssertionError(f"no seeded marker for {rule} in {fixture}")


def _blocked_cli(*args, timeout=300):
    """`python -m bsseqconsensusreads_tpu_torch lint ...` in a child whose
    imports of jax and of the JAX package fail."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['bsseqconsensusreads_tpu'] = None; "
        "from bsseqconsensusreads_tpu_torch.cli import main; "
        f"sys.exit(main(['lint', *{list(args)!r}]))"
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=timeout)


@pytest.fixture(scope="module")
def self_application():
    """The port's `lint --json` over its own package, jax blocked."""
    return _blocked_cli("--json")


@pytest.fixture(scope="module")
def audit_over_jax():
    """Both linters in audit mode over the JAX package, shared rules only:
    {rule: set of (path, line)} for each."""
    rules = [r for r in SHARED if r not in AUDIT_EXCLUDED]
    port = run_lint([JAX_PKG], rules=rules, include_suppressed=True)
    jax = jax_run_lint([JAX_PKG], rules=rules, include_suppressed=True)

    def by_rule(findings):
        out = {r: set() for r in rules}
        for f in findings:
            out[f.rule].add((f.path, f.line))
        return out

    return by_rule(port), by_rule(jax)


# ---------------------------------------------------------------------------
# seeded fixtures


class TestSeededFixtures:
    def test_fixture_table_covers_all_rules(self):
        assert set(FIXTURES) == set(all_rules())

    @pytest.mark.parametrize("rule", sorted(FIXTURES))
    def test_rule_fires_exactly_at_seed(self, rule):
        fixture = FIXTURES[rule]
        findings = run_lint([os.path.join(FIXDIR, fixture)], rules=[rule])
        assert [(f.rule, f.line) for f in findings] == [
            (rule, seeded_line(FIXDIR, fixture, rule))
        ]

    def test_directory_sweep_is_one_finding_per_rule(self):
        findings = run_lint([FIXDIR])
        assert sorted(f.rule for f in findings) == sorted(FIXTURES)
        for f in findings:
            assert os.path.basename(f.path) == FIXTURES[f.rule]
            assert f.line == seeded_line(FIXDIR, FIXTURES[f.rule], f.rule)

    def test_finding_shape(self):
        (f,) = run_lint([os.path.join(FIXDIR, "fx_stderr_print.py")], rules=["stderr-print"])
        assert isinstance(f, Finding)
        assert set(f.as_dict()) == {"rule", "path", "line", "col", "message"}
        assert f.format().startswith(f"{f.path}:{f.line}:")


# ---------------------------------------------------------------------------
# the rule set against the JAX package's


def test_every_jax_rule_has_exactly_one_port_rule():
    port, jax = set(all_rules()), set(jax_all_rules())
    for rule in jax:
        mapped = [r for r in port if r == JAX_COUNTERPART.get(rule, rule)]
        assert len(mapped) == 1, rule
    assert len(port) == len(jax)
    assert set(JAX_COUNTERPART) == jax - port
    assert set(JAX_COUNTERPART.values()) == port - jax
    assert len(SHARED) == 20


@pytest.mark.parametrize("rule", SHARED)
def test_shared_rule_agrees_with_the_jax_linter_on_the_fixtures(rule):
    """The port's linter on its fixture and the JAX linter on the JAX
    package's fixture report the same (rule, line, col)."""
    name = FIXTURES[rule]
    port = run_lint([os.path.join(FIXDIR, name)], rules=[rule])
    jax = jax_run_lint([os.path.join(JAX_FIXDIR, name)], rules=[rule])
    assert [(f.rule, f.line, f.col) for f in port] == [(f.rule, f.line, f.col) for f in jax]
    assert len(port) == 1


@pytest.mark.parametrize("rule", [r for r in SHARED if r not in AUDIT_EXCLUDED])
def test_shared_rule_agrees_with_the_jax_linter_over_the_jax_package(rule, audit_over_jax):
    """Audit mode (suppressions ignored) over the JAX package's source: the
    same (path, line) set for every shared rule; the JAX package's own
    suppressions, JAX rule names included, parse under the port's engine."""
    port, jax = audit_over_jax
    assert port[rule] == jax[rule]


def test_the_audit_sees_the_jax_packages_suppressed_sites(audit_over_jax):
    port, _jax = audit_over_jax
    assert sum(len(v) for v in port.values()) >= 20
    assert set(AUDIT_EXCLUDED) <= set(SHARED)


# ---------------------------------------------------------------------------
# the torch rules


def _lint(tmp_path, body, rules):
    p = tmp_path / "case.py"
    p.write_text(body)
    return run_lint([str(p)], rules=rules)


SYNC_PREFIX = (
    "import numpy as np\nimport torch\n\n\n"
    "def seg_vote(b, q, o, p):\n    return b\n\n\n"
)


class TestHostSync:
    def test_item_outside_a_span_is_flagged(self, tmp_path):
        body = SYNC_PREFIX + (
            "def hot_loop(xs, p):\n"
            "    for b in xs:\n"
            "        out = seg_vote(b, b, b, p)\n"
            "        n = out.sum().item()\n"
            "    return n\n"
        )
        (f,) = _lint(tmp_path, body, ["host-sync"])
        assert f.line == 12 and ".item()" in f.message

    def test_item_inside_device_wait_is_clean(self, tmp_path):
        body = SYNC_PREFIX + (
            "def hot_loop(xs, p, metrics):\n"
            "    for b in xs:\n"
            "        out = seg_vote(b, b, b, p)\n"
            "        with metrics.timed(\"device_wait\"):\n"
            "            n = out.sum().item()\n"
            "    return n\n"
        )
        assert _lint(tmp_path, body, ["host-sync"]) == []

    def test_cpu_tensor_and_numpy_are_clean(self, tmp_path):
        body = SYNC_PREFIX + (
            "def hot_loop(xs):\n"
            "    t = torch.zeros(4, device=\"cpu\")\n"
            "    a = np.zeros(4)\n"
            "    u = torch.from_numpy(a)\n"
            "    return t.sum().item() + float(a.sum()) + u.tolist()[0] + int(a[0])\n"
        )
        assert _lint(tmp_path, body, ["host-sync"]) == []

    def test_shape_reads_are_clean(self, tmp_path):
        body = SYNC_PREFIX + (
            "def hot_loop(x, dev, p):\n"
            "    out = seg_vote(x.to(dev), x, x, p)\n"
            "    return int(out.shape[0]) + len(out) + out.numel()\n"
        )
        assert _lint(tmp_path, body, ["host-sync"]) == []

    @pytest.mark.parametrize("expr,what", [
        ("t.cpu()", ".cpu()"),
        ("t.numpy()", ".numpy()"),
        ("t.tolist()", ".tolist()"),
        ("t.to(\"cpu\")", ".to('cpu')"),
        ("bool(t.any())", "bool()"),
        ("torch.nonzero(t)", "nonzero()"),
        ("t.unique()", "unique()"),
        ("torch.masked_select(t, t > 0)", "masked_select()"),
        ("t[t > 0]", "boolean-mask index"),
        ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
        ("ev.synchronize()", "ev.synchronize()"),
    ])
    def test_each_sink_on_a_device_tensor_is_flagged(self, tmp_path, expr, what):
        body = SYNC_PREFIX + (
            "def hot_loop(n, dev, ev):\n"
            "    t = torch.arange(n, device=dev)\n"
            f"    return {expr}\n"
        )
        (f,) = _lint(tmp_path, body, ["host-sync"])
        assert f.line == 11 and what in f.message

    def test_a_producer_taints_its_callers_result(self, tmp_path):
        body = SYNC_PREFIX + (
            "def vote(b, p):\n"
            "    return {\"qual\": seg_vote(b, b, b, p)}\n\n\n"
            "def hot_loop(b, p):\n"
            "    out = vote(b, p)\n"
            "    return out[\"qual\"].cpu()\n"
        )
        (f,) = _lint(tmp_path, body, ["host-sync"])
        assert f.line == 15

    def test_a_host_function_ends_the_taint(self, tmp_path):
        body = SYNC_PREFIX + (
            "def fetch(t):\n"
            "    return t.cpu().numpy()\n\n\n"
            "def hot_loop(b, p, metrics):\n"
            "    out = seg_vote(b, b, b, p)\n"
            "    with metrics.timed(\"fetch\"):\n"
            "        host = fetch(out)\n"
            "    return int(host.sum())\n"
        )
        assert _lint(tmp_path, body, ["host-sync"]) == []

    def test_off_the_hot_path_is_clean(self, tmp_path):
        body = SYNC_PREFIX + (
            "def report(n, dev):\n"
            "    return torch.arange(n, device=dev).sum().item()\n"
        )
        assert _lint(tmp_path, body, ["host-sync"]) == []


class TestKernelRebuild:
    def test_nvcc_build_in_a_loop_is_flagged(self, tmp_path):
        body = (
            "def _nvcc():\n    return 'nvcc'\n\n\n"
            "def build_all(srcs):\n"
            "    for s in srcs:\n"
            "        cmd = [_nvcc(), s]\n"
        )
        (f,) = _lint(tmp_path, body, ["kernel-rebuild"])
        assert f.line == 7 and "inside a loop" in f.message

    def test_load_behind_a_module_cache_is_clean(self, tmp_path):
        body = (
            "import ctypes\n\n_LIBS = {}\n\n\n"
            "def _load(path):\n"
            "    lib = _LIBS.get(path)\n"
            "    if lib is None:\n"
            "        lib = _LIBS[path] = ctypes.CDLL(path)\n"
            "    return lib\n\n\n"
            "def hot_loop(xs, path):\n"
            "    for x in xs:\n"
            "        _load(path)\n"
        )
        assert _lint(tmp_path, body, ["kernel-rebuild"]) == []

    def test_uncached_load_on_the_hot_path_is_flagged(self, tmp_path):
        body = (
            "import ctypes\n\n\n"
            "def _load(path):\n"
            "    return ctypes.CDLL(path)\n\n\n"
            "def hot_loop(xs, path):\n"
            "    return [x for x in xs] and _load(path)\n"
        )
        (f,) = _lint(tmp_path, body, ["kernel-rebuild"])
        assert f.line == 5 and "batch-loop" in f.message

    def test_a_helper_only_a_cached_loader_calls_is_clean(self, tmp_path):
        body = (
            "import functools\n\n\n"
            "def _nvcc():\n    return 'nvcc'\n\n\n"
            "def build():\n    return [_nvcc()]\n\n\n"
            "@functools.lru_cache(None)\n"
            "def load():\n    return build()\n\n\n"
            "def hot_loop(xs):\n    return [load() for x in xs]\n"
        )
        assert _lint(tmp_path, body, ["kernel-rebuild"]) == []

    @pytest.mark.parametrize("call", ["torch.compile(f)", "torch.jit.script(f)",
                                      "torch.jit.trace(f, x)", "torch.ops.load_library(f)"])
    def test_compiles_in_a_loop_are_flagged(self, tmp_path, call):
        body = f"import torch\n\n\ndef go(fs, x):\n    for f in fs:\n        g = {call}\n"
        (f,) = _lint(tmp_path, body, ["kernel-rebuild"])
        assert f.line == 6

    def test_re_compile_is_not_a_kernel_build(self, tmp_path):
        body = "import re\n\n\ndef go(ps):\n    for p in ps:\n        re.compile(p)\n"
        assert _lint(tmp_path, body, ["kernel-rebuild"]) == []


class TestDeviceBranch:
    def test_if_on_a_device_tensor_is_flagged(self, tmp_path):
        body = (
            "import torch\n\n\n"
            "def hot_loop(n, dev):\n"
            "    t = torch.ones(n, device=dev)\n"
            "    if t.any():\n"
            "        return 1\n"
            "    return 0\n"
        )
        (f,) = _lint(tmp_path, body, ["device-branch"])
        assert f.line == 6 and "['t']" in f.message

    @pytest.mark.parametrize("stmt,line", [
        ("    while t.sum() > 0:\n        t = t - 1\n", 6),
        ("    assert t.all()\n", 6),
        ("    x = 1 if t.any() else 0\n", 6),
        ("    x = t.any() and 1\n", 6),
    ])
    def test_each_branch_form_is_flagged(self, tmp_path, stmt, line):
        body = ("import torch\n\n\n" "def hot_loop(n, dev):\n"
                "    t = torch.ones(n, device=dev)\n" + stmt)
        (f,) = _lint(tmp_path, body, ["device-branch"])
        assert f.line == line

    def test_none_checks_shapes_and_host_values_are_clean(self, tmp_path):
        body = (
            "import torch\n\n\n"
            "def hot_loop(n, dev, m=None):\n"
            "    t = torch.ones(n, device=dev)\n"
            "    if m is not None and t.shape[0] > 1:\n"
            "        pass\n"
            "    if t.numel() or len(t):\n"
            "        pass\n"
            "    c = t.sum().item()\n"
            "    if c > 0:\n"
            "        return 1\n"
            "    return 0\n"
        )
        assert _lint(tmp_path, body, ["device-branch"]) == []

    def test_a_nested_parameter_shadows_the_outer_tensor(self, tmp_path):
        body = (
            "import torch\n\n\n"
            "def hot_loop(n, dev):\n"
            "    wire = torch.ones(n, device=dev)\n\n"
            "    def dispatch(wire):\n"
            "        if wire:\n"
            "            return 1\n"
            "        return 0\n"
            "    return dispatch(True), wire\n"
        )
        assert _lint(tmp_path, body, ["device-branch"]) == []


# ---------------------------------------------------------------------------
# suppressions


class TestSuppressions:
    VIOLATION = "import sys\n\n\ndef report(msg):\n    print(msg, file=sys.stderr)\n"

    def write(self, tmp_path, body):
        p = tmp_path / "case.py"
        p.write_text(body)
        return str(p)

    @pytest.mark.parametrize("variant", [
        "inline", "inline-why", "standalone", "file",
    ])
    def test_suppression_forms(self, tmp_path, variant):
        body = {
            "inline": self.VIOLATION.replace(
                "file=sys.stderr)", "file=sys.stderr)  # graftlint: disable=stderr-print"),
            "inline-why": self.VIOLATION.replace(
                "file=sys.stderr)",
                "file=sys.stderr)  # graftlint: disable=stderr-print -- why not"),
            "standalone": self.VIOLATION.replace(
                "    print(msg, file=sys.stderr)",
                "    # graftlint: disable=stderr-print\n    print(msg, file=sys.stderr)"),
            "file": "# graftlint: disable-file=stderr-print\n" + self.VIOLATION,
        }[variant]
        path = self.write(tmp_path, body)
        assert run_lint([path], rules=["stderr-print"]) == []
        assert len(run_lint([path], rules=["stderr-print"], include_suppressed=True)) == 1

    def test_unsuppressed_fires_and_suppression_is_rule_scoped(self, tmp_path):
        path = self.write(tmp_path, self.VIOLATION)
        assert len(run_lint([path], rules=["stderr-print"])) == 1
        path = self.write(tmp_path, self.VIOLATION.replace(
            "file=sys.stderr)", "file=sys.stderr)  # graftlint: disable=host-sync"))
        assert len(run_lint([path], rules=["stderr-print"])) == 1

    @pytest.mark.parametrize("directive,match", [
        ("disable=no-such-rule", "no-such-rule"),
        ("disable=", "unknown graftlint rule"),
        ("frobnicate=stderr-print", "bad graftlint directive"),
    ])
    def test_bad_directives_are_hard_errors(self, tmp_path, directive, match):
        path = self.write(tmp_path, self.VIOLATION.replace(
            "file=sys.stderr)", f"file=sys.stderr)  # graftlint: {directive}"))
        with pytest.raises(LintError, match=match):
            run_lint([path])

    def test_unknown_rule_argument_errors(self, tmp_path):
        with pytest.raises(LintError, match="no-such-rule"):
            run_lint([self.write(tmp_path, "x = 1\n")], rules=["no-such-rule"])

    def test_a_jax_rule_name_covers_its_port_counterpart(self, tmp_path):
        body = (
            "def _nvcc():\n    return 'nvcc'\n\n\n"
            "def build_all(srcs):\n"
            "    for s in srcs:\n"
            "        cmd = [_nvcc(), s]  # graftlint: disable=jit-recompile -- alias\n"
        )
        path = self.write(tmp_path, body)
        assert run_lint([path], rules=["kernel-rebuild"]) == []

    def test_owned_thread_is_not_a_worker_root(self, tmp_path):
        body = (
            "import threading\n\n\n"
            "class Loop:\n"
            "    def _run(self):\n"
            "        self.n = 1\n\n"
            "    def start(self):\n"
            "        # graftlint: owned-thread -- the one loop thread\n"
            "        threading.Thread(target=self._run).start()\n"
        )
        path = self.write(tmp_path, body)
        assert run_lint([path], rules=["thread-unsafe-mutation"]) == []
        unmarked = self.write(tmp_path, body.replace(
            "        # graftlint: owned-thread -- the one loop thread\n", ""))
        assert len(run_lint([unmarked], rules=["thread-unsafe-mutation"])) == 1


# ---------------------------------------------------------------------------
# the port's own source


def _port_sources():
    for root, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in sorted(names):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as fh:
                    yield os.path.relpath(path, PKG), fh.read()


def test_every_port_suppression_names_its_rule_and_says_why():
    rules = set(all_rules())
    directive = re.compile(r"#\s*graftlint:\s*(disable(?:-file)?=\S*)(.*)$")
    seen = 0
    for rel, text in _port_sources():
        if rel.startswith("analysis" + os.sep):
            continue
        for n, line in enumerate(text.splitlines(), 1):
            m = directive.search(line)
            if not m:
                continue
            seen += 1
            names = m.group(1).split("=", 1)[1].split(",")
            assert names and set(names) <= rules, f"{rel}:{n}: {line.strip()}"
            why = m.group(2).strip()
            assert why.startswith("--") and len(why) > 6, f"{rel}:{n}: no why"
    # the scan saw every directive the engine binds
    assert seen == sum(len(sf.line_suppress) + len(sf.file_suppress)
                       for sf in _port_source_files()) > 0


#: host-sync directives that no static finding needs: the on-card audit
#: (chip_smoke Phase 12b) reads them for syncs the torch rule cannot see
AUDIT_ONLY = {
    ("ops/refstore.py", "device_codes"): "the genome's pageable upload, timed "
                                          "as genome_load.upload",
    ("pipeline/calling.py", "_run_task"): "the overlap worker's stream drain",
}


def _port_source_files():
    from bsseqconsensusreads_tpu_torch.analysis.engine import SourceFile

    known = all_rules()
    return [SourceFile(os.path.join(PKG, rel), rel, text, known)
            for rel, text in _port_sources() if not rel.startswith("analysis" + os.sep)]


def test_every_port_suppression_covers_a_finding():
    """No directive is stale: each binds a line where its rule, in audit
    mode, has a finding (a renamed function can take a whole subtree off
    the worker closure, and then its directives cover nothing), apart from
    AUDIT_ONLY's host-sync directives."""
    import ast

    found = {(os.path.relpath(f.path, PKG), f.line, f.rule)
             for f in run_lint([PKG], include_suppressed=True)}
    stale, audit_only = [], set()
    for sf in _port_source_files():
        defs = [n for n in ast.walk(ast.parse(sf.source))
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for line, rules in sf.line_suppress.items():
            for rule in rules:
                if (sf.display, line, rule) in found:
                    continue
                func = min((n for n in defs if n.lineno <= line <= n.end_lineno),
                           key=lambda n: n.end_lineno - n.lineno, default=None)
                key = (sf.display, func.name if func else "")
                if rule == "host-sync" and key in AUDIT_ONLY:
                    audit_only.add(key)
                else:
                    stale.append(f"{sf.display}:{line} {rule}")
    assert not stale, stale
    assert audit_only == set(AUDIT_ONLY)


@pytest.mark.parametrize("rel,count", sorted(OWNED_THREADS.items()))
def test_owned_thread_markers_mirror_the_jax_package(rel, count):
    for pkg in (PKG, JAX_PKG):
        with open(os.path.join(pkg, rel), encoding="utf-8") as fh:
            assert fh.read().count("# graftlint: owned-thread --") == count, (pkg, rel)


# ---------------------------------------------------------------------------
# the CLI


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "lint", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )


class TestCli:
    def test_list_rules(self):
        cp = run_cli("--list-rules", "--json")
        assert cp.returncode == 0
        assert set(json.loads(cp.stdout)) == set(all_rules())

    def test_fixture_dir_exits_1_with_one_finding_per_rule(self):
        cp = run_cli("--json", FIXDIR)
        assert cp.returncode == 1
        data = json.loads(cp.stdout)
        assert set(data) == {"findings", "count", "rules", "paths"}
        assert data["count"] == len(FIXTURES)
        assert sorted(f["rule"] for f in data["findings"]) == sorted(FIXTURES)

    def test_unknown_rule_exits_2(self):
        cp = run_cli("--rules", "no-such-rule", "--json")
        assert cp.returncode == 2
        assert "no-such-rule" in json.loads(cp.stdout)["error"]

    def test_self_application_is_clean_without_jax(self, self_application):
        """The tier-1 gate: `lint --json` over the port, in a process that
        cannot import jax or the JAX package, exits 0 with no finding."""
        cp = self_application
        assert cp.returncode == 0, cp.stdout[-3000:] + cp.stderr[-3000:]
        data = json.loads(cp.stdout)
        assert data["count"] == 0 and data["findings"] == []
        assert sorted(data["rules"]) == sorted(all_rules())
        assert data["paths"] == [PKG]
