"""The port's graftcontract (bsseqconsensusreads_tpu_torch/analysis/
contracts.py): its registry against its in-code mirrors and against the
JAX package's registry (which may differ only by JAX_ONLY / PORT_ONLY),
seeded drift in a scratch copy of the port and in the registry, waiver
semantics, the `lint --contracts` gate, and the JAX package's env knobs
the port honors, each held to the JAX package's bytes under the knob.

One extraction of the real package is shared by the registry tests, and
one scratch copy carries every source mutation."""

import copy
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bsseqconsensusreads_tpu.analysis import contracts as jcontracts
from bsseqconsensusreads_tpu.io import native as jnative
from bsseqconsensusreads_tpu.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu.methyl import tally as jtally
from bsseqconsensusreads_tpu.models.params import ConsensusParams as JaxParams
from bsseqconsensusreads_tpu.ops import refstore as jrs
from bsseqconsensusreads_tpu.pipeline import calling as jc
from bsseqconsensusreads_tpu.pipeline import extsort as je
from bsseqconsensusreads_tpu.utils.testing import (
    make_aligned_duplex_group,
    random_genome,
    stream_duplex_families,
)
from bsseqconsensusreads_tpu_torch.analysis import contracts
from bsseqconsensusreads_tpu_torch.analysis.engine import (
    LintError,
    PackageIndex,
    SourceFile,
    _collect_py,
    all_rules,
)
from bsseqconsensusreads_tpu_torch.io import native as tnative
from bsseqconsensusreads_tpu_torch.io import wirepack as twirepack
from bsseqconsensusreads_tpu_torch.io.bam import BamReader as PortReader
from bsseqconsensusreads_tpu_torch.methyl import tally as ttally
from bsseqconsensusreads_tpu_torch.models.params import ConsensusParams
from bsseqconsensusreads_tpu_torch.ops import refstore as trs
from bsseqconsensusreads_tpu_torch.pipeline import calling as tc
from bsseqconsensusreads_tpu_torch.pipeline import extsort as te
from bsseqconsensusreads_tpu_torch.utils.testing import ensure_reference_natives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = contracts.package_root()
FIXDIR = os.path.join(REPO, "tests", "data", "torch_lint_fixtures")
JROUTE = dict(mesh=None, transport="unpacked", emit="python", vote_kernel="xla")


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def real():
    """(extraction of the port's package, README text, fixtures dir)."""
    known = all_rules()
    files = []
    for ap, display in _collect_py([PKG_DIR]):
        with open(ap, encoding="utf-8") as fh:
            files.append(SourceFile(ap, display, fh.read(), known))
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        readme = fh.read()
    return contracts.extract(PackageIndex(files)), readme, FIXDIR


def _verify(real, registry=None):
    ex, readme, fixtures = real
    return contracts.verify(ex, registry, readme, fixtures)


def _kinds(report):
    return {(d.kind, d.surface) for d in report.drifts}


# ---------------------------------------------------------------------------
# the registry and its mirrors


def test_registry_wellformed():
    reg = contracts.REGISTRY
    env_re = re.compile(r"^BSSEQ_TPU_[A-Z0-9_]+$")
    names = [v.name for v in reg.env_vars]
    assert len(names) == len(set(names))
    for v in reg.env_vars:
        assert env_re.match(v.name) and v.kind and v.owner and v.doc, v
    ev_names = [e.name for e in reg.events]
    assert len(ev_names) == len(set(ev_names))
    for e in reg.events:
        assert isinstance(e.fields, tuple) and all(isinstance(f, str) for f in e.fields)
    for op in reg.ops:
        assert set(op.planes) <= {"serve", "router", "coordinator"} and op.doc, op
    for w in reg.waivers:
        assert w.why.strip(), w.surface
    assert contracts.PKG == "bsseqconsensusreads_tpu_torch"


def test_registry_mirrors_the_ports_event_schema():
    from bsseqconsensusreads_tpu_torch.utils.ledger_tools import EVENT_SCHEMA

    assert contracts.REGISTRY.event_fields() == {k: tuple(v) for k, v in EVENT_SCHEMA.items()}


def test_registry_mirrors_the_ports_failpoint_sites():
    from bsseqconsensusreads_tpu_torch.faults.failpoints import SITES

    assert contracts.REGISTRY.failpoint_sites == frozenset(SITES)


def test_report_roundtrips_through_json(real):
    d = json.loads(json.dumps(_verify(real).as_dict()))
    assert d["ok"] is True and d["drift"] == []
    assert d["checked"]["rules"] == len(contracts.REGISTRY.rules) == len(all_rules())
    assert any(w["surface"] == "op:fleet" and w["why"] for w in d["waived"])


def test_readme_carries_the_generated_env_table():
    table = contracts.render_env_table()
    for v in contracts.REGISTRY.env_vars:
        assert f"`{v.name}`" in table
    jax_only = [d for d in contracts.JAX_ONLY if d.kind == "env"]
    for d in jax_only:
        assert f"| `{d.name}` | — | — | JAX only | {d.why} |" in table
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        assert table in fh.read()


# ---------------------------------------------------------------------------
# the registry against the JAX package's


def test_registry_differs_from_the_jax_packages_only_by_the_table():
    assert contracts.diff_against(jcontracts.REGISTRY) == []
    for d in contracts.JAX_ONLY + contracts.PORT_ONLY:
        assert d.kind and d.name and d.why.strip(), d


def test_an_unlisted_difference_fails():
    reg = contracts.REGISTRY
    extra = dataclasses.replace(reg, counters=reg.counters | {"ghost_counter"})
    assert contracts.diff_against(jcontracts.REGISTRY, extra) == [
        "unlisted port-only counter: ghost_counter"]
    fewer = dataclasses.replace(reg, refusal_reasons=reg.refusal_reasons - {"bad_json"})
    assert contracts.diff_against(jcontracts.REGISTRY, fewer) == [
        "unlisted jax-only refusal: bad_json"]
    fields = dataclasses.replace(reg, events=tuple(
        dataclasses.replace(e, fields=e.fields + ("extra",)) if e.name == "spill" else e
        for e in reg.events))
    assert contracts.diff_against(jcontracts.REGISTRY, fields) == [
        "unlisted port-only event-fields: spill"]


def test_a_stale_table_entry_fails(monkeypatch):
    monkeypatch.setattr(contracts, "PORT_ONLY", contracts.PORT_ONLY + (
        contracts.Difference("env", "BSSEQ_TPU_NOT_A_KNOB", "names nothing"),))
    assert contracts.diff_against(jcontracts.REGISTRY) == [
        "stale port-only entry env: BSSEQ_TPU_NOT_A_KNOB (no such difference)"]


def test_every_jax_knob_is_honored_or_listed(real):
    """Each BSSEQ_TPU_* the JAX package declares is in the port's registry
    (and read by the port) or JAX_ONLY with its reason (and never read)."""
    ex, _readme, _fx = real
    ours = contracts.REGISTRY.env_names()
    jax_only = {d.name for d in contracts.JAX_ONLY if d.kind == "env"}
    for name in jcontracts.REGISTRY.env_names():
        assert (name in ours) != (name in jax_only), name
        assert (name in ex.env_uses) == (name in ours), name
    assert jax_only == {
        "BSSEQ_TPU_BACKEND", "BSSEQ_TPU_VOTE_KERNEL", "BSSEQ_TPU_BAMIO_SO",
        "BSSEQ_TPU_WIREPACK_SO", "BSSEQ_TPU_NATIVE_WIRE", "BSSEQ_TPU_NATIVE_GROUPING",
    }


# ---------------------------------------------------------------------------
# seeded drift: one scratch copy of the port carrying every mutation

MUTATIONS = {
    "renamed_event": (os.path.join("pipeline", "bucketemit.py"),
                      '"bucket_plan",', '"bucket_plan_v2",',
                      {("undeclared", "event:bucket_plan_v2"),
                       ("unemitted", "event:bucket_plan")}),
    "undeclared_env": ("config.py", "import os",
                       'import os\n_GHOST = os.environ.get("BSSEQ_TPU_GHOST_KNOB")',
                       {("undeclared", "env:BSSEQ_TPU_GHOST_KNOB")}),
    "unknown_op": ("config.py", "import os", 'import os\n_GHOST_REQ = {"op": "frobnicate"}',
                   {("undeclared", "op:frobnicate")}),
    "undeclared_flag": ("cli.py", '"--list-rules", action="store_true"',
                        '"--ghost-flag", action="store_true")\n'
                        '    p.add_argument("--list-rules", action="store_true"',
                        {("undeclared", "cli:--ghost-flag")}),
    "undeclared_fire_site": (os.path.join("pipeline", "bucketemit.py"),
                             '_failpoints.fire("bucket_spill", bucket=bucket, run=run_index)',
                             '_failpoints.fire("ghost_site", bucket=bucket, run=run_index)',
                             {("undeclared", "failpoint:ghost_site")}),
}


def _scratch(tmp_path_factory, name):
    scratch = str(tmp_path_factory.mktemp(name) / "bsseqconsensusreads_tpu_torch")
    shutil.copytree(PKG_DIR, scratch,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
    return scratch


@pytest.fixture(scope="module")
def mutated_report(tmp_path_factory):
    scratch = _scratch(tmp_path_factory, "contracts_mut")
    for rel, old, new, _want in MUTATIONS.values():
        path = os.path.join(scratch, rel)
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert old in text, f"mutation anchor missing from {rel}: {old!r}"
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text.replace(old, new, 1))
    return contracts.verify_package([scratch])


def test_scratch_copy_is_clean(tmp_path_factory):
    report = contracts.verify_package([_scratch(tmp_path_factory, "contracts_clean")])
    assert report.ok, [d.format() for d in report.drifts]


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_seeded_source_drift_is_caught(mutated_report, mutation):
    assert not mutated_report.ok
    assert MUTATIONS[mutation][3] <= _kinds(mutated_report)


# ---------------------------------------------------------------------------
# seeded drift: registry mutations over the real package


def test_deleted_event_entry_drifts(real):
    reg = contracts.REGISTRY
    report = _verify(real, dataclasses.replace(
        reg, events=tuple(e for e in reg.events if e.name != "spill")))
    assert {("undeclared", "event:spill"), ("mismatch", "event:spill")} <= _kinds(report)


def test_deleted_env_entry_drifts(real):
    reg = contracts.REGISTRY
    report = _verify(real, dataclasses.replace(
        reg, env_vars=tuple(v for v in reg.env_vars if v.name != "BSSEQ_TPU_STATS")))
    assert ("undeclared", "env:BSSEQ_TPU_STATS") in _kinds(report)


def test_orphan_event_entry_drifts(real):
    reg = contracts.REGISTRY
    report = _verify(real, dataclasses.replace(reg, events=reg.events + (
        contracts.LedgerEvent("ghost_event", ("what",), "nowhere"),)))
    assert {("unemitted", "event:ghost_event"), ("unconsumed", "event:ghost_event")} <= \
        _kinds(report)


def test_missing_fixture_is_unwired(real):
    reg = contracts.REGISTRY
    report = _verify(real, dataclasses.replace(reg, rules=reg.rules | {"ghost-rule"}))
    assert {("unwired", "rule:ghost-rule"), ("unused", "rule:ghost-rule"),
            ("undocumented", "rule:ghost-rule")} <= _kinds(report)


def test_a_knob_the_port_stops_reading_drifts(real):
    """Were the port to drop a knob it honors, the knob would read as
    declared-but-unused, never silently."""
    ex, readme, fx = real
    uses = dict(ex.env_uses)
    del uses["BSSEQ_TPU_SINGLETON"]
    pruned = copy.copy(ex)
    pruned.env_uses = uses
    report = contracts.verify(pruned, None, readme, fx)
    assert ("unused", "env:BSSEQ_TPU_SINGLETON") in _kinds(report)


# ---------------------------------------------------------------------------
# waiver semantics


def test_waiver_without_why_is_hard_error(real):
    reg = contracts.REGISTRY
    with pytest.raises(LintError, match="no why"):
        _verify(real, dataclasses.replace(reg, waivers=reg.waivers + (
            contracts.Waiver("unused", "op:fleet2", "  "),)))


def test_stale_waiver_is_hard_error(real):
    reg = contracts.REGISTRY
    with pytest.raises(LintError, match="stale contract waiver"):
        _verify(real, dataclasses.replace(reg, waivers=reg.waivers + (
            contracts.Waiver("unused", "env:BSSEQ_TPU_NOT_A_DRIFT", "excuses nothing"),)))


def test_waiver_suppresses_matching_drift(real):
    reg = contracts.REGISTRY
    report = _verify(real, dataclasses.replace(
        reg,
        events=tuple(e for e in reg.events if e.name != "spill"),
        waivers=reg.waivers + (
            contracts.Waiver("undeclared", "event:spill", "test waiver"),
            contracts.Waiver("mismatch", "event:spill", "test waiver"),
        ),
    ))
    assert report.ok, [d.format() for d in report.drifts]
    assert sum(n for _, n in report.waived) >= 3


# ---------------------------------------------------------------------------
# the gate through the CLI, with jax and the JAX package unimportable


def test_cli_contracts_gate_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['bsseqconsensusreads_tpu'] = None; "
            "from bsseqconsensusreads_tpu_torch.cli import main; "
            "sys.exit(main(['lint', '--contracts', '--json']))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True and out["drift"] == []
    for w in out["waived"]:
        assert w["why"].strip() and w["matched"] >= 1


# ---------------------------------------------------------------------------
# the knobs the port honors: the knob takes effect, the bytes do not
# change, and they equal the JAX package's under the same knob


@pytest.fixture(scope="module", autouse=True)
def _reference_natives():
    ensure_reference_natives(REPO)


@pytest.fixture(scope="module")
def molecular_env(tmp_path_factory):
    """~120 bisulfite families of 1 and 2 templates per strand (T == 1
    batches for the singleton path, T == 2 for the packed layout)."""
    tmp = tmp_path_factory.mktemp("knobs_mol")
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=20_000).astype(np.int8)
    pool = [bytes(np.random.default_rng(50 + i).choice(
        np.array([2, 12, 23, 37], np.uint8), size=90)) for i in range(8)]
    recs = stream_duplex_families(
        codes, 120, read_len=90,
        templates_for=lambda fam: 1 if fam % 3 else 2,
        qual_for=lambda fam, ti, flag: pool[(fam + ti + flag) & 7],
        bisulfite=True,
    )
    bam = str(tmp / "grouped.bam")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chr1", len(codes))])
    with BamWriter(bam, header) as w:
        w.write_all(recs)
    return {"tmp": tmp, "bam": bam}


def _jax_molecular(env, tag):
    out = str(env["tmp"] / f"jax_{tag}.bam")
    with BamReader(env["bam"]) as r:
        batches = jc.call_molecular_batches(
            r, JaxParams(min_reads=1), mode="self", grouping="coordinate",
            batch_families=32, **JROUTE)
        je.write_batch_stream(batches, out, r.header, "self", sort_engine="python")
    return out


def _port_molecular(env, tag):
    out = str(env["tmp"] / f"port_{tag}.bam")
    stats = tc.StageStats()
    with PortReader(env["bam"]) as r:
        batches = tc.call_molecular_batches(
            r, ConsensusParams(min_reads=1), mode="self", grouping="coordinate",
            batch_families=32, stats=stats, device="cpu")
        te.write_batch_stream(batches, out, r.header, "self", metrics=stats.metrics)
    return out, stats


def _spy(monkeypatch, module, name):
    calls = []
    real_fn = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real_fn(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_kernel_layout_knob(molecular_env, monkeypatch):
    base, _ = _port_molecular(molecular_env, "layout_default")
    packs = _spy(monkeypatch, tc, "pack_molecular_rows")
    monkeypatch.setenv("BSSEQ_TPU_KERNEL_LAYOUT", "padded")
    port, _ = _port_molecular(molecular_env, "layout_padded")
    jax = _jax_molecular(molecular_env, "layout_padded")
    assert packs == []  # the padded envelope: no segment-packed plan
    assert _sha(port) == _sha(base) == _sha(jax)
    monkeypatch.setenv("BSSEQ_TPU_KERNEL_LAYOUT", "sideways")
    with pytest.raises(ValueError, match="unknown kernel layout"):
        _port_molecular(molecular_env, "layout_bad")


def test_singleton_knob(molecular_env, monkeypatch):
    base, bstats = _port_molecular(molecular_env, "single_default")
    assert bstats.metrics.seconds.get("host_vote", 0) > 0
    host = _spy(monkeypatch, tc, "singleton_consensus_host")
    monkeypatch.setenv("BSSEQ_TPU_SINGLETON", "0")
    port, stats = _port_molecular(molecular_env, "single_off")
    jax = _jax_molecular(molecular_env, "single_off")
    assert host == [] and "host_vote" not in stats.metrics.seconds
    assert _sha(port) == _sha(base) == _sha(jax)


def test_bgzf_threads_knob(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    payload = bytes(rng.integers(0, 8, size=400_000, dtype=np.uint8))

    def write(module, name):
        path = str(tmp_path / name)
        w = module.NativeBgzfWriter(path)
        w.write(payload)
        w.close()
        return path, w

    default, _w = write(tnative, "default.gz")
    monkeypatch.setenv("BSSEQ_TPU_BGZF_THREADS", "1")
    assert tnative.default_threads() == 1
    one, w1 = write(tnative, "one.gz")
    jax_one, _ = write(jnative, "jax_one.gz")
    monkeypatch.setenv("BSSEQ_TPU_BGZF_THREADS", "3")
    assert tnative.default_threads() == 3
    three, w3 = write(tnative, "three.gz")
    assert (w1._mt, w3._mt) == (False, True)
    assert _sha(one) == _sha(three) == _sha(default) == _sha(jax_one)
    monkeypatch.setenv("BSSEQ_TPU_BGZF_THREADS", "many")
    assert tnative.default_threads() == min(4, os.cpu_count() or 1)


@pytest.fixture(scope="module")
def methyl_env(tmp_path_factory):
    """20 aligned duplex groups on one contig (the methyl tests' recipe)."""
    tmp = tmp_path_factory.mktemp("knobs_methyl")
    rng = np.random.default_rng(21)
    _, genome = random_genome(rng, 5000, name="chrA")
    header = BamHeader("@HD\tVN:1.6\tSO:coordinate\n", [("chrA", len(genome))])
    records = []
    for fam in range(20):
        records.extend(make_aligned_duplex_group(rng, "chrA", genome, fam, 50 + fam * 200, 60))
    records.sort(key=lambda r: (r.ref_id, r.pos))
    bam = str(tmp / "dup_in.bam")
    with BamWriter(bam, header) as w:
        w.write_all(records)
    fasta = str(tmp / "genome.fa")
    with open(fasta, "w") as fh:
        fh.write(">chrA\n" + "\n".join(genome[i:i + 60] for i in range(0, len(genome), 60)) + "\n")
    return {"tmp": tmp, "bam": bam, "fasta": fasta, "genome": genome}


def _jax_methyl(env, tag):
    store = jrs.RefStore.from_fasta(env["fasta"])
    base = str(env["tmp"] / f"jax_{tag}.bam")
    acc = jtally.MethylAccumulator(store, base + ".bedmethyl", base + ".CX_report.txt")
    with BamReader(env["bam"]) as r:
        batches = jc.call_duplex_batches(
            r, lambda n, s, e: env["genome"][s:e], ["chrA"], JaxParams(min_reads=0),
            mode="self", grouping="coordinate", batch_families=8, refstore=store,
            methyl=acc, **JROUTE)
        je.write_batch_stream(batches, base, r.header, "self", sort_engine="python")
    acc.finalize()
    return base


def _port_methyl(env, tag):
    store = trs.RefStore.from_fasta(env["fasta"])
    base = str(env["tmp"] / f"port_{tag}.bam")
    acc = ttally.MethylAccumulator(store, base + ".bedmethyl", base + ".CX_report.txt")
    with PortReader(env["bam"]) as r:
        batches = tc.call_duplex_batches(
            r, lambda n, s, e: env["genome"][s:e], ["chrA"], ConsensusParams(min_reads=0),
            mode="self", grouping="coordinate", batch_families=8, device="cpu",
            transport="unpacked", refstore=store, methyl=acc)
        te.write_batch_stream(batches, base, r.header, "self")
    acc.finalize()
    return base


def _same_outputs(a: str, b: str) -> bool:
    return all(_sha(a + ext) == _sha(b + ext) for ext in ("", ".bedmethyl", ".CX_report.txt"))


def test_methyl_engine_knob(methyl_env, monkeypatch):
    base = _port_methyl(methyl_env, "meng_default")
    host = _spy(monkeypatch, tc, "methyl_epilogue_host")
    monkeypatch.setenv("BSSEQ_TPU_METHYL_ENGINE", "host")
    port = _port_methyl(methyl_env, "meng_host")
    assert host  # the numpy twin ran on the retired batches
    jax = _jax_methyl(methyl_env, "meng_host")
    assert _same_outputs(port, base) and _same_outputs(port, jax)
    monkeypatch.setenv("BSSEQ_TPU_METHYL_ENGINE", "warp")
    with pytest.raises(ValueError, match="unknown methyl engine"):
        _port_methyl(methyl_env, "meng_bad")


def test_methyl_merge_knob(methyl_env, monkeypatch):
    base = _port_methyl(methyl_env, "merge_default")
    native = _spy(monkeypatch, twirepack, "methyl_tally_merge")
    monkeypatch.setenv("BSSEQ_TPU_METHYL_MERGE", "python")
    port = _port_methyl(methyl_env, "merge_python")
    assert native == []  # the numpy twin merged every tally
    jax = _jax_methyl(methyl_env, "merge_python")
    assert _same_outputs(port, base) and _same_outputs(port, jax)
