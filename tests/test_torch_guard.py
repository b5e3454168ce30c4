"""The port's input guard (faults.guard, io.bam.GuardedBamReader, the
BGZF resync of io.bgzf) on the CPU against the JAX package's.

Every mutator of tools/fuzz_ingest.py (the corpus and mutators
tests/test_guard.py uses) goes through the JAX package's molecular mini
stage (`fuzz.run_once`) and the port's counterpart (`port_run_once`,
the same stage on the port) under every input policy, with the fuzz
caps lowered as in tests/test_guard.py. Tolerance: equality —

* strict: the same outcome; a typed error with the same reason;
* quarantine and lenient: the same output bytes, the same sidecar
  (`<input>.quarantined.bam`) bytes and the same guard counters;
* off: the same outcome (and bytes when both complete);
* clean input: every policy writes the same bytes in both packages.

On the tree before the port had the guard, `qual_garbage` under strict
wrote 40 consensus records where the JAX package stops with
`qual-out-of-range`; this test fails there.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

from bsseqconsensusreads_tpu.faults import guard as jguard
from bsseqconsensusreads_tpu_torch.faults import guard as pguard

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
POLICIES = ("strict", "quarantine", "lenient", "off")


def _load_fuzz():
    spec = importlib.util.spec_from_file_location(
        "fuzz_ingest", os.path.join(REPO, "tools", "fuzz_ingest.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


fuzz = _load_fuzz()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return fuzz.Corpus(str(tmp_path_factory.mktemp("torch_guard_corpus")))


@pytest.fixture(autouse=True)
def _policy_env(monkeypatch):
    monkeypatch.delenv(jguard.ENV_POLICY, raising=False)
    monkeypatch.setenv(jguard.ENV_MAX_FAMILY, str(fuzz.MAX_FAMILY_RECORDS))
    monkeypatch.setenv(jguard.ENV_MAX_READ_LEN, str(fuzz.MAX_READ_LEN))


def port_run_once(bam: str, policy: str, out_path: str, ingest: str = "auto") -> dict:
    """fuzz.run_once on the port: the molecular mini stage on the CPU
    under one explicit Guard; never raises."""
    from bsseqconsensusreads_tpu_torch.pipeline.calling import (
        StageStats,
        call_molecular_batches,
    )
    from bsseqconsensusreads_tpu_torch.pipeline.extsort import write_batch_stream
    from bsseqconsensusreads_tpu_torch.pipeline.stages import (
        molecular_ingest_stream,
        open_guarded_reader,
    )

    stats = StageStats(stage="molecular")
    g = pguard.Guard(policy=policy, stats=stats, max_family_records=fuzz.MAX_FAMILY_RECORDS,
                     max_read_len=fuzz.MAX_READ_LEN)
    res: dict = {"policy": policy}
    try:
        try:
            with open_guarded_reader(bam, g) as reader:
                batches = call_molecular_batches(
                    molecular_ingest_stream(bam, reader, stats, ingest_choice=ingest,
                                            grouping="coordinate", guard=g),
                    mode="unaligned", batch_families=8, grouping="coordinate",
                    stats=stats, guard=g, device="cpu",
                )
                write_batch_stream(batches, out_path, reader.header, "unaligned")
        finally:
            g.close()
    except pguard.GuardError as exc:
        res["outcome"] = "typed_error"
        res["reason"] = exc.reason
        return res
    except BaseException as exc:  # a crash: compared by type with the JAX run's
        res["outcome"] = "crash"
        res["error"] = type(exc).__name__
        return res
    d = stats.as_dict()
    res["outcome"] = "ok"
    res["stats"] = {k: d.get(k, 0) for k in (
        "records_seen", "records_in", "consensus_out", *fuzz.EVENT_KEYS,
    )}
    res["events"] = sum(res["stats"][k] for k in fuzz.EVENT_KEYS)
    with open(out_path, "rb") as fh:
        res["output"] = fh.read()
    return res


def _sidecar(bam: str) -> bytes | None:
    path = bam + ".quarantined.bam"
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        data = fh.read()
    os.remove(path)
    return data


def _both(bam: str, policy: str, wd: str) -> tuple[dict, dict]:
    _sidecar(bam)
    j = fuzz.run_once(bam, policy, os.path.join(wd, f"j_{policy}.bam"))
    j["sidecar"] = _sidecar(bam)
    if j["outcome"] == "crash":
        j["error"] = j["error"].split(":")[0]
    p = port_run_once(bam, policy, os.path.join(wd, f"p_{policy}.bam"))
    p["sidecar"] = _sidecar(bam)
    return j, p


@pytest.mark.parametrize("policy", POLICIES)
def test_clean_input_same_bytes_every_policy(corpus, tmp_path, policy):
    j, p = _both(corpus.golden, policy, str(tmp_path))
    assert j["outcome"] == p["outcome"] == "ok"
    assert p["output"] == j["output"]
    assert p["stats"] == j["stats"]
    assert p["sidecar"] is None and j["sidecar"] is None


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", range(len(fuzz.MUTATORS)),
                         ids=[name for name, _ in fuzz.MUTATORS])
def test_mutated_input_matches_the_jax_package(corpus, tmp_path, seed, policy):
    name, path = fuzz.mutate(corpus, seed)
    j, p = _both(path, policy, str(tmp_path))
    assert p["outcome"] == j["outcome"], (name, policy, j, p.get("reason"), p.get("error"))
    if j["outcome"] == "typed_error":
        assert p["reason"] == j["reason"], (name, policy)
    elif j["outcome"] == "crash":
        assert p["error"] == j["error"], (name, policy)
    else:
        assert p["output"] == j["output"], (name, policy)
        assert p["stats"] == j["stats"], (name, policy)
    assert p["sidecar"] == j["sidecar"], (name, policy)


def test_qual_garbage_strict_is_refused(corpus, tmp_path):
    """The fault this slice repairs: strict refuses a qual above 93."""
    seed = [n for n, _ in fuzz.MUTATORS].index("qual_garbage")
    _name, path = fuzz.mutate(corpus, seed)
    p = port_run_once(path, "strict", str(tmp_path / "p.bam"))
    assert p["outcome"] == "typed_error"
    assert p["reason"] == "qual-out-of-range"


@pytest.mark.parametrize("mutator,reason", [("qual_garbage", "qual-out-of-range"),
                                            ("tag_delete_mi", "missing-mi")])
def test_cli_strict_exits_3_with_one_line(corpus, tmp_path, mutator, reason):
    """The CLI on bad input under strict: exit 3 and one `input error
    [<reason>]` line, no traceback — as the JAX CLI."""
    seed = [n for n, _ in fuzz.MUTATORS].index(mutator)
    _name, path = fuzz.mutate(corpus, seed)
    env = dict(os.environ, BSSEQ_TPU_INPUT_POLICY="strict")
    proc = subprocess.run(
        [sys.executable, "-m", "bsseqconsensusreads_tpu_torch", "molecular", "-i", path,
         "-o", str(tmp_path / "o.bam"), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 3, proc.stderr
    assert "Traceback" not in proc.stderr
    lines = [ln for ln in proc.stderr.splitlines() if "input error" in ln]
    assert len(lines) == 1 and f"input error [{reason}]" in lines[0]


def test_resolve_policy_and_caps_match_the_jax_package(monkeypatch):
    monkeypatch.delenv(jguard.ENV_MAX_FAMILY)
    monkeypatch.delenv(jguard.ENV_MAX_READ_LEN)
    for mod in (jguard, pguard):
        assert mod.resolve_policy() == "strict"
        g = mod.Guard()
        assert (g.max_family_records, g.max_read_len) == (1 << 20, 1 << 16)
        with pytest.raises(ValueError, match="unknown BSSEQ_TPU_INPUT_POLICY"):
            mod.resolve_policy("qurantine")
    assert pguard.TAG_MALFORMED == jguard.TAG_MALFORMED
    assert pguard.QUAL_MAX == jguard.QUAL_MAX == 93
