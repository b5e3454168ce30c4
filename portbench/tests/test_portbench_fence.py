"""The import fence: nothing under portbench/ imports JAX or the JAX
package (top-level names compared whole: the port's name begins with
the JAX package's), and the reference imports nothing of the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "bsseqconsensusreads_tpu"}
PORT = "bsseqconsensusreads_tpu_torch"


def sources():
    for d, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not (top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(p for p in sources()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PORT not in names
    assert names <= {"__future__", "numpy", "torch", "reference"}


def test_fence_compares_whole_names():
    assert "bsseqconsensusreads_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax_like".split(".")[0] not in FORBIDDEN


def test_run_refuses_a_loaded_jax(monkeypatch):
    """run.py's look at sys.modules once the window has closed."""
    import sys
    import types

    import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, "bsseqconsensusreads_tpu_torch_like", types.ModuleType("x"))
    assert run.loaded_forbidden() == ["jaxlib"]
