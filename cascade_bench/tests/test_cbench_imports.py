"""Nothing the harness or the reference loads is JAX or the JAX package;
the reference loads nothing of the program either. Top-level module names
are compared whole: ``repro_torch`` is the program, ``repro`` the JAX
package."""
import ast
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "repro"}

PROBE = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import {module}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def loaded(module):
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT), module=module)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", ["cascade_bench.harness",
                                    "cascade_bench.run"])
def test_harness_loads_no_jax(module):
    assert not loaded(module) & JAX


def test_reference_loads_nothing_of_the_program():
    assert not loaded("cascade_bench.reference") & (JAX | {"repro_torch"})


def test_run_flags_a_jax_module(monkeypatch):
    sys.path.insert(0, str(HERE))
    from cascade_bench import run
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.core")
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in run.forbidden_modules()


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    forbidden = JAX if "tests" not in path.parts else {"jax", "jaxlib",
                                                       "flax"}
    assert not names & forbidden
