"""Nothing the harness or the reference imports is ``jax`` or the JAX
package ``repro`` (top-level names compared whole: ``repro_torch`` is the
program), and the reference imports nothing of the program."""

import ast
import sys

from perfbench import harness

from .conftest import PKG


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        found = imported_top_names(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "repro_torch" not in imported_top_names(path), path


def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reproduce", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["jax", "repro.core"]


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", sys)
    rc = harness.print_result({"checks": {}})
    assert rc != 0
    assert capsys.readouterr().out == ""
