"""The import guard: nothing under ``nksbench/`` imports JAX or the JAX
package (top-level names compared whole: ``repro_torch`` starts with
``repro``), the plain reference and what feeds it import nothing of the
program, and no code names the JAX package's ``benchmarks/``."""
from __future__ import annotations

import ast

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# The reference, the control, the check, the corpora, the traffic and the
# roofline: they may not import the program under test.
PLAIN = ["harness/reference.py", "harness/corpus.py", "harness/traffic.py",
         "harness/roofline.py", "control.py", "checks", "corpora"]


def imported(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    return files


def test_no_jax_or_reference_package():
    bad = {str(p.relative_to(BENCH)): sorted(imported(p) & FORBIDDEN)
           for p in sources() if imported(p) & FORBIDDEN}
    assert bad == {}


def test_reference_imports_nothing_of_the_program():
    plain = [p for p in sources()
             if any(str(p.relative_to(BENCH)).startswith(x) for x in PLAIN)]
    assert any(p.name == "reference.py" for p in plain)
    bad = {str(p.relative_to(BENCH)) for p in plain
           if "repro_torch" in imported(p) or any(
               n.startswith("repro") for n in imported(p))}
    assert bad == set()


def test_no_code_names_the_jax_benchmarks():
    for p in sources():
        if p.parent.name == "tests":
            continue
        tree = ast.parse(p.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert not node.value.startswith("benchmarks"), p


def test_guard_catches_a_whole_name(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro.core\nfrom jax import numpy\n"
                 "import repro_torch\n")
    assert imported(f) & FORBIDDEN == {"repro", "jax"}
