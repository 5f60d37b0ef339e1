"""Nothing under the benchmark's folder imports JAX, the JAX package
(``repro``) or the old ``benchmarks`` folder, and the reference imports
nothing of the program: checked on every file's syntax tree, by the top
level of each imported name (``repro_torch`` is not ``repro``)."""
import ast

import pytest

from conftest import BENCH

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE_MAY_IMPORT = {"__future__", "math", "typing", "torch", "numpy"}


def imported(path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & BANNED


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert imported(path) <= REFERENCE_MAY_IMPORT, path


def test_the_check_is_whole_names(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                  "import reproducible\n")
    bad = tmp_path / "bad.py"
    bad.write_text("from repro.core import engine\n")
    assert not imported(ok) & BANNED
    assert imported(bad) & BANNED == {"repro"}
