"""No module of the benchmark imports JAX, Flax, the JAX package or a file
of the JAX round; the reference imports nothing of the port either.
Top-level names are compared whole: the port's name begins with the JAX
package's."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "anyfeature_vslam_tpu", "bench", "chip_smoke",
          "__graft_entry__"}


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert _imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_the_whole_name_is_compared():
    assert "anyfeature_vslam_tpu_torch" not in BANNED
    assert not _imports(HERE / "program.py") & BANNED
    assert "anyfeature_vslam_tpu_torch" in _imports(HERE / "program.py")
