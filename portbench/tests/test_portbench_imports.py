"""The import guard: nothing the benchmark runs imports JAX or the JAX
package, and the reference imports nothing of the system under test."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deeplio_tpu"}
SYSTEM = "deeplio_tpu_torch"


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax(path):
    bad = set(imported(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert SYSTEM not in set(imported(path)), \
        f"{path} imports the system under test"


def test_names_compared_whole():
    names = list(imported(HERE / "run.py"))
    assert "deeplio_tpu" not in names
    # the system's name begins with the JAX package's: compared whole, it
    # is not forbidden
    assert SYSTEM.split(".")[0] not in FORBIDDEN
