"""What the benchmark imports, compared by whole top-level module names:
the reference imports neither JAX, the JAX package nor the port; nothing of
the benchmark imports JAX or the JAX package (``sphexample_tpu_torch``
begins with the JAX package's name and is not it)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "sphexample_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"sphexample_tpu_torch"})


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_benchmark_imports_no_jax(path):
    assert not top_level_imports(path) & JAX


def test_whole_names_are_compared(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import sphexample_tpu_torch.core\nfrom sphexample_tpu_torch import x\n"
                     "import jax.numpy\n")
    assert top_level_imports(probe) == {"sphexample_tpu_torch", "jax"}
    assert top_level_imports(probe) & JAX == {"jax"}
