"""The PyTorch port stands alone: no module of ``tensorflowasr_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax, optax, orbax or the JAX
package. Checked on the source (an AST walk), since this test process has
imported JAX already. Every module also imports on a CPU-only host."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tensorflowasr_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorflowasr_tpu"}
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN & set(imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_walk_reaches_the_chunk_modules():
    assert PORT / "models" / "chunk_conformer.py" in FILES


def test_walk_reaches_the_recipes():
    assert {PORT / "recipes" / f"{name}.py" for name in (
        "synthetic_mandarin", "aishell1_prepare", "headtohead")} <= set(FILES)


def test_every_port_module_imports_without_a_card():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
