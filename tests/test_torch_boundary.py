"""The PyTorch port stands alone: no module of ``tensorflowasr_tpu_torch``
and not ``chip_smoke.py`` imports JAX, flax, optax, orbax or the JAX
package. Checked on the source (an AST walk), since this test process has
imported JAX already. Every module also imports on a CPU-only host, and
each part of the package imports only the parts its layer may."""

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


# The parts of the package each part may import, from the bottom up: utils;
# ops and kernels (the kernels' sweeps time the ops); models; parallel;
# train; serve, export, data and eval; cli and recipes; testing.py over all
# of them, imported by no program module. Arrows against that order are
# debts (ROADMAP.md): models -> parallel (the mesh) beside parallel ->
# models, parallel -> train (the step check), and the two single files of
# FILE_ARROWS.
LAYERS = {
    "utils": set(),
    "kernels": {"ops"},
    "ops": {"kernels", "utils"},
    "models": {"ops", "parallel", "utils"},
    "parallel": {"models", "ops", "train", "utils"},
    "train": {"models", "ops", "parallel", "utils"},
    "serve": {"kernels", "models", "ops", "utils"},
    "export": {"models", "ops"},
    "data": {"utils"},
    "eval": {"utils"},
    "cli": {"data", "eval", "export", "models", "parallel", "serve",
            "train", "utils"},
    "recipes": {"cli", "utils"},
    "testing": {"models", "serve", "train", "utils"},
}
FILE_ARROWS = {
    # make_predict_step, which the benchmark imports from train
    "train/asr_trainer.py": {"serve"},
    # a timing script on the test fixtures' model and batches
    "serve/bench_ebf_buckets.py": {"testing"},
}


def part_of(path):
    rel = path.relative_to(PORT)
    return rel.parts[0] if len(rel.parts) > 1 else rel.stem


def imported_parts(path):
    """The parts of the package that ``path`` imports (``from
    tensorflowasr_tpu_torch import testing`` is the part ``testing``)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module] if node.module != PORT.name else [
                f"{PORT.name}.{alias.name}" for alias in node.names]
        for name in names:
            parts = name.split(".")
            if parts[0] == PORT.name and len(parts) > 1:
                yield parts[1]


def test_every_part_of_the_package_has_a_layer():
    found = {part_of(p) for p in PORT.rglob("*.py")} - {"__init__"}
    assert found == set(LAYERS)


@pytest.mark.parametrize("part", sorted(LAYERS))
def test_a_part_imports_only_what_its_layer_may(part):
    for path in sorted(PORT.rglob("*.py")):
        if part_of(path) != part:
            continue
        rel = str(path.relative_to(PORT))
        allowed = LAYERS[part] | {part} | FILE_ARROWS.get(rel, set())
        bad = set(imported_parts(path)) - allowed
        assert not bad, f"{rel} imports {sorted(bad)}"
