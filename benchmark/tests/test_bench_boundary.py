"""The harness and the references load neither JAX nor the JAX package,
compared by whole top-level module names (the port's name begins with the
JAX package's); the references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tensorflowasr_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def roots(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_import(path):
    assert not FORBIDDEN & set(roots(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "tensorflowasr_tpu_torch" not in set(roots(path))


def test_loaded_modules_after_importing_everything():
    code = f"""
import sys, importlib.util
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
import benchlib.core as core
for p in sorted(core.BENCH.rglob('*.py')):
    if 'tests' in p.parts or p.name in ('run.py', 'calibrate.py'):
        continue
    core.load_module(p, 'm_' + str(abs(hash(p))))
import tensorflowasr_tpu_torch.train.asr_trainer
import tensorflowasr_tpu_torch.serve.multi_session
import tensorflowasr_tpu_torch.serve.offline_session
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "tensorflowasr_tpu_torch" in loaded
    assert not FORBIDDEN & loaded, FORBIDDEN & loaded


def test_forbidden_check_compares_whole_names(monkeypatch):
    sys.path[:0] = [str(BENCH)]
    from benchlib import core
    monkeypatch.setitem(sys.modules, "tensorflowasr_tpu_torch_x", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tensorflowasr_tpu.models", sys)
    assert core.forbidden_modules() == ["tensorflowasr_tpu"]
