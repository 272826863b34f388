"""No module of the benchmark imports JAX or the JAX package (``repro``),
top-level names compared whole; the yardstick imports nothing of the
port; the run's own check of loaded modules."""

import ast
import pathlib

import pytest

from portbench.harness import cell

HERE = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
# the yardstick: generator, arithmetic, reference, comparison, weights
YARDSTICK = ["harness/traffic.py", "harness/roofline.py", "harness/compare.py",
             "harness/stats.py", "families/dense/reference.py",
             "families/dense/weights.py", "families/dense/model.py",
             "families/dense/flops.py"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax_or_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


@pytest.mark.parametrize("name", YARDSTICK,
                         ids=lambda n: pathlib.Path(n).stem)
def test_yardstick_imports_nothing_of_the_port(name):
    path = HERE / name
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & {"repro_torch", "jax", "repro"}, tops
    assert tops <= {"__future__", "contextlib", "dataclasses", "json",
                    "math", "pathlib", "statistics", "typing", "numpy",
                    "torch", "portbench"}, tops


def test_loaded_module_check_compares_whole_names():
    assert cell.forbidden_modules(["repro_torch", "repro_torch.serving",
                                   "reprox", "numpy"]) == []
    assert cell.forbidden_modules(["repro.core", "jaxlib.xla", "flax",
                                   "torch"]) == ["flax", "jaxlib", "repro"]
