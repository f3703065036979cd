"""No module of the benchmark imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference, the work count and the generator import nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "field_interpolation_tpu"}
PORT = "field_interpolation_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "work.py", "traffic.py", "check.py",
                                  "control.py", "checks/sdf_residual.py", "inputs/circle.py",
                                  "metrics/segment_roofline.py"])
def test_yardstick_imports_nothing_of_the_port(name):
    assert PORT not in top_level_imports(HERE / name)


def test_names_are_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN
    assert RUN_FORBIDDEN == FORBIDDEN
