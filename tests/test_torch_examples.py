"""The port's runnable examples, on the CPU at their built-in sizes
(`slow`, like tests/test_examples.py)."""

import runpy
import sys

import pytest


def _run(path, argv=("x",)):
    old = sys.argv
    sys.argv = list(argv)
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


@pytest.mark.slow
def test_example_torch_sdf_sphere_3d(capsys):
    _run("examples/torch_sdf_sphere_3d.py", ("x", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "OK" in out and "device compact extraction" in out
