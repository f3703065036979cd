"""The port stands alone: it imports without JAX (and without triton, nvcc
or a card), no file of it imports JAX or the JAX package, and on CPU
tensors no kernel is launched: the wrappers run their plain versions."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve
from field_interpolation_tpu_torch.ops.smooth import fused_smooth
from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "field_interpolation_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PACKAGE.rglob("*.py"))

BLOCK_JAX = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton", "field_interpolation_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def test_port_imports_with_jax_blocked():
    code = BLOCK_JAX + "".join(f"import {m}\n" for m in MODULES) + (
        "assert not any(m.split('.')[0] in ('jax', 'triton') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_parallel_imports_without_jax_or_a_card():
    """The sharded entry points import with JAX and Triton blocked, and the
    import touches no CUDA device."""
    code = BLOCK_JAX + (
        "import torch\n"
        "from field_interpolation_tpu_torch.parallel import (Mesh, shard_problem,\n"
        "    solve_refined_sharded, solve_sharded)\n"
        "from field_interpolation_tpu_torch.parallel import cases, launch\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(m.split('.')[0] in ('jax', 'triton') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tooling_imports_without_jax_or_a_card():
    """Contouring (host, device, sharded), debug mode and the tooling
    modules import with JAX and Triton blocked, touching no CUDA device."""
    code = BLOCK_JAX + (
        "import torch\n"
        "from field_interpolation_tpu_torch import (checkpoint, contour, debugging,\n"
        "    visualize)\n"
        "from field_interpolation_tpu_torch.operators import validate_problem\n"
        "from field_interpolation_tpu_torch.parallel import contour as pcontour\n"
        "from field_interpolation_tpu_torch.utils import op_cost, record_solve\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(m.split('.')[0] in ('jax', 'triton') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_reference(path):
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|field_interpolation_tpu)\b(?!_torch)",
                     re.M)
    assert not pat.search(path.read_text()), path


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_no_example_imports_jax_or_the_reference(path):
    """The port's examples import the port only: no JAX, no JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|field_interpolation_tpu)\b(?!_torch)",
                     re.M)
    assert not pat.search(path.read_text()), path


def test_examples_load_with_jax_blocked():
    """Every port example loads with JAX, Triton and the JAX package blocked,
    touching no CUDA device."""
    assert len(EXAMPLES) >= 6
    code = BLOCK_JAX + (
        "import importlib.util, torch\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(m.split('.')[0] in ('jax', 'triton', 'field_interpolation_tpu')\n"
        "               for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_row_api_loads_no_native_library():
    """`explicit` and `native` run on the port's own engine: with JAX and the
    JAX package blocked they build and solve rows, and no shared library of
    the reference's `native/` is loaded into the process."""
    code = BLOCK_JAX + (
        "import numpy as np, torch\n"
        "import field_interpolation_tpu_torch as ft\n"
        "from field_interpolation_tpu_torch import explicit, native\n"
        "x, it = native.sdf_from_points_native(ft.Grid((12, 12)), ft.Weights(),\n"
        "    np.array([[5.5, 5.0], [6.0, 7.5]]), np.array([[1.0, 0.0], [0.0, 1.0]]),\n"
        "    device='cpu')\n"
        "eq = explicit.assemble_explicit(ft.Grid((6, 6)), ft.Weights(),\n"
        "    np.array([[2.5, 3.0]]), np.array([1.0]), device='cpu')\n"
        "y = explicit.solve_sparse_linear(36, eq)\n"
        "assert it > 0 and bool(torch.isfinite(x).all()) and bool(torch.isfinite(y).all())\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'field_interpolation_native' not in maps\n"
        "assert not any(m.split('.')[0] in ('jax', 'field_interpolation_tpu') for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    for path in PACKAGE.rglob("*.py"):
        assert "libfield_interpolation_native" not in path.read_text(), path


def test_launch_counters_stay_zero_on_cpu():
    fused_normal_apply.launches = 0
    fused_pcg_solve.launches = 0
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, 60)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    pts = (15.5 + 9.0 * nrm).astype(np.float32)
    x, info = ft.sdf_from_points_precise(ft.Grid((32, 32)), ft.Weights(model_2=0.3),
                                         torch.as_tensor(pts), torch.as_tensor(nrm))
    assert bool(info.converged)
    assert fused_normal_apply.launches == 0
    assert fused_pcg_solve.launches == 0


def test_sweep_counters_stay_zero_on_cpu():
    """A 3-D solve on CPU tensors goes through the apply and smoothing
    wrappers (the kernel route) and launches nothing."""
    for wrapper in (fused_normal_apply, fused_smooth):
        wrapper.launches = 0
    rng = np.random.default_rng(0)
    u = rng.standard_normal((200, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    x, info = ft.sdf_from_points(
        ft.Grid((20, 20, 20)), ft.Weights(model_2=0.3),
        torch.as_tensor(9.5 + 6.0 * u, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32),
        config=ft.SolverConfig(tol=1e-4, mg_fine_operator="lumped"))
    assert bool(info.converged)
    assert (fused_normal_apply.launches, fused_smooth.launches) == (0, 0)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result when CUDA is
    unavailable, here and in a directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in [(ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)]:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
