"""The row-level API (`explicit`, `native`) on the card against the same
calls on the CPU, where tests/test_torch_explicit.py and
tests/test_torch_native.py hold it to the reference.

Marked ``gpu``: each test skips without a CUDA card. On the GPU host run

    python -m pytest --noconftest -m gpu tests/test_torch_rows_gpu.py

The rows are float64 products in the reference's order, so they are equal
bit for bit on both devices; sums (AᵀA, the CG's dot products) differ in
order: AᵀA within 1e-12·max, the direct solve within 1e-9·max|x|, the CGs
within 1e-6·max|x| and max(2, 2%) iterations (tests/test_native.py's bar)."""

import numpy as np
import pytest
import torch

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import explicit, native

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def samples(shape, n, seed):
    rng = np.random.default_rng(seed)
    D = len(shape)
    pos = rng.uniform(-1.0, np.asarray(shape) + 0.5, size=(n, D))
    pos[0] = np.nan
    pos[1] = [min(2, s - 1) for s in shape]                      # on a node
    return pos, rng.standard_normal(n), rng.standard_normal((n, D)), rng.uniform(0.5, 1.5, n)


def assert_same_rows(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), (g.shape, w.shape)


@pytest.mark.parametrize("shape,w", [((33, 29), dict(model_0=0.1, model_1=0.2, model_2=1.0,
                                                     model_3=0.4)),
                                     ((12, 10, 9), dict(model_2=0.5, model_3=0.2)),
                                     ((50,), dict(model_1=0.3, model_2=1.0))])
def test_rows_on_the_card_equal_the_cpu(cuda, shape, w):
    pos, vals, grads, pw = samples(shape, 80, len(shape))
    W = ft.Weights(**w, data_pos=1.1, data_gradient=0.9)
    eqs = []
    for dev in (cuda, "cpu"):
        eq = explicit.assemble_explicit(ft.Grid(shape), W, pos, vals, grads, pw, device=dev)
        eq.add_equation(0.5, 2.0, [3, 3, 1], [1.0, 0.0, -2.0])
        explicit.add_value_constraint(eq, ft.Grid(shape), pos[5], 1.5, 0.7)
        explicit.add_field_constraints(eq, ft.Grid(shape), ft.Weights(model_1=0.3))
        eqs.append(eq)
    assert eqs[0].device.type == "cuda"
    assert_same_rows(eqs[0].export_rows(), eqs[1].export_rows())
    neqs = []
    for dev in (cuda, "cpu"):
        neq = native.NativeEquation(ft.Grid(shape), device=dev)
        neq.add_field_constraints(W)
        neq.add_value_constraints(pos, vals, pw)
        neq.add_gradient_constraints(pos, grads, 0.8 * pw)
        neqs.append(neq)
    assert_same_rows(neqs[0].export_rows(), neqs[1].export_rows())


def test_solves_on_the_card_match_the_cpu(cuda):
    shape = (40, 36)
    pos, vals, grads, pw = samples(shape, 120, 7)
    W = ft.Weights(model_2=0.3)
    n = 40 * 36
    res = {}
    for dev in (cuda, "cpu"):
        eq = explicit.assemble_explicit(ft.Grid(shape), W, pos, vals, grads, pw, device=dev)
        ata, atb = explicit.normal_equations(eq, n)
        neq = native.NativeEquation(ft.Grid(shape), device=dev)
        neq.add_field_constraints(W)
        neq.add_value_constraints(pos, vals, pw)
        x_n, it_n = neq.solve(tol=1e-10)
        x_s, it_s = native.sdf_from_points_native(ft.Grid(shape), W, pos[2:], grads[2:],
                                                  device=dev)
        res[str(dev)] = dict(
            ata=ata.to_dense().cpu(), atb=atb.cpu(),
            direct=explicit.solve_sparse_linear(n, eq).cpu(),
            guess=explicit.solve_sparse_linear_with_guess(n, eq, np.zeros(n)).cpu(),
            native=x_n.cpu(), it_native=it_n, sdf=x_s.cpu(), it_sdf=it_s,
            approx=explicit.solve_sparse_linear_approximate_lattice(
                ft.Grid(shape), W, pos, vals, grads, device=dev).cpu())
    g, c = res[str(cuda)], res["cpu"]
    for key, bar in [("ata", 1e-12), ("atb", 1e-12), ("direct", 1e-9), ("approx", 1e-9),
                     ("guess", 1e-6), ("native", 1e-6), ("sdf", 1e-6)]:
        err = float((g[key] - c[key]).abs().max())
        assert err <= bar * float(c[key].abs().max()), (key, err)
    for key in ("it_native", "it_sdf"):
        assert abs(g[key] - c[key]) <= max(2, 0.02 * c[key]), (key, g[key], c[key])


def test_default_device_is_the_card(cuda):
    eq = explicit.LinearEquation()
    assert eq.device == cuda
    neq = native.NativeEquation(ft.Grid((8, 8)))
    neq.add_value_constraints(np.array([[3.5, 2.5]]), [1.0], [1.0])
    assert neq.export_rows()[0].is_cuda
    x, _ = native.sdf_from_points_native(ft.Grid((8, 8)), ft.Weights(),
                                         np.array([[3.5, 3.5], [4.0, 2.5]]),
                                         np.array([[1.0, 0.0], [0.0, -1.0]]))
    assert x.is_cuda
