"""The port's `native` module against the JAX package's C++ engine
(``native/field_interpolation.cpp`` through ``field_interpolation_tpu.native``)
and its NumPy/SciPy oracle: the rows of ``export_rows`` row for row, the
Jacobi-PCG's solutions and iteration counts, the one-call SDF and the
approximate lattice. The cases mirror tests/test_native.py; comparisons
with the C++ engine skip only where it is unavailable, as there."""

import numpy as np
import pytest
import scipy.sparse
import torch

import field_interpolation_tpu as fi
import field_interpolation_tpu_torch as ft
from field_interpolation_tpu import explicit as ref_explicit
from field_interpolation_tpu import native as ref_native
from field_interpolation_tpu_torch import explicit as tex
from field_interpolation_tpu_torch import native as tna
from field_interpolation_tpu_torch import rows as trows

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU ops run fastest on one thread beside the JAX runtime."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cpp():
    """The reference's C++ engine, or a skip where it cannot be built."""
    if not ref_native.is_available():
        pytest.skip("no C++ toolchain for the reference's native engine")
    return ref_native


def both(grid_shape, weights, pos, vals=None, vw=None, grads=None, gw=None, cpp_mod=None):
    """The same adder calls on the C++ engine and the port's."""
    eqs = []
    for mod, Grid, Weights in ((cpp_mod, fi.Grid, fi.Weights), (tna, ft.Grid, ft.Weights)):
        eq = (mod.NativeEquation(Grid(grid_shape)) if mod is cpp_mod
              else tna.NativeEquation(Grid(grid_shape), device=CPU))
        eq.add_field_constraints(Weights(**weights))
        if vals is not None:
            eq.add_value_constraints(pos, vals, vw)
        if grads is not None:
            eq.add_gradient_constraints(pos, grads, gw)
        eqs.append(eq)
    return eqs


def assert_export_equal(eq_t, eq_c):
    got = [a.numpy() for a in eq_t.export_rows()]
    want = eq_c.export_rows()
    assert (eq_t.num_rows, eq_t.nnz) == (eq_c.num_rows, eq_c.nnz)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-15, atol=0)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-15, atol=0)


def test_rows_equal_cpp_export(rng, cpp):
    """tests/test_native.py::test_rows_match_python_oracle's system: the
    port's rows equal the C++ engine's exported rows in order."""
    weights = dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4)
    pos = rng.uniform(0, 4, size=(20, 2))
    pos[3] = [2.0, 1.0]                                  # on a node
    vals = rng.standard_normal(20)
    grads = rng.standard_normal((20, 2))
    pw = rng.uniform(0.5, 1.5, size=20)
    eq_c, eq_t = both((6, 5), weights, pos, vals, 1.1 * pw, grads, 0.9 * pw, cpp)
    for eq in (eq_c, eq_t):
        eq.add_equation(0.7, -1.0, [3, 3, 0, 9], [1.0, 0.0, 2.0, -0.5])
        eq.add_equation(0.0, 5.0, [1], [1.0])
    assert_export_equal(eq_t, eq_c)


def test_rows_match_python_oracle(rng):
    """Value rows then gradient rows (the engine's batched order) against
    the oracle's interleaved rows: equal normal equations, equal row count."""
    grid = (6, 5)
    weights = dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4, data_pos=1.1,
                   data_gradient=0.9)
    pos = rng.uniform(0, 4, size=(20, 2))
    vals = rng.standard_normal(20)
    grads = rng.standard_normal((20, 2))
    pw = rng.uniform(0.5, 1.5, size=20)
    eq = ref_explicit.assemble_explicit(fi.Grid(grid), fi.Weights(**weights), pos, vals,
                                        grads, pw)
    A_py, b_py = eq.to_scipy(30)
    A_py = A_py.toarray()
    neq = tna.NativeEquation(ft.Grid(grid), device=CPU)
    neq.add_field_constraints(ft.Weights(**weights))
    neq.add_value_constraints(pos, vals, 1.1 * pw)
    neq.add_gradient_constraints(pos, grads, 0.9 * pw)
    r, c, v, b = (a.numpy() for a in neq.export_rows())
    A_n = scipy.sparse.csr_matrix((v, (r, c)), shape=(neq.num_rows, 30)).toarray()
    assert A_n.shape == A_py.shape
    np.testing.assert_allclose(A_n.T @ A_n, A_py.T @ A_py, atol=1e-10)
    np.testing.assert_allclose(A_n.T @ b, A_py.T @ b_py, atol=1e-10)


def test_native_solve_matches_scipy_and_cpp(rng, cpp):
    grid = (16, 16)
    weights = dict(model_1=0.1, model_2=1.0)
    pos = rng.uniform(0, 15, size=(50, 2))
    vals = rng.standard_normal(50)
    eq = ref_explicit.assemble_explicit(fi.Grid(grid), fi.Weights(**weights), pos, vals)
    x_scipy = ref_explicit.solve_sparse_linear(256, eq)
    eq_c, eq_t = both(grid, weights, pos, vals, np.ones(50), cpp_mod=cpp)
    x_c, it_c = eq_c.solve(tol=1e-12)
    x_t, it_t = eq_t.solve(tol=1e-12)
    assert it_t > 0 and x_t.shape == grid and x_t.dtype == torch.float64
    np.testing.assert_allclose(x_t.numpy().ravel(), x_scipy,
                               atol=1e-6 * np.abs(x_scipy).max())
    np.testing.assert_allclose(x_t.numpy(), x_c, atol=1e-6 * np.abs(x_c).max())
    assert abs(it_t - it_c) <= max(2, 0.02 * it_c), (it_t, it_c)


@pytest.mark.parametrize("shape,npts", [((24, 24), 80), ((64, 64), 250)])
def test_native_sdf_one_call(rng, cpp, shape, npts):
    theta = rng.uniform(0, 2 * np.pi, npts)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1)
    c = (shape[0] - 1) / 2
    pts = c + (7.0 / 24.0) * shape[0] * nrm
    x_c, it_c = cpp.sdf_from_points_native(fi.Grid(shape), fi.Weights(model_2=0.3), pts, nrm)
    x_t, it_t = tna.sdf_from_points_native(ft.Grid(shape), ft.Weights(model_2=0.3), pts, nrm,
                                           device=CPU)
    assert it_t > 0
    np.testing.assert_allclose(x_t.numpy(), x_c, atol=1e-6 * np.abs(x_c).max())
    assert abs(it_t - it_c) <= max(2, 0.02 * it_c), (it_t, it_c)
    row = x_t.numpy()[shape[0] // 2]
    assert np.sum(np.diff(np.sign(row)) != 0) == 2          # the circle, twice


def test_native_sdf_rows_interleave_per_point(rng):
    """`sdf_from_points_native`'s system is ``assemble_explicit``'s with value
    0 (value row, then gradient rows, point by point): the same solution
    as the explicit direct solve, with point weights."""
    shape = (20, 18)
    theta = rng.uniform(0, 2 * np.pi, 60)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1)
    pts = np.array([9.5, 8.5]) + 6.0 * nrm
    pw = rng.uniform(0.5, 1.5, 60)
    w = ft.Weights(model_2=0.3, data_pos=1.3, data_gradient=0.8)
    x_t, _ = tna.sdf_from_points_native(ft.Grid(shape), w, torch.as_tensor(pts),
                                        torch.as_tensor(nrm), torch.as_tensor(pw), tol=1e-13)
    eq = tex.assemble_explicit(ft.Grid(shape), w, pts, np.zeros(60), nrm, pw, device=CPU)
    x_d = tex.solve_sparse_linear(360, eq)
    np.testing.assert_allclose(x_t.numpy().ravel(), x_d.numpy(),
                               atol=1e-6 * float(x_d.abs().max()))


def test_native_3d_and_warm_start(rng, cpp):
    grid = (8, 8, 8)
    pos = rng.uniform(0, 7, size=(30, 3))
    vals = rng.standard_normal(30)
    eq_c, eq_t = both(grid, dict(model_2=0.5), pos, vals, np.ones(30), cpp_mod=cpp)
    x, it_cold = eq_t.solve(tol=1e-10)
    x2, it_warm = eq_t.solve(tol=1e-10, x0=x.ravel())
    assert it_warm < it_cold
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=1e-8 * float(x.abs().max()))
    xc, it_c = eq_c.solve(tol=1e-10)
    assert abs(it_cold - it_c) <= max(2, 0.02 * it_c), (it_cold, it_c)
    np.testing.assert_allclose(x.numpy(), xc, atol=1e-6 * np.abs(xc).max())


def test_native_out_of_bounds_dropped():
    neq = tna.NativeEquation(ft.Grid((10, 10)), device=CPU)
    neq.add_value_constraints(np.array([[5.0, 5.0], [-1.0, 5.0], [5.0, 99.0], [np.nan, 1.0]]),
                              np.ones(4), np.ones(4))
    assert neq.num_rows == 1
    assert neq.nnz == 1                                   # on a node: one corner


def test_randomized_native_matches_cpp(rng, cpp):
    """tests/test_native.py's random-config sweep, row for row against the
    C++ engine's export (1-D to 3-D, every order, gradients, point weights,
    samples out of bounds)."""
    for trial in range(10):
        D = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(4, 9)) for _ in range(D))
        weights = dict(
            model_0=float(rng.uniform(0, 0.5)) * int(rng.integers(0, 2)),
            model_1=float(rng.uniform(0, 1.0)) * int(rng.integers(0, 2)),
            model_2=float(rng.uniform(0, 1.5)) * int(rng.integers(0, 2)),
            model_3=float(rng.uniform(0, 0.5)) * int(rng.integers(0, 2)),
        )
        n = int(rng.integers(4, 20))
        pos = rng.uniform(-1.0, np.asarray(shape) + 0.5, size=(n, D))
        vals = rng.standard_normal(n)
        grads = rng.standard_normal((n, D)) if rng.integers(0, 2) else None
        pw = rng.uniform(0.5, 1.5, n) if rng.integers(0, 2) else np.ones(n)
        eq_c, eq_t = both(shape, weights, pos, vals, 1.3 * pw, grads, 0.6 * pw, cpp)
        assert_export_equal(eq_t, eq_c)


@pytest.mark.parametrize("shape,downscale", [((17, 13), 2), ((9, 8, 7), 2), ((21, 21), 4)])
def test_native_approximate_lattice_matches_cpp(rng, cpp, shape, downscale):
    """The approximate lattice against the C++ engine's (same Jacobi-PCG,
    tol 1e-12) within 1e-9, and against the port's explicit one (a direct
    solve) within the reference test's 2e-6."""
    D = len(shape)
    n = 25
    pos = rng.uniform(0.0, np.asarray(shape) - 1.001, size=(n, D))
    vals = rng.standard_normal(n)
    for grads in (None, rng.standard_normal((n, D))):
        x_c, it_c = cpp.solve_approximate_lattice_native(
            fi.Grid(shape), fi.Weights(model_2=0.3, data_gradient=0.7), pos, vals, grads,
            downscale=downscale, tol=1e-12)
        x_t, it_t = tna.solve_approximate_lattice_native(
            ft.Grid(shape), ft.Weights(model_2=0.3, data_gradient=0.7), pos, vals, grads,
            downscale=downscale, tol=1e-12, device=CPU)
        assert x_t.shape == shape
        scale = max(1.0, float(np.abs(x_c).max()))
        np.testing.assert_allclose(x_t.numpy(), x_c, rtol=0, atol=1e-9 * scale)
        assert abs(it_t - it_c) <= max(2, 0.02 * it_c), (it_t, it_c)
        x_e = tex.solve_sparse_linear_approximate_lattice(
            ft.Grid(shape), ft.Weights(model_2=0.3, data_gradient=0.7), pos, vals, grads,
            downscale=downscale, device=CPU)
        np.testing.assert_allclose(x_t.numpy().ravel(), x_e.numpy(), rtol=0,
                                   atol=2e-6 * scale)


def test_pcg_rules(monkeypatch):
    """pcg_solve's rules: b = 0 gives zeros at 0 iterations; running out of
    iterations raises; pᵀAp ≤ 0 is a breakdown; the count and x do not
    depend on how often the host reads the flags."""
    eq = tna.NativeEquation(ft.Grid((6, 6)), device=CPU)
    eq.add_field_constraints(ft.Weights(model_1=0.3))
    x, it = eq.solve(x0=np.ones(36))
    assert it == 0 and not x.any()
    eq.add_value_constraints(np.array([[2.5, 3.5], [1.0, 4.2]]), [1.0, -2.0], [1.0, 1.0])
    with pytest.raises(RuntimeError, match="did not converge"):
        eq.solve(tol=1e-12, maxiter=3)
    lone = tna.NativeEquation(ft.Grid((6, 6)), device=CPU)    # 32 columns untouched:
    lone.add_value_constraints(np.array([[2.5, 3.5]]), [2.0], [1.0])   # diagonal 0 there
    x, it = lone.solve()
    assert it == 1 and bool(torch.isfinite(x).all()) and (x != 0).sum() == 4
    np.testing.assert_allclose(float(x[2:4, 3:5].sum() / 4), 2.0, rtol=1e-12)
    a = torch.tensor([[1.0, 0.0], [0.0, -1.0]], dtype=torch.float64).to_sparse_csr()
    b = torch.ones(2, dtype=torch.float64)
    assert trows.conjugate_gradient(a, b, None, tol=1e-10, maxiter=10, jacobi=True)[2] == \
        "breakdown"
    A, B = trows.normal_equations(trows.Rows(*eq.export_rows()), 36)
    runs = []
    for k in (1, 7, 32, 1000):
        monkeypatch.setattr(trows, "CHECK_EVERY", k)
        runs.append(trows.conjugate_gradient(A, B, None, tol=1e-9, maxiter=500, jacobi=True))
    assert all(r[1] == runs[0][1] and r[2] == "converged" for r in runs)
    assert all(torch.equal(r[0], runs[0][0]) for r in runs)


def test_device_rule_and_availability():
    assert tna.is_available() is True
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tna.NativeEquation(ft.Grid((4, 4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tna.sdf_from_points_native(ft.Grid((8, 8)), ft.Weights(), np.array([[3.5, 3.5]]),
                                   np.array([[1.0, 0.0]]))
    x, it = tna.sdf_from_points_native(ft.Grid((8, 8)), ft.Weights(),
                                       torch.tensor([[3.5, 3.5], [4.0, 2.5]]),
                                       torch.tensor([[1.0, 0.0], [0.0, -1.0]]))
    assert x.device.type == "cpu" and it > 0
    eq = tna.NativeEquation(ft.Grid((4, 4)), device=CPU)
    with pytest.raises(ValueError):
        eq.add_value_constraints(torch.zeros(1, 2, device="meta"), [1.0], [1.0])


def test_public_names_of_the_reference():
    defined = [k for k, v in vars(ref_native).items()
               if not k.startswith("_") and getattr(v, "__module__", None) == ref_native.__name__]
    assert defined and all(hasattr(tna, k) for k in defined), defined
    methods = [k for k in dir(ref_native.NativeEquation) if not k.startswith("_")]
    assert all(hasattr(tna.NativeEquation, k) for k in methods), methods
