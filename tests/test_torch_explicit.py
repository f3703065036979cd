"""The port's `explicit` module against the JAX package's (NumPy/SciPy):
the rows triplet for triplet and in order, `to_sparse` against `to_scipy`,
the normal equations, the three solves, the device rule.

Inputs are made from a seed with numpy and go through both modules; the
reference's rows are the oracle, so values are held at rtol 1e-15."""

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

import field_interpolation_tpu as fi
import field_interpolation_tpu_torch as ft
from field_interpolation_tpu import explicit as ref
from field_interpolation_tpu_torch import explicit as tex
from field_interpolation_tpu_torch import rows as trows

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU ops run fastest on one thread beside the JAX runtime."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_rows(eq):
    t = eq.triplets
    return (np.array([x.row for x in t], np.int64), np.array([x.col for x in t], np.int64),
            np.array([x.value for x in t], np.float64), np.asarray(eq.rhs, np.float64))


def port_rows(eq):
    return tuple(a.numpy() for a in eq.export_rows())


def assert_rows_equal(got, want):
    assert got[0].shape == want[0].shape and got[3].shape == want[3].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-15, atol=0)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-15, atol=0)


def make_samples(rng, shape, n, gradients=True, point_weights=True):
    """Positions spread past the grid's edges, one NaN, one on a node, one
    on a cell face, one beyond the last node; a zero point weight."""
    D = len(shape)
    pos = rng.uniform(-1.0, np.asarray(shape) + 0.5, size=(n, D))
    pos[0] = np.nan
    pos[1] = [min(2, s - 1) for s in shape]                       # on a node
    pos[2] = [s - 1.0 for s in shape]                             # the last node
    pos[3, 0] = 1.0                                               # a cell face
    pos[4] = np.asarray(shape) - 0.999                            # just outside
    vals = rng.standard_normal(n)
    grads = rng.standard_normal((n, D)) if gradients else None
    pw = rng.uniform(0.5, 1.5, n) if point_weights else None
    if point_weights:
        pw[5] = 0.0
    return pos, vals, grads, pw


ROW_CASES = [
    ("1d_orders_0123", (11,), dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4,
                                   data_pos=1.1, data_gradient=0.9), True, True),
    ("1d_short_axis", (3,), dict(model_2=1.0, model_3=0.5), False, False),
    ("2d_orders_0123", (9, 7), dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4,
                                    data_pos=1.1, data_gradient=0.9), True, True),
    ("2d_model2_values_only", (12, 10), dict(model_2=0.3), False, False),
    ("2d_model1_pw", (8, 13), dict(model_1=0.7, model_2=0.0, data_pos=2.0), False, True),
    ("2d_model3_gradients", (16, 9), dict(model_2=0.0, model_3=0.8), True, False),
    ("2d_negative_weight", (6, 6), dict(model_2=-0.5, data_gradient=-1.0), True, False),
    ("3d_orders_0123", (7, 6, 5), dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4,
                                       data_pos=1.1, data_gradient=0.9), True, True),
    ("3d_model2", (9, 8, 4), dict(model_2=0.5), True, False),
    ("3d_thin_axis", (2, 6, 5), dict(model_1=0.3, model_2=1.0, model_3=0.2), True, True),
]


@pytest.mark.parametrize("name,shape,w,grads,pw", ROW_CASES, ids=[c[0] for c in ROW_CASES])
def test_assemble_rows_equal_reference(name, shape, w, grads, pw):
    rng = np.random.default_rng(len(name))
    pos, vals, g, p = make_samples(rng, shape, 40, grads, pw)
    eq_r = ref.assemble_explicit(fi.Grid(shape), fi.Weights(**w), pos, vals, g, p)
    eq_t = tex.assemble_explicit(ft.Grid(shape), ft.Weights(**w), pos, vals, g, p, device=CPU)
    assert eq_t.num_rows == eq_r.num_rows
    assert_rows_equal(port_rows(eq_t), ref_rows(eq_r))
    assert [(t.row, t.col) for t in eq_t.triplets] == [(t.row, t.col) for t in eq_r.triplets]


def test_smoothness_rows_at_64_squared():
    """The whole-lattice adder at the largest test grid, every order: the
    reference's per-row loop against one vectorized pass."""
    w = dict(model_0=0.2, model_1=0.3, model_2=1.0, model_3=0.1)
    eq_r = ref.LinearEquation()
    ref.add_field_constraints(eq_r, fi.Grid((64, 64)), fi.Weights(**w))
    eq_t = tex.LinearEquation(device=CPU)
    tex.add_field_constraints(eq_t, ft.Grid((64, 64)), ft.Weights(**w))
    assert eq_t.num_rows == 64 * 64 + 2 * 64 * (63 + 62 + 61)
    assert_rows_equal(port_rows(eq_t), ref_rows(eq_r))


def test_single_row_adders_keep_one_order():
    """Rows added one at a time (host buffer) between whole-lattice blocks
    (tensor chunks) keep the reference's global order; zero-weight rows and
    zero coefficients add nothing; float32 tensors give float64 rows."""
    rng = np.random.default_rng(3)
    shape = (7, 9)
    eqs = (ref.LinearEquation(), tex.LinearEquation(device=CPU))
    grids = (fi.Grid(shape), ft.Grid(shape))
    weights = (fi.Weights(model_2=0.6), ft.Weights(model_2=0.6))
    for step in range(12):
        pos = rng.uniform(-0.5, 8.5, 2)
        if step == 4:
            pos = np.array([3.0, 5.0])            # on a node
        if step == 7:
            pos = np.array([np.nan, 1.0])
        g, v, wt = rng.standard_normal(2), float(rng.standard_normal()), float(rng.uniform())
        pos32 = pos.astype(np.float32)
        for mod, eq, grid in zip((ref, tex), eqs, grids):
            p = pos32 if mod is ref else torch.as_tensor(pos32)
            mod.add_value_constraint(eq, grid, p, v, wt if step != 2 else 0.0)
            mod.add_gradient_constraint(eq, grid, p, g, wt)
            eq.add_equation(0.5, 1.5, [step, step + 1, 3], [1.0, 0.0, -2.0])
            eq.add_equation(0.0, 9.0, [1], [1.0])
            if step in (3, 8):
                mod.add_field_constraints(eq, grid, weights[mod is tex])
    assert eqs[1].num_rows == eqs[0].num_rows
    assert_rows_equal(port_rows(eqs[1]), ref_rows(eqs[0]))


def test_single_row_adders_equal_reference_values():
    """The same single-row sequence with float64 inputs: values equal too."""
    rng = np.random.default_rng(4)
    shape = (5, 6, 4)
    eq_r, eq_t = ref.LinearEquation(), tex.LinearEquation(device=CPU)
    gr, gt = fi.Grid(shape), ft.Grid(shape)
    for _ in range(10):
        pos = rng.uniform(-0.3, 5.3, 3)
        g, v, wt = rng.standard_normal(3), float(rng.standard_normal()), float(rng.uniform())
        ref.add_value_constraint(eq_r, gr, pos, v, wt)
        tex.add_value_constraint(eq_t, gt, pos, v, wt)
        ref.add_gradient_constraint(eq_r, gr, pos, g, wt)
        tex.add_gradient_constraint(eq_t, gt, list(pos), list(g), wt)
    ref.add_field_constraints(eq_r, gr, fi.Weights(model_1=0.2))
    tex.add_field_constraints(eq_t, gt, ft.Weights(model_1=0.2))
    assert_rows_equal(port_rows(eq_t), ref_rows(eq_r))


def test_to_sparse_equals_to_scipy():
    rng = np.random.default_rng(5)
    shape = (10, 8)
    pos, vals, g, p = make_samples(rng, shape, 30)
    eq_r = ref.assemble_explicit(fi.Grid(shape), fi.Weights(model_2=0.4), pos, vals, g, p)
    eq_t = tex.assemble_explicit(ft.Grid(shape), ft.Weights(model_2=0.4), pos, vals, g, p,
                                 device=CPU)
    for eq in (eq_r, eq_t):       # a duplicate column in one row is summed
        eq.add_equation(1.5, 2.0, [4, 4, 7], [1.0, 2.0, -1.0])
    A_r, b_r = eq_r.to_scipy(80)
    A_t, b_t = eq_t.to_sparse(80)
    assert A_t.layout == torch.sparse_csr and A_t.dtype == torch.float64
    np.testing.assert_array_equal(A_t.crow_indices().numpy(), A_r.indptr)
    np.testing.assert_array_equal(A_t.col_indices().numpy(), A_r.indices)
    np.testing.assert_allclose(A_t.values().numpy(), A_r.data, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(b_t.numpy(), b_r)


@pytest.mark.parametrize("shape,w", [((24, 20), dict(model_1=0.1, model_2=1.0, model_3=0.3)),
                                     ((10, 9, 8), dict(model_0=0.05, model_2=0.5)),
                                     ((40,), dict(model_2=0.3, model_3=0.2))])
def test_normal_equations_match_reference(shape, w):
    rng = np.random.default_rng(6)
    pos, vals, g, p = make_samples(rng, shape, 60)
    n = int(np.prod(shape))
    eq_r = ref.assemble_explicit(fi.Grid(shape), fi.Weights(**w), pos, vals, g, p)
    eq_t = tex.assemble_explicit(ft.Grid(shape), ft.Weights(**w), pos, vals, g, p, device=CPU)
    A_r, b_r = ref.normal_equations(eq_r, n)
    A_t, b_t = tex.normal_equations(eq_t, n)
    assert A_t.layout == torch.sparse_csr
    A_r = A_r.toarray()
    scale = np.abs(A_r).max()
    np.testing.assert_allclose(A_t.to_dense().numpy(), A_r, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(b_t.numpy(), b_r, rtol=0, atol=1e-12 * np.abs(b_r).max())


@pytest.mark.parametrize("shape,w,grads", [((16, 16), dict(model_1=0.1, model_2=1.0), False),
                                           ((32, 24), dict(model_2=0.3), True),
                                           ((8, 8, 8), dict(model_2=0.5, model_0=0.01), True),
                                           ((30,), dict(model_3=1.0), True)])
def test_solve_sparse_linear_matches_scipy(shape, w, grads):
    rng = np.random.default_rng(7)
    pos, vals, g, _ = make_samples(rng, shape, 50, grads, False)
    n = int(np.prod(shape))
    x_r = ref.solve_sparse_linear(n, ref.assemble_explicit(fi.Grid(shape), fi.Weights(**w),
                                                           pos, vals, g))
    x_t = tex.solve_sparse_linear(n, tex.assemble_explicit(ft.Grid(shape), ft.Weights(**w),
                                                           pos, vals, g, device=CPU))
    assert x_t.dtype == torch.float64 and x_t.shape == (n,)
    np.testing.assert_allclose(x_t.numpy(), x_r, rtol=0, atol=1e-9 * np.abs(x_r).max())


def test_direct_solve_limit_raises_before_assembling():
    eq = tex.LinearEquation(device=CPU)
    eq.add_equation(1.0, 1.0, [0], [1.0])
    with pytest.raises(ValueError, match=str(tex.DIRECT_MAX_UNKNOWNS)):
        tex.solve_sparse_linear(tex.DIRECT_MAX_UNKNOWNS + 1, eq)
    assert tex.DIRECT_MAX_UNKNOWNS == 256 * 256


def scipy_cg(A, b, x0, tol, maxiter):
    count = [0]
    x, _ = scipy.sparse.linalg.cg(A, b, x0=x0, rtol=tol, maxiter=maxiter,
                                  callback=lambda xk: count.__setitem__(0, count[0] + 1))
    return x, count[0]


@pytest.mark.parametrize("shape,w,guess", [((24, 24), dict(model_2=0.3), "zero"),
                                           ((20, 16), dict(model_1=0.2, model_2=1.0), "noisy"),
                                           ((8, 7, 6), dict(model_2=0.5), "zero")])
def test_with_guess_matches_scipy_cg(shape, w, guess):
    """x within 1e-6·max|x| of SciPy's ``cg``, iterations within
    max(2, 2%) of SciPy's; `solve_sparse_linear_with_guess` returns the
    shared CG's x."""
    rng = np.random.default_rng(8)
    pos, vals, g, p = make_samples(rng, shape, 50)
    n = int(np.prod(shape))
    eq_r = ref.assemble_explicit(fi.Grid(shape), fi.Weights(**w), pos, vals, g, p)
    eq_t = tex.assemble_explicit(ft.Grid(shape), ft.Weights(**w), pos, vals, g, p, device=CPU)
    x_direct = ref.solve_sparse_linear(n, eq_r)
    x0 = (np.zeros(n) if guess == "zero"
          else x_direct + 0.05 * np.abs(x_direct).max() * rng.standard_normal(n))
    A_r, b_r = ref.normal_equations(eq_r, n)
    x_r, it_r = scipy_cg(A_r, b_r, x0, 1e-10, 10000)
    x_t = tex.solve_sparse_linear_with_guess(n, eq_t, x0)
    np.testing.assert_allclose(x_t.numpy(), ref.solve_sparse_linear_with_guess(n, eq_r, x0),
                               rtol=0, atol=1e-6 * np.abs(x_r).max())
    A_t, b_t = tex.normal_equations(eq_t, n)
    x_c, it_t, status = trows.conjugate_gradient(A_t, b_t, torch.as_tensor(x0), tol=1e-10,
                                                 maxiter=10000, jacobi=False)
    assert status == "converged"
    assert torch.equal(x_c, x_t)
    assert abs(it_t - it_r) <= max(2, 0.02 * it_r), (it_t, it_r)


def test_with_guess_returns_x_after_maxiter_like_scipy():
    rng = np.random.default_rng(9)
    shape = (32, 32)
    pos, vals, _, _ = make_samples(rng, shape, 80, False, False)
    eq_r = ref.assemble_explicit(fi.Grid(shape), fi.Weights(model_2=0.3), pos, vals)
    eq_t = tex.assemble_explicit(ft.Grid(shape), ft.Weights(model_2=0.3), pos, vals,
                                 device=CPU)
    x0 = np.zeros(1024)
    x_r = ref.solve_sparse_linear_with_guess(1024, eq_r, x0, maxiter=7)
    x_t = tex.solve_sparse_linear_with_guess(1024, eq_t, x0, maxiter=7)
    np.testing.assert_allclose(x_t.numpy(), x_r, rtol=0, atol=1e-9 * np.abs(x_r).max())
    # b = 0: zeros at once, whatever the guess
    eq_z = tex.LinearEquation(device=CPU)
    tex.add_field_constraints(eq_z, ft.Grid((6, 6)), ft.Weights())
    assert not tex.solve_sparse_linear_with_guess(36, eq_z, np.ones(36)).any()


@pytest.mark.parametrize("shape,downscale", [((17, 13), 2), ((9, 8, 7), 2), ((21, 21), 4),
                                             ((33,), 4)])
def test_approximate_lattice_matches_reference(shape, downscale):
    rng = np.random.default_rng(10)
    D = len(shape)
    n = 25
    pos = rng.uniform(0.0, np.asarray(shape) - 1.001, size=(n, D))
    vals = rng.standard_normal(n)
    pw = rng.uniform(0.5, 1.5, n)
    for grads in (None, rng.standard_normal((n, D))):
        x_r = ref.solve_sparse_linear_approximate_lattice(
            fi.Grid(shape), fi.Weights(model_2=0.3, data_gradient=0.7), pos, vals, grads, pw,
            downscale=downscale)
        x_t = tex.solve_sparse_linear_approximate_lattice(
            ft.Grid(shape), ft.Weights(model_2=0.3, data_gradient=0.7), pos, vals, grads, pw,
            downscale=downscale, device=CPU)
        assert x_t.shape == (int(np.prod(shape)),)
        scale = max(1.0, float(np.abs(x_r).max()))
        np.testing.assert_allclose(x_t.numpy(), x_r, rtol=0, atol=1e-9 * scale)


def test_multilinear_resize_matches_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((5, 7, 3))
    got = tex._multilinear_resize(torch.as_tensor(x), (9, 13, 3)).numpy()
    np.testing.assert_allclose(got, ref._multilinear_resize(x, (9, 13, 3)), rtol=1e-15,
                               atol=1e-15)


def test_device_rule():
    """``device=`` defaults to cuda and raises without a card; ``device="cpu"``
    runs; tensors run on their own device and may not be mixed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    shape = (6, 6)
    pos = np.array([[1.5, 2.5], [3.0, 4.0]])
    vals = np.array([1.0, -1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.LinearEquation()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.assemble_explicit(ft.Grid(shape), ft.Weights(), pos, vals)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.solve_sparse_linear_approximate_lattice(ft.Grid(shape), ft.Weights(), pos, vals)
    eq = tex.assemble_explicit(ft.Grid(shape), ft.Weights(), torch.as_tensor(pos),
                               torch.as_tensor(vals))
    assert eq.device.type == "cpu"
    x = tex.solve_sparse_linear(36, eq)
    assert x.device.type == "cpu"
    with pytest.raises(ValueError):
        tex.assemble_explicit(ft.Grid(shape), ft.Weights(), torch.as_tensor(pos),
                              torch.as_tensor(vals), device="meta")


def test_public_names_of_the_reference():
    """Every public name the reference's module defines is here; its
    LinearEquation's methods too (``to_scipy`` → ``to_sparse``)."""
    defined = [k for k, v in vars(ref).items()
               if not k.startswith("_") and getattr(v, "__module__", None) == ref.__name__]
    assert defined and all(hasattr(tex, k) for k in defined), defined
    methods = {k for k in dir(ref.LinearEquation) if not k.startswith("_")} | {"triplets", "rhs"}
    methods = (methods - {"to_scipy"}) | {"to_sparse"}
    assert all(hasattr(tex.LinearEquation, k) or k in ("triplets", "rhs") for k in methods)
    eq = tex.LinearEquation(device=CPU)
    assert eq.triplets == [] and eq.rhs == [] and eq.num_rows == 0
