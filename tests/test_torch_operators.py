"""The port's operator and assembly against the JAX package on the same
numpy-seeded inputs: the plain `fused_normal_apply` against the reference's
Pallas kernel (interpret mode) and its `Problem.apply`, the smoothness
closed forms, and `assemble` / `assemble_precise` including NaN and
out-of-bounds samples.

Bars: the float32 operator, assembly and diagonal at
``atol = 1e-4·max(1, |want|)`` (tests/test_operator_vs_oracle.py:38-43);
the float64 rows and right-hand side at 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import stencils as jst
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import stencils as tst
from field_interpolation_tpu_torch.convert import (precise_problem_from_numpy,
                                                   problem_from_numpy)
from field_interpolation_tpu_torch.operators import assemble as tassemble
from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                       fused_normal_apply_plain)

ORDER_WEIGHTS = [
    dict(model_0=0.3, model_2=0.0),
    dict(model_1=0.7, model_2=0.0),
    dict(model_2=1.0),
    dict(model_3=0.5, model_2=0.0),
    dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4),
]
# Square, non-square, and an axis shorter than the order-3 stencil.
SHAPES = [(32, 32), (40, 48), (40, 3)]


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


def _cloud(shape, n, seed, bad=False):
    """Oriented points inside the grid; ``bad`` adds NaN, Inf and
    out-of-bounds rows that both packages must drop."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, np.asarray(shape) - 1, size=(n, 2))
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1)
    if bad:
        pos[0] = [np.nan, 1.0]
        pos[1] = [np.inf, 2.0]
        pos[2] = [-1.0, 2.0]
        pos[3] = [1.0, shape[1] + 3.0]
        pos[4] = [shape[0] - 1.0, shape[1] - 1.0]  # on the far edge: kept
    return pos.astype(np.float32), nrm.astype(np.float32)


def _problems(shape, weights_kw, seed=0, n=60):
    pos, nrm = _cloud(shape, n, seed)
    jw, tw = fi.Weights(**weights_kw), ft.Weights(**weights_kw)
    jp = jassemble(fi.Grid(shape), jw, jnp.asarray(pos), jnp.zeros(n, jnp.float32),
                   gradients=jnp.asarray(nrm))
    return jp, jw, tw


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weights_kw", ORDER_WEIGHTS)
def test_fused_apply_matches_reference_kernel(shape, weights_kw):
    jp, jw, tw = _problems(shape, weights_kw)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want_kernel = ps.fused_normal_apply(jnp.asarray(x), jp.coeff, jw, 2,
                                        interpret=True)
    want_apply = jp.apply(jnp.asarray(x))
    got = fused_normal_apply(torch.as_tensor(x),
                             torch.tensor(np.asarray(jp.coeff)), tw, 2)
    _close(got, want_kernel)
    _close(got, want_apply)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("weights_kw", ORDER_WEIGHTS)
def test_fused_apply_diag_matches_reference(shape, weights_kw):
    """The diagonal-data form every coarse level uses inside the segment."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    c = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    jw, tw = fi.Weights(**weights_kw), ft.Weights(**weights_kw)
    want = jst.smoothness_apply(jnp.asarray(x), jw, 2) + jnp.asarray(c * x)
    got = fused_normal_apply(torch.as_tensor(x), torch.as_tensor(c), tw, 2)
    _close(got, want)


@pytest.mark.parametrize("shape", [(9,), (5, 6), (2, 7), (4, 5, 3)])
@pytest.mark.parametrize("weights_kw", ORDER_WEIGHTS)
def test_smoothness_closed_forms_match_reference(shape, weights_kw):
    jw, tw = fi.Weights(**weights_kw), ft.Weights(**weights_kw)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    _close(tst.smoothness_apply(torch.as_tensor(x), tw),
           jst.smoothness_apply(jnp.asarray(x), jw))
    np.testing.assert_allclose(tst.smoothness_diag(shape, tw, torch.float64),
                               jst.smoothness_diag(shape, jw, jnp.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(tst.smoothness_row_abs_sum(shape, tw, torch.float64),
                               jst.smoothness_row_abs_sum(shape, jw, jnp.float32),
                               rtol=1e-6)
    assert tst.max_stencil_radius(tw) == jst.max_stencil_radius(jw)


CASES = ["gradients", "values", "point_weights", "nan_oob"]


def _inputs(case, shape=(24, 20), n=40):
    pos, nrm = _cloud(shape, n, seed=4, bad=case == "nan_oob")
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(n).astype(np.float32)
    grads = None if case == "values" else nrm
    pw = rng.uniform(0.2, 2.0, n).astype(np.float32) if case == "point_weights" else None
    return shape, pos, vals, grads, pw


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("case", CASES)
def test_assemble_matches_reference(case):
    shape, pos, vals, grads, pw = _inputs(case)
    w = dict(model_1=0.1, model_2=0.8, data_pos=1.3, data_gradient=0.7)
    jp = jassemble(fi.Grid(shape), fi.Weights(**w), _j(pos), _j(vals), _j(grads), _j(pw))
    tp = tassemble(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(vals), _t(grads), _t(pw))
    assert tp.coeff.dtype == torch.float32 and tuple(tp.coeff.shape) == jp.coeff.shape
    assert bool(torch.isfinite(tp.coeff).all()) and bool(torch.isfinite(tp.b).all())
    _close(tp.coeff, jp.coeff)
    _close(tp.b, jp.b)
    _close(tp.diag, jp.diag)


@pytest.mark.parametrize("case", CASES)
def test_assemble_precise_matches_reference(case):
    shape, pos, vals, grads, pw = _inputs(case)
    w = dict(model_2=0.3, data_pos=1.0, data_gradient=1.0)
    jp = fi.assemble_precise(fi.Grid(shape), fi.Weights(**w), _j(pos), _j(vals),
                             _j(grads), _j(pw))
    tp = ft.assemble_precise(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(vals),
                             _t(grads), _t(pw))
    np.testing.assert_array_equal(tp.corner_idx.numpy(), np.asarray(jp.corner_idx))
    for got, want in [(tp.rows64, jp.rows64), (tp.tw64, jp.tw64), (tp.b64, jp.b64)]:
        want = np.asarray(want)
        assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * max(1e-300, np.abs(want).max()))
    _close(tp.p32.coeff, jp.p32.coeff)
    _close(tp.p32.b, jp.p32.b)


def test_precise_residual_matches_float32_operator():
    """residual64 and apply64_delta are the float64 forms of A = S + DᵀWD:
    against the float32 problem's apply on the same field."""
    shape, pos, vals, grads, pw = _inputs("gradients")
    tp = ft.assemble_precise(ft.Grid(shape), ft.Weights(model_2=0.3), _t(pos),
                             _t(vals), _t(grads))
    x = np.random.default_rng(6).standard_normal(shape)
    ax32 = tp.p32.apply(torch.as_tensor(x, dtype=torch.float32))
    _close(tp.apply64_delta(torch.as_tensor(x)), ax32)
    _close(tp.residual64(torch.as_tensor(x)), tp.p32.b - ax32)
    _close(tp.residual64(torch.zeros(shape, dtype=torch.float64)), tp.b64)


def test_problem_from_numpy_round_trips_reference_problem():
    jp, jw, tw = _problems((32, 32), dict(model_2=0.3))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid((32, 32)), tw)
    x = np.random.default_rng(7).standard_normal((32, 32)).astype(np.float32)
    _close(tp.apply(torch.as_tensor(x)), jp.apply(jnp.asarray(x)))
    _close(fused_normal_apply_plain(torch.as_tensor(x), tp.coeff, tw, 2),
           jp.apply(jnp.asarray(x)))


def test_assemble_rejects_bad_shapes():
    g, w = ft.Grid((8, 8)), ft.Weights()
    pos = torch.zeros((3, 2))
    with pytest.raises(ValueError):
        tassemble(g, w, torch.zeros((3, 3)), torch.zeros(3))
    with pytest.raises(ValueError):
        tassemble(g, w, pos, torch.zeros(4))
    with pytest.raises(ValueError):
        tassemble(g, w, pos, torch.zeros(3), gradients=torch.zeros((3, 1)))
    with pytest.raises(ValueError):
        tassemble(g, w, pos, torch.zeros(3), point_weights=torch.zeros(2))


def test_precise_problem_from_numpy_matches_reference_residual():
    """The reference's PreciseProblem carried across: the port's native
    float64 residual64 / apply64_delta against the reference's float64
    oracle forms of the same rows, at 1e-12 relative."""
    import jax
    shape, pos, vals, grads, pw = _inputs("point_weights")
    w = dict(model_2=0.3)
    jp = fi.assemble_precise(fi.Grid(shape), fi.Weights(**w), _j(pos), _j(vals),
                             _j(grads), _j(pw))
    p32 = problem_from_numpy(jp.p32.coeff, jp.p32.b, jp.p32.diag,
                             ft.Grid(shape), ft.Weights(**w))
    tp = precise_problem_from_numpy(p32, jp.b64, jp.corner_idx, jp.rows64,
                                    jp.tw64, ft.Grid(shape), ft.Weights(**w))
    x = np.random.default_rng(8).standard_normal(shape)
    with jax.enable_x64():
        xj = jnp.asarray(x, jnp.float64)
        s = jst.smoothness_apply(xj, fi.Weights(**w), 2)
        rows = jp._rows_apply(xj)
        want_res = np.asarray(
            jnp.zeros(jp.grid.num_nodes, jnp.float64).at[jp.corner_idx].add(
                jp._row_contrib(jp.tw64 - rows)).reshape(shape) - s)
        want_apply = np.asarray(
            jnp.zeros(jp.grid.num_nodes, jnp.float64).at[jp.corner_idx].add(
                jp._row_contrib(rows)).reshape(shape) + s)
    for got, want in [(tp.residual64(torch.as_tensor(x)), want_res),
                      (tp.apply64_delta(torch.as_tensor(x)), want_apply)]:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
