"""The port's apply on 3-D grids against the reference's three apply kernels
(Pallas, interpret mode) on the same numpy-seeded inputs: the whole-array
``fused_normal_apply``, the axis-0 striped ``fused_normal_apply_striped`` and
the two-axis ``fused_normal_apply_striped2_3d``, at the shapes and tiles of
the reference's own tests (tests/test_utils_extras.py:23-33, 113-124,
157-168). The port's one apply stands in for all three.

Bar: ``atol=1e-4``, absolute, the reference tests' bar for these kernels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import stencils as jst
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply

# The slice's weights and a radius-3 set whose halo reaches three nodes
# past every stripe and tile seam.
WEIGHTS = [dict(model_2=0.3), dict(model_2=0.5, model_3=0.8)]


def _case(shape, weights_kw, n=60, seed=0):
    """(x, coeff, reference Weights, port Weights, reference Problem)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, 3)).astype(np.float32)
    grads = rng.standard_normal((n, 3)).astype(np.float32)
    jw = fi.Weights(**weights_kw)
    jp = jassemble(fi.Grid(shape), jw, jnp.asarray(pos), jnp.zeros(n, jnp.float32),
                   gradients=jnp.asarray(grads))
    x = rng.standard_normal(shape).astype(np.float32)
    return x, np.array(jp.coeff), jw, ft.Weights(**weights_kw), jp


def _port(x, coeff, tw):
    got = fused_normal_apply(torch.as_tensor(x), torch.as_tensor(coeff), tw, 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    return got.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("weights_kw", WEIGHTS)
@pytest.mark.parametrize("shape", [(8, 10, 12), (9, 5, 7)])
def test_apply_matches_whole_array_kernel(shape, weights_kw):
    x, coeff, jw, tw, jp = _case(shape, weights_kw)
    want = ps.fused_normal_apply(jnp.asarray(x), jnp.asarray(coeff), jw, 3,
                                 interpret=True)
    got = _port(x, coeff, tw)
    _close(got, want)
    _close(got, jp.apply(jnp.asarray(x)))


@pytest.mark.parametrize("weights_kw", WEIGHTS)
def test_apply_matches_striped_kernel(weights_kw):
    x, coeff, jw, tw, _ = _case((24, 16, 12), weights_kw)
    want = ps.fused_normal_apply_striped(jnp.asarray(x), jnp.asarray(coeff), jw,
                                         3, 8, interpret=True)
    _close(_port(x, coeff, tw), want)


@pytest.mark.parametrize("weights_kw", WEIGHTS)
def test_apply_matches_two_axis_kernel(weights_kw):
    x, coeff, jw, tw, _ = _case((16, 24, 20), weights_kw)
    want = ps.fused_normal_apply_striped2_3d(jnp.asarray(x), jnp.asarray(coeff),
                                             jw, (4, 8), interpret=True)
    _close(_port(x, coeff, tw), want)


@pytest.mark.parametrize("weights_kw", WEIGHTS)
@pytest.mark.parametrize("shape", [(8, 10, 12), (9, 5, 7)])
def test_apply_diag_matches_reference(shape, weights_kw):
    """The diagonal-data form of the multigrid levels and the lumped fine
    operator: S x + c·x."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    c = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    want = (jst.smoothness_apply(jnp.asarray(x), fi.Weights(**weights_kw), 3)
            + jnp.asarray(c * x))
    _close(_port(x, c, ft.Weights(**weights_kw)), want)
