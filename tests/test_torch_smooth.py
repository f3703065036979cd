"""The port's damped-Jacobi smoothing against the reference's kernels
(Pallas, interpret mode) on the same numpy-seeded inputs:

* `fused_smooth` against ``fused_smooth`` (Jacobi form): 2-D and 3-D, full
  3^D-channel and diagonal data, from zero and from a given z, ν ∈ {1, 3}
  (and the ν = 0 edge, where the from-zero step still counts as a sweep);
* `fused_sweep` against ``fused_sweep_striped2_3d`` on a grid its tiles cut
  into 2×2 blocks (tests/test_solver.py:551-578 cut to 16×16×12).

Bar: ``atol=2e-5``, absolute, the reference tests' bar for these kernels
(tests/test_solver.py:546, 578)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.constraints import data_diag
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_sweep

SHAPES = {2: (16, 12), 3: (8, 6, 10)}


def _operands(shape, weights_kw, diag, seed=0, n=40):
    """numpy (r, z, coeff, sid) from an assembled reference problem; coeff
    is the data stencil or, with ``diag``, its center plane. sid = 0.3/D."""
    rng = np.random.default_rng(seed)
    D = len(shape)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, D)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    grads = rng.standard_normal((n, D)).astype(np.float32)
    jp = jassemble(fi.Grid(shape), fi.Weights(**weights_kw), jnp.asarray(pos),
                   jnp.asarray(vals), gradients=jnp.asarray(grads))
    coeff = data_diag(jp.coeff, D) if diag else jp.coeff
    sid = jnp.where(jp.diag > 0, 0.3 / jp.diag, 1.0)
    r = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    return r, z, np.array(coeff, np.float32), np.array(sid, np.float32)


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("ndim", [2, 3])
def test_fused_smooth_matches_reference_kernel(ndim, diag, from_zero, sweeps):
    w = dict(model_1=0.2, model_2=1.0)
    r, z, coeff, sid = _operands(SHAPES[ndim], w, diag)
    want = ps.fused_smooth(jnp.asarray(r), jnp.asarray(z), jnp.asarray(coeff),
                           jnp.asarray(sid), fi.Weights(**w), ndim, sweeps,
                           from_zero=from_zero, interpret=True, diag_data=diag)
    got = fused_smooth(*_t(r, z, coeff, sid), ft.Weights(**w), ndim, sweeps,
                       from_zero=from_zero)
    assert got.dtype == torch.float32 and tuple(got.shape) == r.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("from_zero", [False, True])
def test_fused_smooth_zero_sweeps(from_zero):
    """ν = 0: the reference kernel returns z, or sid·r from zero (its first
    sweep is the from-zero step); the V-cycle guards ν = 0 itself."""
    w = dict(model_2=0.3)
    r, z, coeff, sid = _operands(SHAPES[2], w, True)
    want = ps.fused_smooth(jnp.asarray(r), jnp.asarray(z), jnp.asarray(coeff),
                           jnp.asarray(sid), fi.Weights(**w), 2, 0,
                           from_zero=from_zero, interpret=True, diag_data=True)
    got = fused_smooth(*_t(r, z, coeff, sid), ft.Weights(**w), 2, 0,
                       from_zero=from_zero)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("weights_kw", [dict(model_1=0.2, model_2=1.0),
                                        dict(model_2=0.5, model_3=0.8)])
def test_fused_sweep_matches_two_axis_kernel(weights_kw):
    r, z, cdiag, sid = _operands((16, 16, 12), weights_kw, True, seed=1)
    want = ps.fused_sweep_striped2_3d(jnp.asarray(r), jnp.asarray(z),
                                      jnp.asarray(cdiag), jnp.asarray(sid),
                                      fi.Weights(**weights_kw), tiles=(8, 8),
                                      interpret=True)
    got = fused_sweep(*_t(r, z, cdiag, sid), ft.Weights(**weights_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_fused_sweep_rejects_full_data():
    r, z, coeff, sid = _operands((6, 5, 4), dict(model_2=0.3), False)
    with pytest.raises(ValueError, match="diagonal"):
        fused_sweep(*_t(r, z, coeff, sid), ft.Weights(model_2=0.3))
