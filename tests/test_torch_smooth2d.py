"""The port's 2-D smoothing against the reference's large-grid smoothing
kernels (Pallas, interpret mode) on the same numpy-seeded inputs:

* `fused_smooth_2d` (ν sweeps with the 9-channel data term, the multi-sweep
  kernel's wrapper) against ``fused_smooth_striped`` (axis-0 stripes) and
  ``fused_smooth_tiled`` (tiles on both axes), from zero and from a given z,
  and against the 2-D full-data ``fused_smooth``;
* `fused_sweep` (one diagonal-data sweep) against
  ``fused_sweep_striped_diag``.

The stripes and tiles cut each grid into several blocks, so the reference's
seams and its global-edge masks are exercised. Bar: ``atol=2e-5``, the
reference tests' bar for these kernels (tests/test_solver.py:546, 578, 608).
On CPU tensors the wrappers run `fused_smooth_plain`; the kernels are held
against it on the card (tests/test_torch_kernels.py)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.constraints import data_diag
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.ops.smooth import fused_smooth_2d, fused_sweep

# (weights, ν): radius 2 with three sweeps and radius 3 with two, as far as
# the reference kernels' 8-row halo reaches (ν·ρ ≤ 8).
CASES = [(dict(model_1=0.2, model_2=1.0), 3), (dict(model_2=0.5, model_3=0.8), 2)]


def _operands(shape, weights_kw, diag=False, seed=0, n=80):
    """numpy (r, z, coeff, sid) from an assembled reference problem; coeff
    is the 9-channel data stencil or, with ``diag``, its diagonal.
    sid = 0.3/D."""
    return _assembled(shape, tuple(sorted(weights_kw.items())), diag, seed, n)


@functools.lru_cache(maxsize=None)
def _assembled(shape, weights_items, diag, seed, n):
    weights_kw = dict(weights_items)
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, 2)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    jp = jassemble(fi.Grid(shape), fi.Weights(**weights_kw), jnp.asarray(pos),
                   jnp.asarray(vals))
    coeff = data_diag(jp.coeff, 2) if diag else jp.coeff
    sid = jnp.where(jp.diag > 0, 0.3 / jp.diag, 1.0)
    r = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    return r, z, np.array(coeff, np.float32), np.array(sid, np.float32)


def _port(r, z, coeff, sid, weights_kw, nu, from_zero):
    got = fused_smooth_2d(*[torch.as_tensor(a) for a in (r, z, coeff, sid)],
                          ft.Weights(**weights_kw), nu, from_zero=from_zero)
    assert got.dtype == torch.float32 and tuple(got.shape) == r.shape
    return got.numpy()


def _check(kernel, shape, weights_kw, nu, from_zero, **tiling):
    r, z, coeff, sid = _operands(shape, weights_kw)
    want = kernel(jnp.asarray(r), jnp.asarray(z), jnp.asarray(coeff),
                  jnp.asarray(sid), fi.Weights(**weights_kw), sweeps=nu,
                  from_zero=from_zero, interpret=True, **tiling)
    got = _port(r, z, coeff, sid, weights_kw, nu, from_zero)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("weights_kw,nu", CASES, ids=["radius2", "radius3"])
def test_smooth_2d_matches_striped_kernel(weights_kw, nu, from_zero):
    _check(ps.fused_smooth_striped, (32, 96), weights_kw, nu, from_zero, stripe=8)


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("weights_kw,nu", CASES, ids=["radius2", "radius3"])
def test_smooth_2d_matches_tiled_kernel(weights_kw, nu, from_zero):
    _check(ps.fused_smooth_tiled, (16, 256), weights_kw, nu, from_zero,
           tiles=(8, 128))


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("weights_kw,nu", CASES, ids=["radius2", "radius3"])
def test_smooth_2d_matches_whole_level_kernel(weights_kw, nu, from_zero):
    r, z, coeff, sid = _operands((16, 12), weights_kw, n=40)
    want = ps.fused_smooth(jnp.asarray(r), jnp.asarray(z), jnp.asarray(coeff),
                           jnp.asarray(sid), fi.Weights(**weights_kw), 2, nu,
                           from_zero=from_zero, interpret=True)
    got = _port(r, z, coeff, sid, weights_kw, nu, from_zero)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("weights_kw", [w for w, _ in CASES], ids=["radius2", "radius3"])
def test_fused_sweep_matches_striped_diag_kernel(weights_kw):
    r, z, cdiag, sid = _operands((64, 96), weights_kw, diag=True, seed=1, n=150)
    want = ps.fused_sweep_striped_diag(jnp.asarray(r), jnp.asarray(z),
                                       jnp.asarray(cdiag), jnp.asarray(sid),
                                       fi.Weights(**weights_kw), stripe=8,
                                       interpret=True)
    got = fused_sweep(*[torch.as_tensor(a) for a in (r, z, cdiag, sid)],
                      ft.Weights(**weights_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_smooth_2d_rejects_negative_sweeps():
    r = torch.zeros((8, 6))
    with pytest.raises(ValueError, match="sweeps"):
        fused_smooth_2d(r, r, torch.zeros((9, 8, 6)), r, ft.Weights(model_2=0.3), -1)
