"""The sharded apply's two kernels, one block at a time, with no ranks: each
plain version against the reference kernel it replaces (Pallas, interpret
mode) on blocks cut with their halos from one global field, and the blocks'
outputs stitched against the reference's whole-grid apply.

* ``fused_normal_apply_ext`` (pallas_stencil.py:378): 2-D and 3-D, radius
  1-3, the 3^D-channel and the diagonal data term; the reference's cases
  tests/test_sharded.py:123 ((2, 4) and (8,) layouts of a 24×40 grid with
  radius-3 weights) and :396 (the diagonal form on a (2, 2) layout of 64×96).
* ``fused_normal_apply_ext_striped`` (1282): the reference's case
  tests/test_sharded.py:153 (a 2-shard row split of 64×48, T = 8).

Bars: the reference tests' own, absolute: 1e-4 for the 3^D-channel apply
(test_sharded.py:148), 2e-4 for the striped form (:185), 2e-5 for the
diagonal form (:428)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import stencils as jst
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.ops.stencil_ext import (
    fused_normal_apply_ext, fused_normal_apply_ext_plain, fused_normal_apply_ext_striped,
    _check_block, fused_normal_apply_ext_striped_plain)
from field_interpolation_tpu_torch.stencils import max_stencil_radius

RADIUS_WEIGHTS = {1: dict(model_1=0.7, model_2=0.0), 2: dict(model_2=0.3),
                  3: dict(model_1=0.2, model_2=1.0, model_3=0.3)}


def _problem(shape, weights_kw, n=60, seed=0):
    """(x, coeff) of a reference problem with value and gradient rows."""
    rng = np.random.default_rng(seed)
    nd = len(shape)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, nd)).astype(np.float32)
    jp = jassemble(fi.Grid(shape), fi.Weights(**weights_kw), jnp.asarray(pos),
                   jnp.asarray(rng.standard_normal(n), jnp.float32),
                   gradients=jnp.asarray(rng.standard_normal((n, nd)), jnp.float32))
    x = rng.standard_normal(shape).astype(np.float32)
    return x, np.asarray(jp.coeff), jp


def _blocks(shape, shards, r):
    """Per block of the layout: (slices of the block, slices of its extended
    block in the field padded by r, global start)."""
    loc = [n // s for n, s in zip(shape, shards)]
    for idx in itertools.product(*[range(s) for s in shards]):
        gs = [i * n for i, n in zip(idx, loc)]
        yield (tuple(slice(g, g + n) for g, n in zip(gs, loc)),
               tuple(slice(g, g + n + 2 * r) for g, n in zip(gs, loc)), gs)


def _ext_case(shape, shards, weights_kw, diag=False, seed=0):
    """Run the port's plain version and the reference kernel block by block;
    returns (stitched port, stitched reference, x, coeff, reference Problem)."""
    x, coeff, jp = _problem(shape, weights_kw, seed=seed)
    if diag:
        coeff = np.abs(np.random.default_rng(seed + 1).standard_normal(shape)
                       ).astype(np.float32)
    nd = len(shape)
    r = max(max_stencil_radius(ft.Weights(**weights_kw)), 1)
    xp = np.pad(x, r)
    got, want = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for blk, ext, gs in _blocks(shape, shards, r):
        c = coeff[blk] if diag else coeff[(slice(None),) + blk]
        got[blk] = fused_normal_apply_ext(
            torch.as_tensor(np.ascontiguousarray(xp[ext])),
            torch.as_tensor(np.ascontiguousarray(c)), gs, ft.Weights(**weights_kw), nd, r,
            shape).numpy()
        want[blk] = np.asarray(ps.fused_normal_apply_ext(
            jnp.asarray(xp[ext]), jnp.asarray(c), jnp.asarray(gs, jnp.int32),
            fi.Weights(**weights_kw), nd, r, shape, interpret=True, diag_data=diag))
    return got, want, x, coeff, jp


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("shape,shards", [((24, 40), (2, 4)), ((24, 40), (8, 1)),
                                          ((30, 20), (3, 2))], ids=str)
def test_ext_matches_reference_kernel_2d(shape, shards, radius):
    got, want, x, _, jp = _ext_case(shape, shards, RADIUS_WEIGHTS[radius])
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jp.apply(jnp.asarray(x))), atol=1e-4)


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("shape,shards", [((16, 16, 8), (2, 2, 2)),
                                          ((12, 10, 14), (2, 1, 2))], ids=str)
def test_ext_matches_reference_kernel_3d(shape, shards, radius):
    got, want, x, _, jp = _ext_case(shape, shards, RADIUS_WEIGHTS[radius])
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jp.apply(jnp.asarray(x))), atol=1e-4)


@pytest.mark.parametrize("shape,shards,weights_kw", [
    ((64, 96), (2, 2), dict(model_1=0.2, model_2=1.0)),  # test_sharded.py:396
    ((24, 40), (4, 2), dict(model_0=0.1, model_3=0.5)),
    ((16, 12, 20), (2, 2, 1), dict(model_2=0.4)),
], ids=str)
def test_ext_diag_matches_reference_kernel(shape, shards, weights_kw):
    got, want, x, dd, _ = _ext_case(shape, shards, weights_kw, diag=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    whole = (np.asarray(jst.smoothness_apply(jnp.asarray(x), fi.Weights(**weights_kw),
                                             len(shape))) + dd * x)
    np.testing.assert_allclose(got, whole, rtol=0, atol=2e-5)


def _striped_operands(xp, s, n0_loc, r):
    """The reference test's operands of row block s (test_sharded.py:170-178):
    the block extended along axis 1 and its two corner-filled slabs."""
    rows = slice(s * n0_loc, (s + 1) * n0_loc)
    x1 = np.pad(xp[rows], ((0, 0), (r, r)))
    W = x1.shape[1]
    top = (np.pad(xp[s * n0_loc - r:s * n0_loc], ((0, 0), (r, r)))
           if s > 0 else np.zeros((r, W), np.float32))
    bot = (np.pad(xp[(s + 1) * n0_loc:(s + 1) * n0_loc + r], ((0, 0), (r, r)))
           if (s + 1) * n0_loc < xp.shape[0] else np.zeros((r, W), np.float32))
    return rows, x1.astype(np.float32), top.astype(np.float32), bot.astype(np.float32)


@pytest.mark.parametrize("weights_kw", [dict(model_2=1.0), dict(model_2=0.4, model_3=0.3),
                                        dict(model_0=0.2, model_1=0.5)], ids=str)
@pytest.mark.parametrize("n_blocks", [2, 4])
def test_striped_matches_reference_kernel(weights_kw, n_blocks):
    """tests/test_sharded.py:153 (2 blocks), and 4 blocks whose middle ones
    read both slabs from neighbours."""
    shape = (64, 48)
    x, coeff, jp = _problem(shape, weights_kw, n=70)
    tw, jw = ft.Weights(**weights_kw), fi.Weights(**weights_kw)
    r = max(max_stencil_radius(tw), 1)
    n0_loc = shape[0] // n_blocks
    got, want = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for s in range(n_blocks):
        rows, x1, top, bot = _striped_operands(x, s, n0_loc, r)
        c = np.ascontiguousarray(coeff[:, rows])
        got[rows] = fused_normal_apply_ext_striped(
            *(torch.as_tensor(a) for a in (x1, top, bot, c)), [s * n0_loc, 0], tw, r,
            shape).numpy()
        want[rows] = np.asarray(ps.fused_normal_apply_ext_striped(
            jnp.asarray(x1), jnp.asarray(top), jnp.asarray(bot), jnp.asarray(c),
            jnp.asarray([s * n0_loc, 0], jnp.int32), jw, r, shape, 8, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jp.apply(jnp.asarray(x))), atol=2e-4)


def test_striped_plain_equals_whole_form():
    """The striped form is the whole form on the slabs stacked around the
    block; on a column block (axis 1 sharded) the axis-1 halo is neighbour
    data, not zeros."""
    shape, r = (32, 40), 2
    x, coeff, _ = _problem(shape, dict(model_2=0.3))
    tw = ft.Weights(model_2=0.3)
    xp = np.pad(x, r)
    blk = (slice(8, 24), slice(20, 40))
    ext = np.ascontiguousarray(xp[8:28, 20:44])
    c = torch.as_tensor(np.ascontiguousarray(coeff[(slice(None),) + blk]))
    whole = fused_normal_apply_ext_plain(torch.as_tensor(ext), c, [8, 20], tw, 2, r, shape)
    striped = fused_normal_apply_ext_striped_plain(
        torch.as_tensor(ext[r:-r]), torch.as_tensor(ext[:r]), torch.as_tensor(ext[-r:]),
        c, [8, 20], tw, r, shape)
    assert torch.equal(whole, striped)


def test_block_checks():
    """The checks the wrappers make before a launch (on CUDA tensors only):
    the halo must cover the operator's radius, the block must lie in the
    global grid."""
    tw = ft.Weights(model_2=0.3, model_3=0.1)
    assert _check_block("t", (6, 8), [2, 0], (8, 8), tw, 3) == (2, 0)
    with pytest.raises(ValueError, match="narrower"):
        _check_block("t", (6, 8), [0, 0], (6, 8), tw, 2)
    with pytest.raises(ValueError, match="does not lie"):
        _check_block("t", (6, 8), [4, 0], (8, 8), tw, 3)
