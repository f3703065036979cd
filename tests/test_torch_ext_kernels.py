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
* ``ExtLevel`` (the form the sharded solve launches: the block and its halo
  slabs as the exchange delivers them, None past the global grid) against
  the reference's kernel on the same extended block, in every mode: the
  apply, and r − A z, the Jacobi sweep and the Chebyshev step computed from
  the reference kernel's output with the reference cycle's own expressions
  in jnp (field_interpolation_tpu/parallel/sharded.py:632-640, 720); an
  interior block of a 3 x 3 layout (every slab a neighbour's) and a corner
  block (slabs past the global edge).

Bars: the reference tests' own, absolute: 1e-4 for the 3^D-channel apply
(test_sharded.py:148), 2e-4 for the striped form (:185), 2e-5 for the
diagonal form (:428); the modes at their form's bar (each mode scales A z
by at most 1)."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu import stencils as jst
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.ops.stencil_ext import (
    ExtLevel, extend_with_slabs, fused_normal_apply_ext, fused_normal_apply_ext_plain,
    fused_normal_apply_ext_striped, _check_block,
    fused_normal_apply_ext_striped_plain, slab_shapes)
from field_interpolation_tpu_torch.parallel.cases import Cloud, sharded_precond
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


# ---- the slab-operand form and the modes (ExtLevel) ------------------------

# (grid, layout, block index, form): 16 x 15 and 8 x 8 x 12 blocks; form
# "whole" (3^D channels), "diag" or "striped" (2-D, 9 channels, stripe 8 on
# the reference).
SLAB_CASES = [((48, 45), (3, 3), (1, 1), "whole"), ((48, 45), (3, 3), (0, 2), "whole"),
              ((48, 45), (3, 3), (1, 1), "diag"), ((48, 45), (3, 3), (2, 0), "diag"),
              ((48, 45), (3, 3), (1, 1), "striped"), ((48, 45), (3, 3), (0, 2), "striped"),
              ((24, 24, 12), (3, 3, 1), (1, 1, 0), "whole"),
              ((24, 24, 12), (3, 3, 1), (0, 2, 0), "whole"),
              ((24, 24, 12), (3, 3, 1), (1, 1, 0), "diag"),
              ((24, 24, 12), (3, 3, 1), (2, 0, 0), "diag")]
MODE_CASES = [c for c in SLAB_CASES if c[2] in ((1, 1), (1, 1, 0))]
BARS = {"whole": 1e-4, "diag": 2e-5, "striped": 2e-4}


def _case_id(case):
    shape, _, idx, form = case
    return f"{'x'.join(map(str, shape))}-block{''.join(map(str, idx))}-{form}"


@functools.cache
def _slab_case(case, radius):
    """(z, slabs, coeff, global start, order, reference A z) of one block:
    the slabs cut from the zero-padded field in exchange order (None where a
    slab lies past the global grid), the reference's kernel on the extended
    block."""
    shape, layout, idx, form = case
    kw = RADIUS_WEIGHTS[radius]
    nd, r = len(shape), radius
    x, coeff, _ = _problem(shape, kw, seed=radius)
    loc = [n // s for n, s in zip(shape, layout)]
    gs = [i * n for i, n in zip(idx, loc)]
    blk = tuple(slice(g, g + n) for g, n in zip(gs, loc))
    if form == "diag":
        c = np.abs(np.random.default_rng(radius).standard_normal(shape)).astype(np.float32)[blk]
    else:
        c = coeff[(slice(None),) + blk]
    c = np.ascontiguousarray(c)
    X = np.pad(x, r)[tuple(slice(g, g + n + 2 * r) for g, n in zip(gs, loc))]
    order = (1, 0) if form == "striped" else tuple(range(nd))
    slabs = []
    for k, axis in enumerate(order):
        pair = []
        for low in (True, False):
            sl = [slice(None) if d in order[:k] else slice(r, r + loc[d]) for d in range(nd)]
            sl[axis] = slice(0, r) if low else slice(r + loc[axis], 2 * r + loc[axis])
            past = gs[axis] == 0 if low else gs[axis] + loc[axis] == shape[axis]
            pair.append(None if past else torch.as_tensor(np.ascontiguousarray(X[tuple(sl)])))
        slabs.append(tuple(pair))
    jw = fi.Weights(**kw)
    g32 = jnp.asarray(gs, jnp.int32)
    if form == "striped":
        want = ps.fused_normal_apply_ext_striped(
            jnp.asarray(X[r:-r]), jnp.asarray(X[:r]), jnp.asarray(X[-r:]), jnp.asarray(c),
            g32, jw, r, shape, 8, interpret=True)
    else:
        want = ps.fused_normal_apply_ext(jnp.asarray(X), jnp.asarray(c), g32, jw, nd, r,
                                         shape, interpret=True, diag_data=form == "diag")
    z = torch.as_tensor(np.ascontiguousarray(X[tuple(slice(r, r + n) for n in loc)]))
    return z, slabs, torch.as_tensor(c), gs, order, np.asarray(want), X


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("case", SLAB_CASES, ids=_case_id)
def test_slab_form_matches_reference_kernel(case, radius):
    """The block and its slabs in (the apply): the reference's kernel on
    the extended block; and exactly the existing plain version on the slabs
    concatenated."""
    z, slabs, c, gs, order, want, X = _slab_case(case, radius)
    shape, form = case[0], case[3]
    w = ft.Weights(**RADIUS_WEIGHTS[radius])
    level = ExtLevel(c, gs, w, radius, shape, striped=form == "striped")
    assert level.order == order
    assert [tuple(t.shape) for pair in slabs for t in pair if t is not None] == [
        level.slab_shapes[k] for k, pair in enumerate(slabs) for t in pair if t is not None]
    got = level(z, slabs)
    np.testing.assert_allclose(got.numpy(), want, atol=BARS[form])
    x_ext = extend_with_slabs(z, slabs, radius, order)
    assert torch.equal(x_ext, torch.as_tensor(X))
    assert torch.equal(got, fused_normal_apply_ext_plain(x_ext, c, gs, w, len(shape), radius,
                                                         shape))


@pytest.mark.parametrize("mode", ["residual", "jacobi", "chebyshev"])
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("case", MODE_CASES, ids=_case_id)
def test_modes_match_reference(case, radius, mode):
    """Each mode on the block and its slabs against the reference kernel's
    A z followed by the reference cycle's expression in jnp."""
    z, slabs, c, gs, order, az, _ = _slab_case(case, radius)
    shape, form = case[0], case[3]
    rng = np.random.default_rng(17 + radius)
    r, zp = (rng.standard_normal(z.shape).astype(np.float32) for _ in range(2))
    inv_d = rng.uniform(0.05, 0.5, z.shape).astype(np.float32)
    s0, s1 = (float(np.float32(v)) for v in rng.uniform(0.2, 1.2, 2))
    jz, jr, jzp, jinv, jaz = (jnp.asarray(a) for a in (z.numpy(), r, zp, inv_d, az))
    j0, j1 = jnp.float32(s0), jnp.float32(s1)
    want = {"residual": lambda: jr - jaz,
            "jacobi": lambda: jz + j0 * jinv * (jr - jaz),
            "chebyshev": lambda: jz + j0 * (jz - jzp) + j1 * jinv * (jr - jaz)}[mode]()
    level = ExtLevel(c, gs, ft.Weights(**RADIUS_WEIGHTS[radius]), radius, shape,
                     striped=form == "striped")
    t = torch.as_tensor
    got = level(z, slabs, mode, r=t(r), inv_d=t(inv_d), z_prev=t(zp), s0=s0, s1=s1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BARS[form])


def test_slab_shapes_follow_the_exchange_order():
    """Axes exchanged before an axis extend its slabs by the halo (the
    corners), later ones do not."""
    assert slab_shapes((16, 15), 2, (0, 1)) == [(2, 15), (20, 2)]
    assert slab_shapes((16, 15), 2, (1, 0)) == [(16, 2), (2, 19)]
    assert slab_shapes((8, 8, 12), 3, (0, 1, 2)) == [(3, 8, 12), (14, 3, 12), (14, 14, 3)]


def test_ext_level_checks():
    """The constant checks are made once, when the level is made."""
    w = ft.Weights(model_2=0.3, model_3=0.1)
    with pytest.raises(ValueError, match="narrower"):
        ExtLevel(torch.zeros(6, 8), [0, 0], w, 2, (6, 8))
    with pytest.raises(ValueError, match="striped form takes 9 channels"):
        ExtLevel(torch.zeros(6, 8), [0, 0], w, 3, (6, 8), striped=True)
    with pytest.raises(ValueError, match="unknown mode"):
        ExtLevel(torch.zeros(6, 8), [0, 0], w, 3, (6, 8))(torch.zeros(6, 8), mode="sweep")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A process group of this process alone (gloo, a rendezvous file)."""
    import torch.distributed as dist
    path = tmp_path_factory.mktemp("rendezvous") / "file"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("change", [{}, dict(mg_smoother="chebyshev4"), dict(mg_cycle="w"),
                                    dict(mg_smoother="chebyshev4", mg_cycle="w")], ids=str)
def test_one_rank_distributed_cycle_matches_reference(one_rank, change):
    """The distributed cycle as one rank (mesh 1 x 1, no halo messages):
    its fine level and first coarse level sharded, every sweep and residual
    there through `ExtLevel` (the plain version on the CPU), Jacobi and
    Chebyshev, V and W (whose second visit takes the coarse level's
    residual), against the reference's unsharded cycle; the bar of
    tests/test_torch_sharded.py's distributed cycle."""
    rng = np.random.default_rng(5)
    shape, kw = (160, 128), dict(model_1=0.1, model_2=1.0)
    pos = rng.uniform(0, np.asarray(shape) - 1, (150, 2)).astype(np.float32)
    vals = rng.standard_normal(150).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    part = sharded_precond(Cloud(shape, ft.Weights(**kw), pos, vals), (1, 1),
                           ft.SolverConfig(tol=1e-4, **change), r, device=torch.device("cpu"))
    assert part["n_sh"] >= 1 and part["level_routes"][1] == "ext"
    jp = jassemble(fi.Grid(shape), fi.Weights(**kw), jnp.asarray(pos), jnp.asarray(vals))
    want = np.asarray(jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(
        tol=1e-4, preconditioner="multigrid", backend="xla", **change))(jnp.asarray(r)))
    np.testing.assert_allclose(part["z"].numpy(), want, atol=2e-5 * np.abs(want).max(),
                               rtol=1e-5)
