"""The port's tooling modules against the reference's
(tests/test_utils_extras.py's cases): `operators.validate_problem` on the
same problems, `utils.observe` (solve records, the chained marginal timer,
`op_cost` in place of `xla_cost`), `visualize` and `checkpoint` (a file
written by either package loads in the other)."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import checkpoint as jckpt
from field_interpolation_tpu import visualize as jvis
from field_interpolation_tpu.contour import marching_squares as jmarching_squares
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.operators import validate_problem as jvalidate

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import checkpoint, visualize
from field_interpolation_tpu_torch.contour import marching_squares
from field_interpolation_tpu_torch.convert import problem_from_numpy
from field_interpolation_tpu_torch.operators import assemble, validate_problem

W = dict(model_0=0.05, model_1=0.1, model_2=0.7, model_3=0.2)


def _inputs(rng, shape, n=50):
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, len(shape))).astype(np.float32)
    grads = rng.standard_normal((n, len(shape))).astype(np.float32)
    return pos, grads


def _problem(rng, shape, weights=W):
    pos, grads = _inputs(rng, shape)
    return assemble(ft.Grid(shape), ft.Weights(**weights), torch.as_tensor(pos),
                    torch.zeros(len(pos)), gradients=torch.as_tensor(grads))


def _ref_problem(rng, shape, weights=W):
    pos, grads = _inputs(rng, shape)
    return jassemble(fi.Grid(shape), fi.Weights(**weights), jnp.asarray(pos),
                     jnp.zeros(len(pos), jnp.float32), gradients=jnp.asarray(grads))


@pytest.mark.parametrize("case", ["clean", "nan_b", "all_zero", "negative_diag",
                                  "no_smoothness", "clean_3d"])
def test_validate_problem_matches_reference(case):
    """The same issues as the reference's on the same problems, carried
    across with `convert.problem_from_numpy`."""
    rng = np.random.default_rng(0)
    shape = (8, 6, 5) if case == "clean_3d" else (16, 16)
    weights = dict(model_2=0.0) if case == "no_smoothness" else W
    ref = _ref_problem(rng, shape, weights)
    if case == "nan_b":
        ref = dataclasses.replace(ref, b=ref.b.at[0, 0].set(np.nan))
    if case in ("all_zero", "no_smoothness"):
        ref = dataclasses.replace(ref, coeff=jnp.zeros_like(ref.coeff),
                                  diag=jnp.zeros_like(ref.diag))
    if case == "negative_diag":
        ref = dataclasses.replace(ref, diag=ref.diag.at[3, 4].set(-1.0))
    port = problem_from_numpy(ref.coeff, ref.b, ref.diag, ft.Grid(shape),
                              ft.Weights(**weights))
    want = jvalidate(ref)
    assert validate_problem(port) == want
    assert (want == []) == (case in ("clean", "clean_3d"))


def test_validate_problem_on_assembled():
    p = _problem(np.random.default_rng(0), (16, 16))
    assert validate_problem(p) == []
    bad = dataclasses.replace(p, b=p.b.clone().index_put_((torch.tensor(0),), torch.tensor(
        float("nan"))))
    assert any("non-finite" in m for m in validate_problem(bad))


def test_solve_record(rng):
    from field_interpolation_tpu_torch.utils import record_solve, timed_block
    p = _problem(rng, (32, 32))
    with timed_block() as t:
        x, info = ft.solve(p, ft.SolverConfig(tol=1e-3))
    buf = io.StringIO()
    rec = record_solve(p.grid, info, t["ms"], stream=buf, tag="unit")
    assert rec.converged and rec.iterations > 0 and rec.wall_ms > 0
    assert rec.achieved_gbps is not None and rec.roofline_frac is not None
    line = buf.getvalue()
    assert '"grid_shape": [32, 32]' in line and '"tag": "unit"' in line


def test_observe_accounting_matches_reference():
    """The traffic model is the reference's; only the card's rates differ."""
    from field_interpolation_tpu.utils import observe as jobs
    from field_interpolation_tpu_torch.utils import observe as obs
    for shape in [(32, 32), (16, 8, 4), (64,)]:
        assert (obs.roofline_bytes_per_apply(ft.Grid(shape))
                == jobs.roofline_bytes_per_apply(fi.Grid(shape)))
    assert obs.vcycle_applies_per_iteration(2, 3) == jobs.vcycle_applies_per_iteration(2, 3)
    assert obs.HBM_GBPS == {"h100": 3350.0} and obs.PEAK_TFLOPS == {"h100": 67.0}
    info = type("Info", (), dict(iterations=10, rel_residual=1e-5, converged=True))
    rec = obs.record_solve(ft.Grid((64, 64)), info, 2.0, applies_per_iteration=4.0)
    assert rec.achieved_gbps == pytest.approx(64 * 64 * 4 * 11 * 10 * 4.0 / 2e-3 / 1e9)
    assert rec.roofline_frac == pytest.approx(rec.achieved_gbps / 3350.0)


def test_visualize_helpers(tmp_path):
    """Every helper gives the reference's pixels, from arrays and tensors."""
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    sdf = np.sqrt((yy - 15.5) ** 2 + (xx - 15.5) ** 2) - 8.0
    img = visualize.sdf_colormap(torch.as_tensor(sdf))
    np.testing.assert_array_equal(img, jvis.sdf_colormap(sdf))
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert img[15, 15, 0] > img[15, 15, 2] and img[0, 0, 2] > img[0, 0, 0]
    segs = marching_squares(sdf)
    img2 = visualize.draw_contour(img, torch.as_tensor(segs))
    np.testing.assert_array_equal(img2, jvis.draw_contour(img, jmarching_squares(sdf)))
    p, pr = tmp_path / "sdf.ppm", tmp_path / "ref.ppm"
    visualize.write_ppm(str(p), img2)
    jvis.write_ppm(str(pr), img2)
    assert p.read_bytes() == pr.read_bytes()
    assert p.read_bytes().startswith(b"P6\n32 32\n255\n")
    v = visualize.value_colormap(sdf, vmin=-3.0)
    np.testing.assert_array_equal(v, jvis.value_colormap(sdf, vmin=-3.0))
    assert v.shape == (32, 32, 3)


def test_draw_arrows():
    img = np.zeros((32, 32, 3), np.uint8)
    pos = np.array([[16.0, 16.0], [4.0, 4.0], [20.0, 8.0]])
    dirs = np.array([[0.0, 1.0], [1.0, 0.0], [0.6, -0.8]])
    out = visualize.draw_arrows(img, torch.as_tensor(pos), dirs, length=6.0,
                                color=(0, 200, 0))
    np.testing.assert_array_equal(out, jvis.draw_arrows(img, pos, dirs, length=6.0,
                                                        color=(0, 200, 0)))
    assert out.shape == img.shape and img.sum() == 0
    assert (out[16, 17:22] == (0, 200, 0)).all()
    assert (out[5:10, 4] == (0, 200, 0)).all()
    assert (out[..., 1] == 200).sum() > 14
    visualize.draw_arrows(img, np.array([[8.0, 8.0]]), np.array([[0.0, 0.0]]))


def test_checkpoint_roundtrip(rng, tmp_path):
    p = _problem(rng, (24, 24))
    cfg = ft.SolverConfig(tol=1e-3)
    x, info = ft.solve(p, cfg)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, x, p.grid, p.weights, iteration=int(info.iterations))
    x2, grid2, w2, extra = checkpoint.load_state(path)
    assert torch.equal(x2, x)
    assert grid2 == p.grid and w2 == p.weights
    assert extra["iteration"] == int(info.iterations)
    _, info2 = ft.solve(p, cfg, x0=x2)
    assert int(info2.iterations) == 0


def test_checkpoint_files_cross_packages(tmp_path):
    """A file from either package loads in the other, with the same field,
    grid shape, weights and extras."""
    x = np.random.default_rng(1).standard_normal((6, 7)).astype(np.float32)
    w = dict(model_1=0.25, model_2=0.5)
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    checkpoint.save_state(port_path, torch.as_tensor(x), ft.Grid((6, 7)), ft.Weights(**w),
                          frame=3)
    jckpt.save_state(ref_path, jnp.asarray(x), fi.Grid((6, 7)), fi.Weights(**w), frame=3)
    xr, gr, wr, er = jckpt.load_state(port_path)
    np.testing.assert_array_equal(xr, x)
    assert gr == fi.Grid((6, 7)) and wr == fi.Weights(**w) and er == {"frame": 3}
    xp, gp, wp, ep = checkpoint.load_state(ref_path)
    np.testing.assert_array_equal(xp.numpy(), x)
    assert gp == ft.Grid((6, 7)) and wp == ft.Weights(**w) and ep == {"frame": 3}


def test_measure_marginal():
    """Positive marginal, the long chain's carry stepped K2 times, and the
    count check."""
    from field_interpolation_tpu_torch.utils import measure_marginal
    a = torch.eye(256) * 1.001

    def step(c):
        m, k = c
        return (a @ m * (1.0 / 1.001), k + 1.0)

    per, details = measure_marginal(step, (torch.ones((256, 256)), torch.tensor(0.0)),
                                    counts=(2, 64))
    assert per > 0
    assert float(details["final_carry"][1]) == 64.0
    assert details["times_s"][64] > 0 and details["times_s"][2] > 0
    with pytest.raises(ValueError):
        measure_marginal(step, torch.zeros(3), counts=(64, 8))


def test_op_cost_counts():
    """op_cost: the exact matmul flop count (2n³), at least the inputs and
    output in bytes, the roofline bound, transcendentals, and the table."""
    from field_interpolation_tpu_torch.utils import cost_table, op_cost
    n = 128
    c = op_cost(lambda a, b: a @ b, torch.ones((n, n)), torch.ones((n, n)), name="matmul")
    assert c.flops == 2.0 * n ** 3
    assert c.bytes_accessed >= 3 * n * n * 4
    assert c.est_ms == max(c.est_ms_bw, c.est_ms_flops) > 0
    assert c.arithmetic_intensity > 1.0
    assert c.temp_bytes == 0
    t = op_cost(torch.sin, torch.ones((n,)), name="sin")
    assert t.transcendentals >= n and t.flops == 0
    table = cost_table([c, t])
    assert "matmul" in table and "sin" in table and "TOTAL" in table
    assert f"{(c.flops + t.flops) / 1e9:.3f}" in table.splitlines()[-1]


def test_op_cost_on_solver_phase():
    """A whole SDF solve (plain ops, `backend="xla"`) reports nonzero flops
    and bytes."""
    from field_interpolation_tpu_torch.utils import op_cost
    rng = np.random.default_rng(0)
    th = rng.uniform(0, 2 * np.pi, 32)
    pos = torch.as_tensor(np.stack([11.5 + 8 * np.cos(th), 11.5 + 8 * np.sin(th)], -1),
                          dtype=torch.float32)
    nrm = torch.as_tensor(np.stack([np.cos(th), np.sin(th)], -1), dtype=torch.float32)
    cfg = ft.SolverConfig(preconditioner="multigrid", maxiter=8, backend="xla")

    def phase(p, nv):
        return ft.sdf_from_points(ft.Grid((24, 24)), ft.Weights(), p, nv, config=cfg)[0]

    c = op_cost(phase, pos, nrm, name="sdf-solve")
    assert c.flops > 0 and c.bytes_accessed > 0 and c.est_ms > 0
