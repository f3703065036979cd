"""The sharded solve on four gloo ranks on the CPU against the reference.

The ranks start once for the whole file (`parallel.launch.run_ranks`) and
run every case of `CASES` (`parallel.cases`, which imports no JAX); each
test reads its case's parts, stitches the blocks and holds them to the
reference on the same numpy-seeded inputs, with the reference tests' bars
(tests/test_sharded.py):

* the sharded apply against the reference's unsharded apply, atol 1e-4
  (:148), on meshes (2, 2), (4, 1), (1, 4) and a 3-D one, every route
  (the ext kernels' plain versions and the sequential plain apply);
* the plain apply under ``overlap=True`` (the reference's default, which
  leaves the port on its sequential route) against the reference's
  overlapped 2-D apply on the same mesh of virtual devices, atol 1e-5·max
  (:459-490), on meshes (2, 2), (4, 1), (1, 4), and for a float64 operand
  off ``backend="xla"``;
* `solve_sharded` (jacobi, multigrid) against the reference's `solve` and
  its `solve_sharded` on a 2 x 2 mesh of the conftest's virtual devices:
  ±2 iterations, 2e-3·max|x| (:52, :300);
* the distributed multigrid preconditioner, once, against the reference's
  unsharded cycle on 160 x 128, whose first coarse level stays sharded:
  atol 2e-5·max|z|, rtol 1e-5 (:387); its plan equals the reference's;
* `solve_refined_sharded`, float64 `Problem` and `PreciseProblem`, to a
  TRUE 1e-6 against the reference's explicit float64 oracle (≤ 1.1e-6,
  :239, :538), the precise 2-D fields within 2e-4·max|x| of the
  reference's single-card `solve_refined` (:531), and a warm start;
* indivisible grids raise (:242)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu.explicit import assemble_explicit, normal_equations
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.parallel import sharded as jsh
from field_interpolation_tpu.sdf import assemble_precise as jassemble_precise
from field_interpolation_tpu.solver import solve_refined as jsolve_refined

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.parallel import Mesh, shard_problem, solve_sharded
from field_interpolation_tpu_torch.parallel.cases import Cloud, run_cases, stitch
from field_interpolation_tpu_torch.parallel.launch import run_ranks

MESHES = [(2, 2), (4, 1), (1, 4)]
W_APPLY = dict(model_1=0.2, model_2=1.0, model_3=0.3)    # radius 3
W_JACOBI = dict(model_1=0.1, model_2=1.0)
W_MG = dict(model_2=0.3)


def _cloud(shape, weights_kw, n, seed=0, gradients=True, hi=1.0):
    """A cloud of value (and gradient) rows, as the reference tests make it."""
    rng = np.random.default_rng(seed)
    nd = len(shape)
    pos = rng.uniform(0, np.asarray(shape) - hi, (n, nd))
    vals = rng.standard_normal(n)
    grads = rng.standard_normal((n, nd)) if gradients else None
    return Cloud(tuple(shape), ft.Weights(**weights_kw), pos.astype(np.float32),
                 vals.astype(np.float32), None if grads is None else grads.astype(np.float32))


_REF = {}


def _jproblem(c: Cloud):
    """The reference's problem of the cloud and its Weights (made once)."""
    if id(c) not in _REF:
        jw = fi.Weights(**{k: getattr(c.weights, k) for k in
                           ("data_pos", "data_gradient", "model_0", "model_1", "model_2",
                            "model_3")})
        _REF[id(c)] = (jassemble(fi.Grid(c.shape), jw, jnp.asarray(c.positions),
                                 jnp.asarray(c.values),
                                 gradients=None if c.gradients is None
                                 else jnp.asarray(c.gradients)), jw)
    return _REF[id(c)]


def _jcfg(cfg: ft.SolverConfig) -> fi.SolverConfig:
    return fi.SolverConfig(**{f: getattr(cfg, f) for f in
                              ("tol", "maxiter", "preconditioner", "backend")})


C_APPLY = _cloud((48, 40), W_APPLY, 60)
C_APPLY3 = _cloud((16, 16, 8), dict(model_2=0.5), 40)
X_APPLY = np.random.default_rng(1).standard_normal((48, 40)).astype(np.float32)
X_APPLY3 = np.random.default_rng(1).standard_normal((16, 16, 8)).astype(np.float32)
C_OVERLAP = _cloud((64, 96), dict(model_1=0.2, model_2=1.0), 120)
X_OVERLAP = np.random.default_rng(3).standard_normal((64, 96)).astype(np.float32)
C_JACOBI = _cloud((32, 64), W_JACOBI, 80)
C_MG = _cloud((64, 64), W_MG, 120)
C_3D = _cloud((16, 16, 8), dict(model_2=0.5), 40, gradients=False)
C_MG3 = _cloud((24, 24, 24), W_MG, 400)
C_PRECOND = _cloud((160, 128), W_JACOBI, 150)
R_PRECOND = np.random.default_rng(2).standard_normal((160, 128)).astype(np.float32)
C_REFINED = _cloud((32, 64), W_MG, 200, hi=1.001)
C_WARM = _cloud((32, 32), W_MG, 120, gradients=False, hi=1.001)
C_PRECISE3 = _cloud((16, 16, 32), dict(model_2=0.4), 150, gradients=False, hi=1.001)
CFG_J = ft.SolverConfig(tol=1e-4, preconditioner="jacobi", maxiter=4000)
CFG_MG = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", maxiter=2000)
CFG_MG_XLA = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", maxiter=2000,
                             backend="xla")
CFG_6 = ft.SolverConfig(tol=1e-6, preconditioner="multigrid", maxiter=20000)

APPLY_CASES = [(ms, be) for ms in MESHES for be in ("auto", "xla")]
SOLVE_CASES = ([("jacobi", ms, C_JACOBI, CFG_J) for ms in ((2, 2), (1, 4))]
               + [("multigrid", ms, C_MG, CFG_MG) for ms in MESHES]
               + [("multigrid xla", (2, 2), C_MG, CFG_MG_XLA),
                  ("jacobi xla", (4, 1), C_JACOBI,
                   ft.SolverConfig(tol=1e-4, preconditioner="jacobi", maxiter=4000,
                                   backend="xla")),
                  ("3-D jacobi", (1, 2, 2), C_3D, CFG_J),
                  ("3-D multigrid", (2, 2), C_MG3, CFG_MG)])
PRECOND_CASES = [((2, 2), "auto"), ((2, 2), "xla"), ((4, 1), "auto")]
REFINED_CASES = [("float64 jacobi", (2, 2), C_REFINED, False,
                  ft.SolverConfig(tol=1e-6, preconditioner="jacobi", maxiter=20000)),
                 ("float64 multigrid", (2, 2), C_REFINED, False, CFG_6),
                 ("precise", (2, 2), C_REFINED, True, CFG_6),
                 ("precise", (4, 1), C_REFINED, True, CFG_6),
                 ("precise 3-D", (1, 2, 2), C_PRECISE3, True, CFG_6)]

# (mesh, overlap, dtype, backend) of the overlapped apply's cases.
OVERLAP_CASES = ([(ms, ov, torch.float32, "xla") for ms in MESHES for ov in (True, False)]
                 + [((2, 2), True, torch.float64, "auto")])

CASES = (
    [("sharded_apply", dict(cloud=C_APPLY, mesh_shape=ms, x=X_APPLY, backend=be))
     for ms, be in APPLY_CASES]
    + [("sharded_apply", dict(cloud=C_APPLY3, mesh_shape=(1, 2, 2), x=X_APPLY3, backend=be))
       for be in ("auto", "xla")]
    + [("sharded_solve", dict(cloud=c, mesh_shape=ms, config=cfg))
       for _, ms, c, cfg in SOLVE_CASES]
    + [("sharded_precond", dict(cloud=C_PRECOND, mesh_shape=ms, r=R_PRECOND,
                                config=ft.SolverConfig(tol=1e-4, backend=be)))
       for ms, be in PRECOND_CASES]
    + [("sharded_refined", dict(cloud=c, mesh_shape=ms, config=cfg, precise=precise))
       for _, ms, c, precise, cfg in REFINED_CASES]
    + [("sharded_refined", dict(cloud=C_WARM, mesh_shape=(2, 2), config=CFG_6, warm=True))]
    + [("sharded_apply", dict(cloud=C_OVERLAP, mesh_shape=ms, x=X_OVERLAP, backend=be,
                              overlap=ov, dtype=dt))
       for ms, ov, dt, be in OVERLAP_CASES])


@pytest.fixture(scope="module")
def parts():
    """Every case's parts, from one start of four gloo ranks: parts[case][rank]."""
    res = run_ranks(run_cases, 4, CASES, device="cpu")
    return [[r[k] for r in res] for k in range(len(CASES))]


def _x(ps, key="x"):
    return stitch(ps, key).numpy()


@pytest.mark.parametrize("k", range(len(APPLY_CASES)),
                         ids=[f"{ms}-{be}" for ms, be in APPLY_CASES])
def test_sharded_apply_matches_reference(parts, k):
    ms, be = APPLY_CASES[k]
    ps = parts[k]
    jp, _ = _jproblem(C_APPLY)
    np.testing.assert_allclose(_x(ps, "y"), np.asarray(jp.apply(jnp.asarray(X_APPLY))),
                               atol=1e-4)
    assert ps[0]["route"] == ("ext" if be == "auto" else "sequential")


@pytest.mark.parametrize("j,backend", [(0, "auto"), (1, "xla")])
def test_sharded_apply_3d_matches_reference(parts, j, backend):
    ps = parts[len(APPLY_CASES) + j]
    jp, _ = _jproblem(C_APPLY3)
    np.testing.assert_allclose(_x(ps, "y"), np.asarray(jp.apply(jnp.asarray(X_APPLY3))),
                               atol=1e-4)
    assert ps[0]["route"] == ("ext" if backend == "auto" else "sequential")


SOLVE0 = len(APPLY_CASES) + 2


@pytest.mark.parametrize("k", range(len(SOLVE_CASES)),
                         ids=[f"{name}-{ms}" for name, ms, _, _ in SOLVE_CASES])
def test_solve_sharded_matches_reference_solve(parts, k):
    _, ms, c, cfg = SOLVE_CASES[k]
    ps = parts[SOLVE0 + k]
    jp, _ = _jproblem(c)
    xr, ir = fi.solve(jp, _jcfg(cfg))
    assert all(p["converged"] for p in ps)
    assert len({(p["iterations"], p["rel_residual"]) for p in ps}) == 1  # the same on every rank
    assert abs(ps[0]["iterations"] - int(ir.iterations)) <= 2
    xr = np.asarray(xr)
    np.testing.assert_allclose(_x(ps), xr, atol=2e-3 * np.abs(xr).max())
    if cfg.backend == "xla":
        assert ps[0]["route"] == "sequential"


@pytest.mark.parametrize("name", ["jacobi", "multigrid", "multigrid xla"])
def test_solve_sharded_matches_reference_solve_sharded(parts, name):
    """Against the reference's own sharded solve on a 2 x 2 mesh of the
    conftest's virtual CPU devices."""
    k = [i for i, (n, ms, _, _) in enumerate(SOLVE_CASES) if n == name and ms == (2, 2)][0]
    _, _, c, cfg = SOLVE_CASES[k]
    ps = parts[SOLVE0 + k]
    jp, _ = _jproblem(c)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    xr, ir = jsh.solve_sharded(jsh.shard_problem(jp, mesh), mesh, _jcfg(cfg))
    assert abs(ps[0]["iterations"] - int(ir.iterations)) <= 2
    xr = np.asarray(xr)
    np.testing.assert_allclose(_x(ps), xr, atol=2e-3 * np.abs(xr).max())


PRECOND0 = SOLVE0 + len(SOLVE_CASES)


def _reference_cycle():
    if "z" not in _REF:
        jp, _ = _jproblem(C_PRECOND)
        cfg = fi.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="xla")
        pc = jax.jit(jmg.make_vcycle_preconditioner(jp, cfg))
        _REF["z"] = np.asarray(pc(jnp.asarray(R_PRECOND)))
    return _REF["z"]


@pytest.mark.parametrize("k", range(len(PRECOND_CASES)),
                         ids=[f"{ms}-{be}" for ms, be in PRECOND_CASES])
def test_distributed_precond_matches_unsharded_cycle(parts, k):
    """One distributed cycle against the reference's unsharded V-cycle
    (tests/test_sharded.py:347-387); the first coarse level stays sharded,
    so the banded transfers over halos, the sharded level smoothing (the ext
    kernel's diagonal form off backend="xla") and the gather at the boundary
    all run."""
    ms, be = PRECOND_CASES[k]
    ps = parts[PRECOND0 + k]
    zr = _reference_cycle()
    np.testing.assert_allclose(_x(ps, "z"), zr, atol=2e-5 * np.abs(zr).max(), rtol=1e-5)
    assert ps[0]["n_sh"] >= 1 and ps[0]["trans"][0][0] == "ss"
    shard_level = "ext" if be == "auto" else "plain"
    assert ps[0]["level_routes"][:2] == ("apply", shard_level)


@pytest.mark.parametrize("ms", [(2, 2), (4, 1)])
def test_distributed_plan_matches_reference(parts, ms):
    """The sharded prefix and the transitions equal the reference's
    `_make_mg_plan` on the same mesh of virtual devices."""
    k = PRECOND_CASES.index((ms, "auto"))
    ps = parts[PRECOND0 + k]
    jp, _ = _jproblem(C_PRECOND)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(ms), ("x", "y"))
    plan, _, _ = jsh._make_mg_plan(jp, mesh, fi.SolverConfig(preconditioner="multigrid"))
    assert ps[0]["n_sh"] == plan.n_sh
    assert ps[0]["shapes"] == plan.shapes
    assert [(t[0], tuple(t[1]), tuple(tuple(h) for h in t[2])) for t in ps[0]["trans"]] \
        == [(t[0], tuple(t[1]), tuple(tuple(int(v) for v in h) for h in t[2]))
            for t in plan.trans]


REFINED0 = PRECOND0 + len(PRECOND_CASES)


def _true_rel(c: Cloud, x: np.ndarray) -> float:
    """The TRUE relative residual against the reference's explicitly
    assembled float64 normal equations."""
    jw = _jproblem(c)[1]
    eq = assemble_explicit(fi.Grid(c.shape), jw, c.positions.astype(np.float64),
                           c.values.astype(np.float64),
                           None if c.gradients is None else c.gradients.astype(np.float64))
    AtA, Atb = normal_equations(eq, int(np.prod(c.shape)))
    r = Atb - AtA @ np.asarray(x, np.float64).ravel()
    return float(np.linalg.norm(r) / np.linalg.norm(Atb))


@pytest.mark.parametrize("k", range(len(REFINED_CASES)),
                         ids=[f"{name}-{ms}" for name, ms, *_ in REFINED_CASES])
def test_refined_sharded_true_1e6(parts, k):
    name, ms, c, precise, cfg = REFINED_CASES[k]
    ps = parts[REFINED0 + k]
    x = _x(ps)
    assert x.dtype == np.float64
    assert all(p["converged"] for p in ps)
    assert ps[0]["rel_residual"] <= 1e-6
    assert _true_rel(c, x) <= 1.1e-6
    if precise and len(c.shape) == 2:
        jw = _jproblem(c)[1]
        pp = jassemble_precise(fi.Grid(c.shape), jw, jnp.asarray(c.positions),
                               jnp.asarray(c.values),
                               gradients=None if c.gradients is None
                               else jnp.asarray(c.gradients))
        x1, _ = jsolve_refined(pp, _jcfg(cfg))
        x1 = np.asarray(x1, np.float64)
        np.testing.assert_allclose(x, x1, atol=2e-4 * np.abs(x1).max())


def test_refined_sharded_warm_start(parts):
    """From its own float32 result the refinement converges at once
    (tests/test_sharded.py:541-560)."""
    ps = parts[OVERLAP0 - 1]
    assert all(p["converged"] and p["warm"]["converged"] for p in ps)
    assert ps[0]["warm"]["iterations"] < ps[0]["iterations"]
    assert _true_rel(C_WARM, _x(ps)) <= 1.1e-6


OVERLAP0 = len(CASES) - len(OVERLAP_CASES)


def _reference_apply(c: Cloud, x: np.ndarray, ms, overlap: bool) -> np.ndarray:
    """The reference's sharded apply (`make_sharded_apply` under shard_map)
    of ``x`` on an ``ms`` mesh of the conftest's virtual CPU devices."""
    from functools import partial

    from jax.sharding import NamedSharding
    jp, jw = _jproblem(c)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(ms), ("x", "y"))
    spec_g = jsh._grid_partition_spec(mesh, 2)
    spec_c = jsh._grid_partition_spec(mesh, 2, lead_dims=1)

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec_c, spec_g), out_specs=spec_g)
    def body(coeff_l, x_l):
        return jsh.make_sharded_apply(c.shape, jw, mesh, coeff_l, overlap=overlap)(x_l)

    return np.asarray(jax.jit(body)(jax.device_put(jp.coeff, NamedSharding(mesh, spec_c)),
                                    jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec_g))))


@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_overlap_apply_equals_sequential(parts, ms):
    """``overlap=True`` and ``overlap=False`` both take the sequential plain
    route and give the same bits; both equal the reference's overlapped 2-D
    apply on the same mesh at the reference's bar between its overlapped and
    its sequential apply (tests/test_sharded.py:459-490)."""
    got = {}
    for j, (m, ov, dt, _) in enumerate(OVERLAP_CASES):
        if m == ms and dt == torch.float32:
            ps = parts[OVERLAP0 + j]
            assert ps[0]["route"] == "sequential"
            got[ov] = _x(ps, "y")
    assert np.array_equal(got[True], got[False])
    want = _reference_apply(C_OVERLAP, X_OVERLAP, ms, overlap=True)
    np.testing.assert_allclose(got[True], want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_overlap_apply_float64_operand(parts):
    """A float64 operand off backend="xla" takes the sequential plain apply
    (the ext kernels are float32 only; the reference's gate sends it to its
    overlapped body) and equals the float32 apply to float32 rounding."""
    ps = parts[-1]
    assert ps[0]["route"] == "ext"
    y64 = _x(ps, "y")
    assert y64.dtype == np.float64
    j = OVERLAP_CASES.index(((2, 2), False, torch.float32, "xla"))
    y32 = _x(parts[OVERLAP0 + j], "y")
    np.testing.assert_allclose(y64, y32, rtol=0, atol=1e-5 * np.abs(y32).max())


def test_indivisible_grid_raises():
    """No ranks needed: the check comes before any message."""
    c = _cloud((30, 32), dict(model_2=1.0), 10)
    p = c.problem("cpu")
    mesh = Mesh((4, 2))
    with pytest.raises(ValueError, match="not divisible"):
        shard_problem(p, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        solve_sharded(p, mesh)


def test_mesh_lays_out_ranks_row_major():
    mesh = Mesh((2, 3))
    assert [mesh.coords(r) for r in range(6)] == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1),
                                                  (1, 2)]
    assert all(mesh.rank_at(mesh.coords(r)) == r for r in range(6))
    assert mesh.axis_names == ("x", "y") and mesh.shards(3) == (2, 3, 1)
    with pytest.raises(ValueError):
        Mesh((2, 2)).shards(1)
