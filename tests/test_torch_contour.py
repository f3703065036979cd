"""The port's contouring (`field_interpolation_tpu_torch.contour`) against the
reference's (`field_interpolation_tpu.contour`), each of tests/test_contour.py's
cases on the same numpy-seeded inputs through both packages:

* the host functions (`marching_squares`, `marching_tetrahedra`,
  `weld_triangles`, `write_obj`, `contour_polylines`) bit for bit, also
  when given torch tensors;
* the fixed-slot device extractors: the same ``valid`` masks exactly,
  coordinates within 2e-6 (tests/test_contour.py:447);
* the compact extractors: equal ``count`` and ``overflowed`` (per-tile caps
  and the global cap included), rows in the same order within 2e-6, zeros
  past ``count``; the lane axis against lane-by-lane calls;
* assemble → solve → contour through the port's `sdf_from_points`.
Grids stay at or below 64² and 24³."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import contour as jc

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import contour as tc

BAR = 2e-6


def _circle_sdf(n, cx, cy, r):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2) - r


def _sphere_sdf(n, r):
    g = np.arange(n)
    ii, jj, kk = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2
    return np.sqrt((ii - c) ** 2 + (jj - c) ** 2 + (kk - c) ** 2) - r


def _noisy_circle(rng, H, W, noise=0.5):
    yy, xx = np.mgrid[0:H, 0:W]
    return (np.hypot(yy - H / 2, xx - W / 2) - min(H, W) * 0.3
            + noise * rng.standard_normal((H, W))).astype(np.float32)


def _noisy_sphere(rng, NI, NJ, NK, noise=0.4):
    ii, jj, kk = np.mgrid[0:NI, 0:NJ, 0:NK]
    return (np.sqrt((ii - NI / 2) ** 2 + (jj - NJ / 2) ** 2 + (kk - NK / 2) ** 2)
            - min(NI, NJ, NK) * 0.35 + noise * rng.standard_normal((NI, NJ, NK))
            ).astype(np.float32)


def _same_slots(port, ref):
    """Fixed-slot outputs: the same valid mask, live coordinates within BAR."""
    (items, valid), (items_r, valid_r) = port, ref
    valid_r = np.asarray(valid_r)
    np.testing.assert_array_equal(valid.numpy(), valid_r)
    np.testing.assert_allclose(items.numpy()[valid_r], np.asarray(items_r)[valid_r],
                               rtol=0, atol=BAR)
    return items.numpy()[valid_r]


def _same_compact(port, ref):
    """Compact outputs: equal count and overflow flag, rows in the same
    order within BAR, zeros past count (per lane where there are lanes)."""
    (items, count, ovf), (items_r, count_r, ovf_r) = port, ref
    np.testing.assert_array_equal(count.numpy(), np.asarray(count_r))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(ovf_r))
    np.testing.assert_allclose(items.numpy(), np.asarray(items_r), rtol=0, atol=BAR)
    got = items.numpy().reshape((-1,) + items.shape[-3:])
    for lane, n in zip(got, count.numpy().reshape(-1)):
        assert np.all(lane[n:] == 0.0)


def _canon_segments(s):
    s = np.array(s, np.float64)
    flip = s[:, 0, :].sum(-1) > s[:, 1, :].sum(-1)
    s[flip] = s[flip][:, ::-1, :]
    idx = np.lexsort((s[:, 1, 1], s[:, 1, 0], s[:, 0, 1], s[:, 0, 0]))
    return s[idx]


def _canon_triangles(t):
    t = np.round(np.asarray(t, np.float64), 4)
    for n in range(t.shape[0]):
        order = np.lexsort((t[n, :, 2], t[n, :, 1], t[n, :, 0]))
        t[n] = t[n][order]
    flat = t.reshape(t.shape[0], -1)
    return t[np.lexsort(flat.T[::-1])]


# ---- host ------------------------------------------------------------------

def test_marching_squares_circle():
    sdf = _circle_sdf(64, 31.5, 31.5, 20.0)
    segs = tc.marching_squares(torch.as_tensor(sdf))
    np.testing.assert_array_equal(segs, jc.marching_squares(sdf))
    pts = segs.reshape(-1, 2)
    np.testing.assert_allclose(np.sqrt(((pts - 31.5) ** 2).sum(1)), 20.0, atol=0.05)
    lengths = np.linalg.norm(segs[:, 0] - segs[:, 1], axis=1)
    np.testing.assert_allclose(lengths.sum(), 2 * np.pi * 20, rtol=0.01)


def test_marching_squares_levels_and_empty():
    sdf = _circle_sdf(32, 15.5, 15.5, 8.0)
    segs5 = tc.marching_squares(sdf, level=5.0)
    np.testing.assert_array_equal(segs5, jc.marching_squares(sdf, level=5.0))
    np.testing.assert_allclose(np.sqrt(((segs5.reshape(-1, 2) - 15.5) ** 2).sum(1)), 13.0,
                               atol=0.06)
    assert tc.marching_squares(sdf, level=100.0).shape == (0, 2, 2)
    assert tc.marching_squares(torch.ones((8, 8))).shape == (0, 2, 2)


def test_marching_squares_saddle_consistent():
    for f in (np.array([[1.0, -1.0], [-1.0, 1.0]]), np.array([[-1.0, 1.0], [1.0, -1.0]]),
              np.array([[-1.0, 3.0], [3.0, -1.0]]), np.array([[1.0, -3.0], [-3.0, 1.0]])):
        segs = tc.marching_squares(f)
        assert len(segs) == 2
        np.testing.assert_array_equal(segs, jc.marching_squares(f))


def test_polyline_chaining():
    sdf = _circle_sdf(48, 23.5, 23.5, 15.0)
    segs = tc.marching_squares(sdf)
    lines = tc.contour_polylines(torch.as_tensor(segs))
    want = jc.contour_polylines(jc.marching_squares(sdf))
    assert len(lines) == len(want) == 1
    np.testing.assert_array_equal(lines[0], want[0])
    np.testing.assert_allclose(lines[0][0], lines[0][-1], atol=1e-6)


def test_polyline_open_chain_mid_seed():
    pts = [(float(i), 0.0) for i in range(5)]
    segs = np.array([[pts[i], pts[i + 1]] for i in range(4)])[[2, 0, 1, 3]]
    lines = tc.contour_polylines(segs)
    want = jc.contour_polylines(segs)
    assert len(lines) == len(want) == 1
    np.testing.assert_array_equal(lines[0], want[0])
    np.testing.assert_allclose(sorted(p[0] for p in lines[0]), [0, 1, 2, 3, 4])
    assert tc.contour_polylines(np.zeros((0, 2, 2))) == []


def test_marching_tetrahedra_sphere():
    sdf = _sphere_sdf(24, 8.0)
    tris = tc.marching_tetrahedra(torch.as_tensor(sdf))
    np.testing.assert_array_equal(tris, jc.marching_tetrahedra(sdf))
    verts = tris.reshape(-1, 3)
    np.testing.assert_allclose(np.sqrt(((verts - 11.5) ** 2).sum(1)), 8.0, atol=0.15)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()
    np.testing.assert_allclose(area, 4 * np.pi * 64, rtol=0.05)


def test_write_obj_roundtrip(tmp_path):
    ii, jj, kk = np.mgrid[0:9, 0:9, 0:9]
    f = np.sqrt((ii - 4.0) ** 2 + (jj - 4.0) ** 2 + (kk - 4.0) ** 2) - 3.0
    tris = tc.marching_tetrahedra(f)
    path, path_r = tmp_path / "s.obj", tmp_path / "r.obj"
    nv, nf = tc.write_obj(str(path), torch.as_tensor(tris))
    assert (nv, nf) == jc.write_obj(str(path_r), tris)
    assert path.read_text() == path_r.read_text()
    assert nf == len(tris) and nv < 3 * nf
    verts, faces = [], []
    for line in path.read_text().splitlines():
        if line.startswith("v "):
            verts.append([float(t) for t in line.split()[1:]])
        elif line.startswith("f "):
            faces.append([int(t) - 1 for t in line.split()[1:]])
    got = np.asarray(verts)[np.asarray(faces)]
    np.testing.assert_allclose(_canon_triangles(got), _canon_triangles(tris), atol=1e-4)
    with pytest.raises(ValueError):
        tc.write_obj(str(path), np.zeros((3, 2, 2)))


def test_weld_triangles_indexed_mesh():
    ii, jj, kk = np.mgrid[0:9, 0:9, 0:9]
    f = np.sqrt((ii - 4.0) ** 2 + (jj - 4.0) ** 2 + (kk - 4.0) ** 2) - 3.0
    tris = tc.marching_tetrahedra(f)
    verts, faces = tc.weld_triangles(torch.as_tensor(tris))
    verts_r, faces_r = jc.weld_triangles(tris)
    np.testing.assert_array_equal(verts, verts_r)
    np.testing.assert_array_equal(faces, faces_r)
    assert faces.shape == (len(tris), 3) and len(verts) < 3 * len(tris)
    assert len(np.unique(faces)) == len(verts)
    np.testing.assert_allclose(verts[faces], tris, atol=1e-5)
    with pytest.raises(ValueError):
        tc.weld_triangles(np.zeros((3, 2)))


# ---- device: fixed slots --------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_marching_squares_device_matches_host(seed):
    """The slots and mask equal the reference's; the live set equals the
    host extraction (the reference's canonical comparison)."""
    rng = np.random.default_rng(3 + seed)
    for _ in range(2):
        H, W = rng.integers(4, 64, 2)
        f = _noisy_circle(rng, H, W)
        live = _same_slots(tc.marching_squares_device(torch.as_tensor(f)),
                           jc.marching_squares_device(jnp.asarray(f)))
        want = tc.marching_squares(f)
        assert live.shape[0] == want.shape[0]
        np.testing.assert_allclose(_canon_segments(live), _canon_segments(want), atol=2e-5)


def test_marching_squares_device_level_and_dtype():
    """The level shift is taken in the field's dtype, then float32."""
    rng = np.random.default_rng(0)
    f = _noisy_circle(rng, 40, 33).astype(np.float64)
    _same_slots(tc.marching_squares_device(torch.as_tensor(f), level=0.7),
                jc.marching_squares_device(jnp.asarray(f), level=0.7))


@pytest.mark.parametrize("seed", range(2))
def test_marching_tetrahedra_device_matches_host(seed):
    rng = np.random.default_rng(seed)
    for _ in range(2):
        NI, NJ, NK = rng.integers(3, 13, 3)
        f = _noisy_sphere(rng, NI, NJ, NK)
        live = _same_slots(tc.marching_tetrahedra_device(torch.as_tensor(f)),
                           jc.marching_tetrahedra_device(jnp.asarray(f)))
        want = tc.marching_tetrahedra(f.astype(np.float64))
        assert live.shape[0] == want.shape[0]
        np.testing.assert_allclose(_canon_triangles(live), _canon_triangles(want), atol=3e-4)


# ---- device: compact ------------------------------------------------------

@pytest.mark.parametrize("tile_planes", [1, 2, 3])
def test_marching_tetrahedra_device_compact_matches_full(tile_planes):
    rng = np.random.default_rng(7 + tile_planes)
    NI, NJ, NK = rng.integers(4, 13, 3)
    f = _noisy_sphere(rng, NI, NJ, NK)
    tris, valid = tc.marching_tetrahedra_device(torch.as_tensor(f))
    want = tris[valid]
    kw = dict(max_triangles=want.shape[0] + 17, tile_planes=tile_planes)
    out = tc.marching_tetrahedra_device_compact(torch.as_tensor(f), **kw)
    _same_compact(out, jc.marching_tetrahedra_device_compact(jnp.asarray(f), **kw))
    assert not bool(out[2]) and int(out[1]) == want.shape[0]
    assert torch.equal(out[0][:int(out[1])], want)


def test_marching_tetrahedra_device_compact_overflow():
    """Both caps set ``overflowed`` as the reference's do, and the rows kept
    are the reference's rows."""
    f = np.random.default_rng(1).standard_normal((6, 6, 6)).astype(np.float32)
    tris, valid = tc.marching_tetrahedra_device(torch.as_tensor(f))
    n = int(valid.sum())
    assert n > 40
    for kw in (dict(max_triangles=20, tile_planes=2),
               dict(max_triangles=n + 5, tile_planes=2, tile_capacity=8),
               dict(max_triangles=30, tile_planes=1, tile_capacity=8)):
        out = tc.marching_tetrahedra_device_compact(torch.as_tensor(f), **kw)
        _same_compact(out, jc.marching_tetrahedra_device_compact(jnp.asarray(f), **kw))
        assert bool(out[2]) and int(out[1]) < n
    out = tc.marching_tetrahedra_device_compact(torch.as_tensor(f), max_triangles=20,
                                                tile_planes=2)
    assert int(out[1]) == 20 and torch.equal(out[0], tris[valid][:20])


@pytest.mark.parametrize("tile_rows", [1, 3, 5])
def test_marching_squares_device_compact_matches_full(tile_rows):
    rng = np.random.default_rng(11 + tile_rows)
    H, W = rng.integers(5, 64, 2)
    f = _noisy_circle(rng, H, W)
    segs, valid = tc.marching_squares_device(torch.as_tensor(f))
    want = segs[valid]
    for kw in (dict(max_segments=want.shape[0] + 9, tile_rows=tile_rows),
               dict(max_segments=5, tile_rows=4),
               dict(tile_rows=tile_rows, tile_capacity=7)):
        out = tc.marching_squares_device_compact(torch.as_tensor(f), **kw)
        _same_compact(out, jc.marching_squares_device_compact(jnp.asarray(f), **kw))
    out = tc.marching_squares_device_compact(torch.as_tensor(f), max_segments=5, tile_rows=4)
    assert bool(out[2]) and int(out[1]) == 5 and torch.equal(out[0], want[:5])


@pytest.mark.parametrize("chunk_slots", [1, 700, 5000])
def test_compact_extractors_in_groups_of_tiles(monkeypatch, chunk_slots):
    """Tiles extracted one, a few or many at a time (`contour.CHUNK_SLOTS`)
    give the reference's output, overflow by either cap included."""
    monkeypatch.setattr(tc, "CHUNK_SLOTS", chunk_slots)
    rng = np.random.default_rng(21)
    f = _noisy_circle(rng, 41, 37)
    for kw in (dict(tile_rows=3), dict(tile_rows=4, max_segments=40),
               dict(tile_rows=5, tile_capacity=9), dict(tile_rows=2, max_segments=61,
                                                         tile_capacity=6)):
        _same_compact(tc.marching_squares_device_compact(torch.as_tensor(f), **kw),
                      jc.marching_squares_device_compact(jnp.asarray(f), **kw))
    f3 = _noisy_sphere(rng, 11, 9, 10)
    for kw in (dict(tile_planes=2), dict(tile_planes=3, max_triangles=150),
               dict(tile_planes=1, tile_capacity=20)):
        _same_compact(tc.marching_tetrahedra_device_compact(torch.as_tensor(f3), **kw),
                      jc.marching_tetrahedra_device_compact(jnp.asarray(f3), **kw))
    fs = np.stack([_noisy_circle(rng, 23, 19) for _ in range(3)])
    kw = dict(tile_rows=4, max_segments=50)
    ref = jax.vmap(lambda x: jc.marching_squares_device_compact(x, **kw))(jnp.asarray(fs))
    _same_compact(tc.marching_squares_device_compact(torch.as_tensor(fs), **kw), ref)


def test_compact_extractors_edge_densities():
    """An empty field; checkerboards that cut every cell, where the default
    per-tile cap overflows exactly when a tile spans more than one plane."""
    f0 = np.ones((7, 8, 9), np.float32)
    out = tc.marching_tetrahedra_device_compact(torch.as_tensor(f0), tile_planes=3)
    _same_compact(out, jc.marching_tetrahedra_device_compact(jnp.asarray(f0),
                                                             tile_planes=3))
    assert int(out[1]) == 0 and not bool(out[2])

    ii, jj, kk = np.mgrid[0:6, 0:6, 0:6]
    cb = (((ii + jj + kk) % 2) * 2.0 - 1.0).astype(np.float32)
    n = int(tc.marching_tetrahedra_device(torch.as_tensor(cb))[1].sum())
    assert n > 12 * 125 * 0.5
    for kw in (dict(max_triangles=n, tile_planes=2),
               dict(max_triangles=n, tile_planes=2, tile_capacity=2 * 125 * 12),
               dict(max_triangles=n, tile_planes=1)):
        out = tc.marching_tetrahedra_device_compact(torch.as_tensor(cb), **kw)
        _same_compact(out, jc.marching_tetrahedra_device_compact(jnp.asarray(cb), **kw))
        assert bool(out[2]) == (kw["tile_planes"] > 1 and "tile_capacity" not in kw)

    yy, xx = np.mgrid[0:7, 0:7]
    cb2 = (((yy + xx) % 2) * 2.0 - 1.0).astype(np.float32)
    n2 = int(tc.marching_squares_device(torch.as_tensor(cb2))[1].sum())
    kw = dict(max_segments=n2, tile_rows=3, tile_capacity=3 * 2 * 6)
    out = tc.marching_squares_device_compact(torch.as_tensor(cb2), **kw)
    _same_compact(out, jc.marching_squares_device_compact(jnp.asarray(cb2), **kw))
    assert int(out[1]) == n2 and not bool(out[2])


def test_compact_extractor_lanes():
    """A leading lane axis: each lane's buffer, count and flag are its own
    call's bits, and equal the reference's under vmap (2-D and 3-D, one
    lane overflowing)."""
    rng = np.random.default_rng(0)
    B, H, W = 4, 14, 17
    yy, xx = np.mgrid[0:H, 0:W]
    fs = np.stack([(np.hypot(yy - H / 2, xx - W / 2) - 4.0
                    + 0.4 * rng.standard_normal((H, W))) for _ in range(B)]
                  ).astype(np.float32)
    fs[2] = rng.standard_normal((H, W))          # a noisy lane past the cap
    kw = dict(max_segments=96, tile_rows=4)
    out = tc.marching_squares_device_compact(torch.as_tensor(fs), **kw)
    ref = jax.vmap(lambda f: jc.marching_squares_device_compact(f, **kw))(jnp.asarray(fs))
    _same_compact(out, ref)
    assert bool(out[2][2]) and not bool(out[2][0])
    for b in range(B):
        one = tc.marching_squares_device_compact(torch.as_tensor(fs[b]), **kw)
        assert torch.equal(out[0][b], one[0]) and int(out[1][b]) == int(one[1])
        assert bool(out[2][b]) == bool(one[2])

    f3 = np.stack([_noisy_sphere(rng, 7, 8, 9) for _ in range(3)])
    kw3 = dict(tile_planes=2, max_triangles=400)
    out = tc.marching_tetrahedra_device_compact(torch.as_tensor(f3), **kw3)
    ref = jax.vmap(lambda f: jc.marching_tetrahedra_device_compact(f, **kw3))(
        jnp.asarray(f3))
    _same_compact(out, ref)
    for b in range(3):
        one = tc.marching_tetrahedra_device_compact(torch.as_tensor(f3[b]), **kw3)
        assert torch.equal(out[0][b], one[0]) and int(out[1][b]) == int(one[1])


# ---- pipelines --------------------------------------------------------------

def test_marching_squares_device_in_pipeline():
    """assemble → solve → contour: the port's sdf_from_points and device
    extraction against the reference's frame under one jit."""
    rng = np.random.default_rng(0)
    grid = (32, 32)
    theta = rng.uniform(0, 2 * np.pi, 100)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    pts = (15.5 + 9.0 * nrm).astype(np.float32)
    kw = dict(tol=1e-4, preconditioner="multigrid", backend="xla")

    @jax.jit
    def frame(pts, nrm):
        x, info = fi.sdf_from_points(fi.Grid(grid), fi.Weights(model_2=0.3), pts, nrm,
                                     config=fi.SolverConfig(**kw))
        return x, info.converged

    xr, conv_r = frame(jnp.asarray(pts), jnp.asarray(nrm))
    x, info = ft.sdf_from_points(ft.Grid(grid), ft.Weights(model_2=0.3),
                                 torch.as_tensor(pts), torch.as_tensor(nrm),
                                 config=ft.SolverConfig(**kw))
    assert bool(conv_r) and bool(info.converged)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), atol=2e-3 * float(np.abs(xr).max()))
    segs, valid = tc.marching_squares_device(x)
    got = segs[valid].numpy()
    want = np.asarray(jc.marching_squares_device(xr)[0])[np.asarray(
        jc.marching_squares_device(xr)[1])]
    assert got.shape[0] > 10 and abs(got.shape[0] - want.shape[0]) <= 2
    d = np.hypot(got[..., 0] - 15.5, got[..., 1] - 15.5)
    assert np.all(np.abs(d - 9.0) < 2.0)


def test_marching_tetrahedra_device_compact_in_pipeline():
    """3-D: the port's solve → compact extraction at 24³ against the
    reference's frame: both converge without overflow, a sphere's worth of
    triangles near the radius-7 sphere, the areas within 1%."""
    rng = np.random.default_rng(0)
    grid = (24, 24, 24)
    u = rng.standard_normal((600, 3))
    nrm = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    pts = (11.5 + 7.0 * nrm).astype(np.float32)
    kw = dict(tol=1e-4, preconditioner="multigrid", backend="xla", mg_cycle="v")

    @jax.jit
    def frame(pts, nrm):
        x, info = fi.sdf_from_points(fi.Grid(grid), fi.Weights(model_2=0.3), pts, nrm,
                                     config=fi.SolverConfig(**kw))
        tris, count, ovf = jc.marching_tetrahedra_device_compact(x)
        return tris, count, ovf, info.converged

    tris_r, count_r, ovf_r, conv_r = frame(jnp.asarray(pts), jnp.asarray(nrm))
    x, info = ft.sdf_from_points(ft.Grid(grid), ft.Weights(model_2=0.3),
                                 torch.as_tensor(pts), torch.as_tensor(nrm),
                                 config=ft.SolverConfig(**kw))
    tris, count, ovf = tc.marching_tetrahedra_device_compact(x)
    assert bool(conv_r) and bool(info.converged)
    assert not bool(ovf) and not bool(ovf_r)

    def area(t):
        a, b, c = t[:, 0], t[:, 1], t[:, 2]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()

    tris = tris[:int(count)].numpy().astype(np.float64)
    tris_r = np.asarray(tris_r)[:int(count_r)].astype(np.float64)
    assert tris.shape[0] > 500
    np.testing.assert_allclose(np.linalg.norm(tris.reshape(-1, 3) - 11.5, axis=1), 7.0,
                               atol=0.5)
    np.testing.assert_allclose(area(tris), area(tris_r), rtol=0.01)
