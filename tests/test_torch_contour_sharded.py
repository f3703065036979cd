"""Contours of a sharded field (`parallel.contour`) on four gloo ranks on the
CPU, against the reference's unsharded device extraction (the two cases of
tests/test_sharded.py:593-695, on the meshes four ranks allow).

The ranks start once for the file (`parallel.launch.run_ranks`) and run
every case of `CASES` through `parallel.cases.sharded_contour`. Each test
takes the union of the ranks' live rows, which must equal the reference's
`marching_squares_device` / `marching_tetrahedra_device` live set within
3e-5 (its bar, tests/test_sharded.py:630), with zeros past each rank's
count; a tiny per-rank cap must report the overflow on every rank."""

import jax.numpy as jnp
import numpy as np
import pytest

from field_interpolation_tpu.contour import (marching_squares_device,
                                             marching_tetrahedra_device)

from field_interpolation_tpu_torch.parallel.cases import run_cases
from field_interpolation_tpu_torch.parallel.launch import run_ranks


def _field2(shape, seed):
    rng = np.random.default_rng(seed)
    H, W = shape
    yy, xx = np.mgrid[0:H, 0:W]
    return (np.hypot(yy - H / 2, xx - W / 2) - 0.35 * min(H, W)
            + 0.6 * rng.standard_normal((H, W))).astype(np.float32)


def _field3(seed=9):
    rng = np.random.default_rng(seed)
    NI, NJ, NK = 8, 10, 12
    ii, jj, kk = np.mgrid[0:NI, 0:NJ, 0:NK]
    return (np.sqrt((ii - NI / 2) ** 2 + (jj - NJ / 2) ** 2 + (kk - NK / 2) ** 2) - 3.4
            + 0.5 * rng.standard_normal((NI, NJ, NK))).astype(np.float32)


# (mesh, field, level, tiny cap): 2-D fields on 2 x 2 and 4 x 1 whose noisy
# circle crosses every seam; one negative along the grid's edges, where the
# halo's zeros would cut false cells unless they are masked; a 3-D field on
# 2 x 2 x 1 (dim 2 whole, as a 2-axis mesh leaves it).
CASES = {
    "2x2": ((2, 2), _field2((16, 32), 5), 0.0, 2),
    "4x1": ((4, 1), _field2((32, 20), 6), 0.0, 2),
    "2x2 edge-negative": ((2, 2), -_field2((16, 32), 7), -0.3, 2),
    "2x2x1": ((2, 2, 1), _field3(), 0.0, 3),
}


@pytest.fixture(scope="module")
def parts():
    cases = [("sharded_contour", dict(field=f, mesh_shape=m, level=level, caps=(None, cap)))
             for m, f, level, cap in CASES.values()]
    res = run_ranks(run_cases, 4, cases, device="cpu")
    return {key: [r[k] for r in res] for k, key in enumerate(CASES)}


def _canon2(s):
    s = np.round(np.asarray(s, np.float64), 4)
    flip = s[:, 0, :].sum(-1) > s[:, 1, :].sum(-1)
    s[flip] = s[flip][:, ::-1, :]
    return s[np.lexsort((s[:, 1, 1], s[:, 1, 0], s[:, 0, 1], s[:, 0, 0]))]


def _canon3(t):
    t = np.round(np.asarray(t, np.float64), 4)
    for n in range(t.shape[0]):
        t[n] = t[n][np.lexsort((t[n, :, 2], t[n, :, 1], t[n, :, 0]))]
    return t[np.lexsort(t.reshape(t.shape[0], -1).T[::-1])]


def _check(ranks, field, level, extract, canon):
    runs = [r["runs"][0] for r in ranks]
    assert not any(run["overflowed"] for run in runs)
    assert all(run["zeros_past_count"] for run in runs)
    got = np.concatenate([run["items"].numpy() for run in runs], axis=0)
    items, valid = extract(jnp.asarray(field), level)
    want = np.asarray(items)[np.asarray(valid)]
    assert got.shape[0] == want.shape[0]
    np.testing.assert_allclose(canon(got), canon(want), atol=3e-5)
    # A rank's rows are its own cells': their first vertex lies in its block
    # (or on its +1 seam).
    for r, run in zip(ranks, runs):
        lo = np.array([sl.start for sl in r["block"]], np.float64)
        hi = np.array([sl.stop for sl in r["block"]], np.float64)
        pts = run["items"].numpy().reshape(-1, field.ndim)
        assert np.all(pts >= lo) and np.all(pts <= hi)
    # The tiny cap overflows, reported on every rank.
    tiny = [r["runs"][1] for r in ranks]
    assert all(run["overflowed"] for run in tiny)


@pytest.mark.parametrize("key", ["2x2", "4x1", "2x2 edge-negative"])
def test_marching_squares_sharded_matches_device(parts, key):
    _check(parts[key], *CASES[key][1:3], marching_squares_device, _canon2)


def test_marching_tetrahedra_sharded_matches_device(parts):
    _check(parts["2x2x1"], *CASES["2x2x1"][1:3], marching_tetrahedra_device, _canon3)
