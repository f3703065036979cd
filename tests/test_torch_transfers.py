"""The port's banded multigrid transfers against the reference's.

`prolong`, `make_restrict` and `restrict_diag` on 1-D, 2-D and 3-D arrays at
even and odd extents, on the same numpy-seeded inputs, within
1e-6·max|want| (float32, ≤ 3 products per output). The band tables are
made once per shape, dtype and device: a second transfer makes no new band
tensor, so a cycle on the card copies nothing from the host."""

import jax
import numpy as np
import pytest
import torch

from field_interpolation_tpu import multigrid as jmg

from field_interpolation_tpu_torch import multigrid as tmg

EXTENTS = [(64, 32), (63, 32), (37, 19), (5, 3)]  # (fine, coarse) per axis


def _shapes(n_f, n_c, ndim):
    """(fine, coarse) shapes: every axis resized, except the middle one of a
    3-D array, which keeps extent 4."""
    if ndim == 3:
        return (n_f, 4, n_f), (n_c, 4, n_c)
    return (n_f,) * ndim, (n_c,) * ndim


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("n_f,n_c", EXTENTS)
@pytest.mark.parametrize("op", ["prolong", "restrict", "restrict_diag"])
def test_transfer_matches_reference(op, n_f, n_c, ndim):
    fine, coarse = _shapes(n_f, n_c, ndim)
    rng = np.random.default_rng(n_f + ndim)
    if op == "prolong":
        x = rng.standard_normal(coarse).astype(np.float32)
        want = jax.jit(lambda a: jmg.prolong(a, fine))(x)
        got = tmg.prolong(torch.as_tensor(x), fine)
    elif op == "restrict":
        x = rng.standard_normal(fine).astype(np.float32)
        want = jax.jit(jmg.make_restrict(fine, coarse))(x)
        got = tmg.make_restrict(fine, coarse)(torch.as_tensor(x))
    else:
        x = rng.uniform(0.0, 2.0, fine).astype(np.float32)
        want = jax.jit(lambda a: jmg.restrict_diag(a, coarse))(x)
        got = tmg.restrict_diag(torch.as_tensor(x), coarse)
    assert got.dtype == torch.float32
    _close(got, want)


def test_transfers_on_a_leading_batch_axis():
    """The transfers act on the trailing axes, as the reference's do."""
    x = np.random.default_rng(1).standard_normal((3, 19, 10)).astype(np.float32)
    _close(tmg.prolong(torch.as_tensor(x), (37, 19)),
           jax.jit(lambda a: jmg.prolong(a, (37, 19)))(x))


def test_band_tensors_are_made_once():
    restrict = tmg.make_restrict((40, 38), (20, 19))
    x = torch.ones((40, 38), dtype=torch.float32)
    tmg._band_tensors.cache_clear()
    restrict(x)
    tmg.prolong(restrict(x), (40, 38))
    made = tmg._band_tensors.cache_info().misses
    assert made == 4  # two axes, restriction and prolongation bands
    restrict(x)
    tmg.make_restrict((40, 38), (20, 19))(x)
    tmg.prolong(restrict(x), (40, 38))
    assert tmg._band_tensors.cache_info().misses == made
    key = (20, 40, True, False, torch.float32, x.device)
    assert tmg._band_tensors(*key)[1] is tmg._band_tensors(*key)[1]
