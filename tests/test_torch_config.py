"""The port's configuration objects mirror the reference's exactly, so one
configuration drives either package and the two cannot drift apart."""

import dataclasses

import pytest

import field_interpolation_tpu as fi
import field_interpolation_tpu_torch as ft


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["Grid", "Weights", "SolverConfig"])
def test_fields_and_defaults_match_reference(name):
    assert _fields(getattr(ft, name)) == _fields(getattr(fi, name))


@pytest.mark.parametrize("shape", [(5,), (64, 64), (40, 48), (7, 5, 3), (2, 2)])
def test_grid_geometry_matches_reference(shape):
    ref, port = fi.Grid(shape), ft.Grid(shape)
    assert port.shape == ref.shape
    assert port.ndim == ref.ndim
    assert port.num_nodes == ref.num_nodes
    assert port.strides == ref.strides
    assert port.num_corners == ref.num_corners
    assert port.coarsen().shape == ref.coarsen().shape


@pytest.mark.parametrize("shape", [(), (1, 4), (4, 4, 4, 4)])
def test_grid_rejects_what_the_reference_rejects(shape):
    with pytest.raises(ValueError):
        fi.Grid(shape)
    with pytest.raises(ValueError):
        ft.Grid(shape)


def test_grid_helpers_match_reference():
    assert ft.grid_2d(7, 5).shape == fi.grid_2d(7, 5).shape
    assert ft.grid_3d(7, 5, 3).shape == fi.grid_3d(7, 5, 3).shape


@pytest.mark.parametrize("kw", [dict(), dict(model_0=0.1, model_2=0.0),
                                dict(model_1=0.2, model_2=1.0, model_3=0.4)])
def test_weights_methods_match_reference(kw):
    ref, port = fi.Weights(**kw), ft.Weights(**kw)
    assert port.active_orders() == ref.active_orders()
    assert [port.model_weight(k) for k in range(4)] == \
        [ref.model_weight(k) for k in range(4)]
    f = (2.0, 1.0, 0.5, 0.25)
    assert dataclasses.astuple(port.scaled_model(f)) == \
        dataclasses.astuple(ref.scaled_model(f))
