"""The port's runnable examples.

Parity (tier-1): each reference example and its port are loaded from
``examples/`` with importlib and run on the same flags and seeds (the
reference on the CPU, as conftest pins JAX; the port with ``--device
cpu``). A stand-in for the package module records every solve of both, and
each frame is held to the reference's bars: ±2 iterations and
2e-3·max|x| (tests/test_solver.py:174-195; the circle at the precise bar,
2e-4·max|x|), and precise frames to a TRUE residual ≤ their tol against the
reference's explicit float64 normal equations.

Rot protection (`slow`, like tests/test_examples.py): each example at its
built-in size on the CPU, ending in the reference's lines and ``OK``."""

import importlib.util
import io
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.explicit import assemble_explicit, normal_equations

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SOLVES = ("sdf_from_points", "sdf_from_points_precise", "interpolate", "solve")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """Stands in for a package module: the entry points in ``SOLVES`` and
    ``Solver(...).solve`` record (name, args, kwargs, result) in ``calls``;
    every other name is the module's."""

    def __init__(self, mod):
        self._mod, self.calls = mod, []
        for name in SOLVES:
            setattr(self, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls.append((name, args, kwargs, out))
            return out
        return call

    def Solver(self, *args, **kwargs):  # noqa: N802 (the package's name)
        s = self._mod.Solver(*args, **kwargs)
        s.solve = self._wrap("Solver.solve", s.solve)
        return s

    def __getattr__(self, name):
        return getattr(self._mod, name)


def _argv(argv):
    old = sys.argv
    sys.argv = ["x", *argv]
    return old


def _run_main(mod, attr, argv, stdin=None):
    """``mod.main()`` under ``argv`` with ``mod.<attr>`` recorded (and
    ``stdin`` as sys.stdin); returns the recorded calls."""
    rec = Recorder(getattr(mod, attr))
    setattr(mod, attr, rec)
    old, old_in = _argv(argv), sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        mod.main()
    finally:
        sys.argv, sys.stdin = old, old_in
    return rec.calls


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jweights(w):
    return fi.Weights(**{k: getattr(w, k) for k in ("data_pos", "data_gradient", "model_0",
                                                    "model_1", "model_2", "model_3")})


def _true_rel(shape, weights, pts, values, normals, x):
    """The TRUE relative residual of ``x`` against the reference's explicit
    float64 normal equations."""
    eq = assemble_explicit(fi.Grid(tuple(shape)), _jweights(weights),
                           _np(pts).astype(np.float64), _np(values).astype(np.float64),
                           None if normals is None else _np(normals).astype(np.float64))
    AtA, Atb = normal_equations(eq, int(np.prod(shape)))
    r = Atb - AtA @ _np(x).astype(np.float64).ravel()
    return float(np.linalg.norm(r) / np.linalg.norm(Atb))


def _sdf_inputs(name, args, kwargs):
    """(grid shape, weights, positions, values, normals, tol) of an SDF call."""
    cfg = kwargs["config"]
    grid, w, pts, nrm = args[:4]
    return grid.shape, w, pts, np.zeros(len(pts)), nrm, cfg.tol


def _hold(got, want, bar=2e-3):
    """Each port frame against the reference's: the same entry point, ±2
    iterations, the field within ``bar``·max|x|."""
    assert [c[0] for c in got] == [c[0] for c in want]
    for k, (g, w) in enumerate(zip(got, want)):
        (xg, ig), (xw, iw) = g[3], w[3]
        assert bool(ig.converged) == bool(iw.converged), k
        assert abs(int(ig.iterations) - int(iw.iterations)) <= 2, (k, int(ig.iterations),
                                                                   int(iw.iterations))
        xw = _np(xw).astype(np.float64)
        np.testing.assert_allclose(_np(xg), xw, rtol=0, atol=bar * np.abs(xw).max(),
                                   err_msg=f"frame {k}")


def _hold_precise(calls):
    """Every precise frame's TRUE residual ≤ its tol (and ≤ 1e-6 where the
    tol is 1e-6); returns the tols seen."""
    tols = []
    for name, args, kwargs, (x, _) in calls:
        if name == "sdf_from_points_precise":
            shape, w, pts, vals, nrm, tol = _sdf_inputs(name, args, kwargs)
            assert x.dtype == torch.float64
            assert _true_rel(shape, w, pts, vals, nrm, x) <= tol
            tols.append(tol)
    return tols


# ---- parity --------------------------------------------------------------------------

DEMO = ["--grid", "32", "--no-render"]


def _demo(ref_args, port_args, stdin=None):
    """The demo app, reference and port, on the same flags: their calls."""
    ref, port = _load("demo_app"), _load("torch_demo_app")
    calls = {}
    for key, mod, extra in (("ref", ref, ["--cpu"]), ("port", port, ["--device", "cpu"])):
        recs = []

        class App(mod.App):
            def __init__(self, *args):
                super().__init__(*args)
                name = "fi" if key == "ref" else "ft"
                setattr(self, name, Recorder(getattr(self, name)))
                recs.append(getattr(self, name))

        mod.App = App
        old, old_in = _argv([*ref_args, *extra]), sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            if key == "port":
                mod.main([*port_args, *extra])
            else:
                mod.main()
        finally:
            sys.argv, sys.stdin = old, old_in
        calls[key] = recs[0].calls
    return calls["port"], calls["ref"]


def test_demo_app_one_shot_matches_reference(capsys):
    """One frame from the nested-iteration guess (``--fmg``), with the
    record line and the probe readout."""
    argv = DEMO + ["--records", "--probe", "15,15", "--fmg"]
    got, want = _demo(argv, argv)
    _hold(got, want)
    out, err = capsys.readouterr()
    assert out.count("[frame 0]") == 2 and out.count("probe (15,15)") == 2
    assert out.rstrip().endswith("OK")
    assert err.count('"iterations"') == 2  # one record line per frame, each side


def test_demo_app_sweep_matches_reference(capsys):
    argv = DEMO + ["--mode", "sweep", "--frames", "3"]
    got, want = _demo(argv, argv)
    assert len(got) == 3
    _hold(got, want)
    out = capsys.readouterr().out
    assert out.count("sweep 'noise=0.0:1.5': 3 frames") == 2


REPL = "w2 0.5\nshape star\nprecise\ntol 1e-6\ntol 1e-4\nfast\nquit\n"


def test_demo_app_repl_matches_reference(capsys):
    """The scripted REPL: a slider, a shape change (cold), precise frames at
    tol 1e-4 and 1e-6, back to fast."""
    argv = DEMO + ["--mode", "interactive"]
    got, want = _demo(argv, argv, stdin=REPL)
    assert len(got) == 7
    _hold(got, want)
    assert sorted(_hold_precise(got)) == [1e-6, 1e-4, 1e-4]
    assert capsys.readouterr().out.count("star n=800") == 10


@pytest.mark.parametrize("precise", [False, True], ids=["fast", "precise"])
def test_warmstart_modes_match_reference(precise):
    """The cold, prep and warm modes at 32², 3 frames each."""
    argv = ["--size", "32", "--frames", "3"] + (["--precise"] if precise else [])
    want = _run_main(_load("interactive_warmstart"), "fi", argv)
    got = _run_main(_load("torch_interactive_warmstart"), "ft", argv + ["--device", "cpu"])
    assert len(got) == 9
    _hold(got, want)
    if precise:
        for name, args, kwargs, (x, _) in got:
            if name == "Solver.solve":
                shape = (32, 32)
                solver_pts = next(c for c in got if c[0] == "sdf_from_points_precise")[1][2]
                assert _true_rel(shape, fi.Weights(model_2=0.3), solver_pts, args[0],
                                 kwargs["gradients"], x) <= 1e-6
        assert _hold_precise(got) == [1e-6] * 3


def test_sdf_circle_matches_reference(capsys):
    want = _run_main(_load("sdf_circle"), "fi", [])
    got = _run_main(_load("torch_sdf_circle"), "ft", ["--device", "cpu"])
    _hold(got, want, bar=2e-4)
    assert _hold_precise(got) == [1e-6]
    out = capsys.readouterr().out
    assert out.count("zero crossings on center row: 2") == 2 and out.count("OK") == 2


@pytest.mark.parametrize("argv", [["--size", "96", "--n", "7"],
                                  ["--size", "96", "--n", "7", "--gradients", "--w2", "0.5"],
                                  []],
                         ids=["presets", "gradients", "presets-192"])
def test_demo_1d_matches_reference(capsys, argv):
    """The 1-D panels at --size 96 --n 7, and the presets at the demo's
    default 192 nodes and 9 samples, where the order-1 and order-3 presets'
    float32 floor lies above the tol 1e-6 (the order-3 preset converges in
    neither package; each is held to the same flag and iterations)."""
    want = _run_main(_load("demo_1d"), "fi", argv + ["--cpu"])
    got = _run_main(_load("torch_demo_1d"), "ft", argv + ["--device", "cpu"])
    assert len(got) == (1 if "--gradients" in argv else 3)
    _hold(got, want)
    assert capsys.readouterr().out.count("sample RMSE=") == 2 * len(got)


@pytest.mark.parametrize("name", ["torch_sdf_circle", "torch_demo_app",
                                  "torch_interactive_warmstart", "torch_demo_1d",
                                  "torch_sharded_demo"])
def test_example_without_a_card_raises(name):
    """With no ``--device`` an example asks for the card and raises without
    one; it never falls back to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = _load(name)
    old = _argv([])
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main()
    finally:
        sys.argv = old


# ---- rot protection at the built-in sizes ---------------------------------------------

def _run(path, argv=("x",)):
    old = sys.argv
    sys.argv = list(argv)
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


@pytest.mark.slow
def test_example_torch_sdf_sphere_3d(capsys):
    _run("examples/torch_sdf_sphere_3d.py", ("x", "--device", "cpu"))
    out = capsys.readouterr().out
    assert "OK" in out and "device compact extraction" in out


@pytest.mark.slow
def test_example_torch_sdf_circle(capsys):
    _run("examples/torch_sdf_circle.py", ("x", "--device", "cpu"))
    assert "OK" in capsys.readouterr().out


@pytest.mark.slow
def test_example_torch_interactive_warmstart(capsys):
    _run("examples/torch_interactive_warmstart.py", ("x", "--device", "cpu"))
    out = capsys.readouterr().out
    assert all(f"{m:5s}:" in out for m in ("cold", "prep", "warm"))


@pytest.mark.slow
def test_example_torch_demo_app_oneshot(capsys):
    _run("examples/torch_demo_app.py",
         ("x", "--device", "cpu", "--grid", "64", "--n", "200", "--no-render", "--records"))
    out = capsys.readouterr().out
    assert "RMSE" in out and out.rstrip().endswith("OK")


@pytest.mark.slow
def test_example_torch_demo_app_sweep(capsys):
    _run("examples/torch_demo_app.py", ("x", "--device", "cpu", "--mode", "sweep"))
    out = capsys.readouterr().out
    assert "steady-state" in out and out.rstrip().endswith("OK")


@pytest.mark.slow
def test_example_torch_demo_app_interactive(capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO("w2 0.5\nshape star\nprecise\nfast\nquit\n"))
    _run("examples/torch_demo_app.py", ("x", "--device", "cpu", "--mode", "interactive",
                                        "--no-render"))
    out = capsys.readouterr().out
    assert out.count("[frame") == 5 and out.rstrip().endswith("OK")


@pytest.mark.slow
def test_example_torch_sharded_demo(capsys):
    # 128² instead of the demo's default 256², as tests/test_examples.py
    # runs the reference's: the same three code paths (unsharded, sharded,
    # sharded refined), eight gloo ranks on the CPU.
    _run("examples/torch_sharded_demo.py", ("x", "--device", "cpu", "--grid", "128",
                                            "--n", "400"))
    assert "OK" in capsys.readouterr().out


@pytest.mark.slow
def test_example_torch_demo_1d(capsys):
    _run("examples/torch_demo_1d.py", ("x", "--device", "cpu", "--size", "96", "--n", "7"))
    out = capsys.readouterr().out
    assert "order-2 (stiff rod)" in out and "RMSE" in out


@pytest.mark.slow
def test_example_torch_demo_1d_gradients(capsys):
    _run("examples/torch_demo_1d.py", ("x", "--device", "cpu", "--size", "96", "--n", "7",
                                       "--gradients", "--w2", "0.5"))
    out = capsys.readouterr().out
    assert "custom" in out and "RMSE" in out
