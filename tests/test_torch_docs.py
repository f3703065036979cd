"""Doc-rot guard for docs/torch_api.md, as tests/test_docs.py is for
docs/api.md: every backticked symbol resolves against the port
(`field_interpolation_tpu_torch`, its submodules and their public names),
and a span that names the reference (`fi.…`) resolves against the JAX
package. Non-code spans are skipped by shape."""

import builtins
import dataclasses
import importlib
import inspect
import re
from pathlib import Path

import field_interpolation_tpu as fi
import field_interpolation_tpu_torch as ft

DOC = Path(__file__).resolve().parents[1] / "docs" / "torch_api.md"
SUBMODULES = ["batch", "checkpoint", "constraints", "contour", "convert", "debugging", "diff",
              "explicit", "grid", "multigrid", "native", "operators", "parallel",
              "parallel.contour", "parallel.launch", "rows", "sdf", "session", "solver",
              "stencils", "utils", "visualize", "weights", "ops", "ops.cycle", "ops.pcg",
              "ops.smooth", "ops.stencil", "ops.stencil_ext"]
EXTERNAL = {"torch", "cuda", "device", "sm_90a", "auto", "prep", "debug", "spsolve"}


def _spaces():
    spaces = {"ft": ft, "field_interpolation_tpu_torch": ft, "fi": fi}
    for name in SUBMODULES:
        spaces[name] = importlib.import_module(f"field_interpolation_tpu_torch.{name}")
    return spaces


def _known(spaces):
    names = set()
    for key, mod in spaces.items():
        if key == "fi":
            continue
        for n in dir(mod):
            if n.startswith("_"):
                continue
            names.add(n)
            obj = getattr(mod, n)
            if inspect.isclass(obj):
                names.update(a for a in dir(obj) if not a.startswith("_"))
                if dataclasses.is_dataclass(obj):
                    names.update(f.name for f in dataclasses.fields(obj))
            if callable(obj):
                try:
                    names.update(inspect.signature(obj).parameters)
                except (ValueError, TypeError):
                    pass
    return names


def _resolves(token, spaces, known):
    head, *rest = token.split(".")
    if not rest:
        return token in known or token in spaces or hasattr(builtins, token)
    if token in spaces:
        return True
    obj = spaces.get(head)
    if obj is None:
        return False
    for part in rest:
        if not hasattr(obj, part) and inspect.ismodule(obj):
            try:   # a submodule the package does not import itself (fi.df)
                importlib.import_module(f"{obj.__name__}.{part}")
            except ImportError:
                return False
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_torch_api_md_symbols_resolve():
    text = DOC.read_text()
    spaces = _spaces()
    known = _known(spaces)
    failures, checked = [], 0
    for span in re.findall(r"`([^`]+)`", text):
        s = span.strip()
        if (" " in s or s.startswith(("-", "/", ".", '"')) or "=" in s or '"' in s
                or ".." in s or "^" in s or s.endswith((".md", ".py"))):
            continue
        s = s.split("(")[0]
        if not re.fullmatch(r"[A-Za-z_][\w.]*", s) or s in EXTERNAL or s.startswith("torch."):
            continue
        checked += 1
        if not _resolves(s, spaces, known):
            failures.append(s)
    assert checked > 100, checked
    assert not failures, f"unresolvable torch_api.md symbols: {sorted(set(failures))}"


def test_torch_api_md_names_every_explicit_and_native_name():
    """The page lists every public name the two row-level modules define."""
    from field_interpolation_tpu_torch import explicit, native
    text = DOC.read_text()
    for mod, prefix in ((explicit, "explicit."), (native, "native.")):
        defined = [k for k, v in vars(mod).items() if not k.startswith("_")
                   and getattr(v, "__module__", None) == mod.__name__]
        missing = [k for k in defined if f"`{prefix}{k}" not in text]
        assert not missing, (prefix, missing)
