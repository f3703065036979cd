"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at first use, into
``build/torch_kernels/`` at the repository root, under a name keyed by a
hash of the sources and flags, so a fresh checkout builds once and an edited
source rebuilds. Nothing here runs at import: the package imports on a host
with no CUDA toolkit and no card, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see csrc/*.cu).
_SIGNATURES = {
    # x, coeff, out, ndim, n0, n1, n2, w2_0..w2_3, diag, stream
    "fi_normal_apply": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    # x_ext, coeff, out, ndim, n0..n2 (local), g0..g2 (global start),
    # N0..N2 (global extents), r, w2_0..w2_3, diag, stream
    "fi_normal_apply_ext": (_P, _P, _P) + (_I,) * 11 + (_F,) * 4 + (_I, _P),
    # x_ext1, from_top, from_bot, coeff, out, n0, n1, g0, g1, N0, N1, r,
    # w2_0..w2_3, stream
    "fi_normal_apply_ext_striped": (_P,) * 5 + (_I,) * 7 + (_F,) * 4 + (_P,),
    # x, coeff, out, B, ndim, n0, n1, n2, w2_0..w2_3, diag, stream
    # r, z (null: from zero), coeff, sid, zout, tmp, res (null: not wanted),
    # ndim, n0, n1, n2, w2_0..w2_3, diag, cf (null: Jacobi), count,
    # from_zero, launches (out), stream
    "fi_smooth_phase": (_P,) * 7 + (_I,) * 4 + (_F,) * 4 + (_I, _P, _I, _I,
                                                          ctypes.POINTER(_I), _P),
    # r, z (null: from zero), coeff [9, n0, n1], sid, zout, tmp, prev_a,
    # prev_b, res (null: not wanted), n0, n1, w2_0..w2_3, rho, cf (null:
    # Jacobi), count, from_zero, launches (out), stream
    "fi_multisweep2d_phase": (_P,) * 9 + (_I, _I) + (_F,) * 4 + (_I, _P, _I, _I,
                                                            ctypes.POINTER(_I), _P),
    # the halo, in nodes, the multi-sweep kernel is built for
    "fi_multisweep2d_max_halo": (),
    # pointer table, int table, w2 table (all host), stream
    "fi_pcg_segment": (_P, _P, _P, _P),
    "fi_pcg_segment_batch": (_P, _P, _P, _P),
    "fi_mg_cycle2d": (_P, _P, _P, _P),
}

_lock = threading.Lock()
_loaded: dict[str, object] = {}


def ensure_full_fp32(device) -> None:
    """Keep float32 products in full float32 on the card.

    PyTorch lets cuDNN (and, if a caller asked for it, cuBLAS) round float32
    inputs to TF32, which keeps about three decimal digits. The assembly's
    normal blocks, the dense coarse inverse and the transfer products all
    need full float32, or the preconditioner and the residuals drift at the
    1e-3 level. Called where the port first touches a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfi_torch_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise on the first that fails.
    Returns their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")
    return "".join(outs)


def build() -> tuple[Path, float, str]:
    """Compile the sources if their library is missing: one ``nvcc -c`` per
    source, all started together, then one link.

    Returns (path, seconds spent building, nvcc's output). The build runs in
    a temporary directory and the library is renamed into place, so a build
    cut short never leaves a half-written library behind."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(tmp) / f"{s.stem}.o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                        for s, o in zip(srcs, objs)])
        lib = str(Path(tmp) / path.name)
        log += _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
    return path, time.perf_counter() - t0, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.fi_error_string.argtypes = [ctypes.c_int]
            lib.fi_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = library().fi_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
