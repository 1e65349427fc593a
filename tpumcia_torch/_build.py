"""Build the port's CUDA sources into one shared library and load it.

The sources under ``tpumcia_torch/csrc`` have a plain C interface, so they
are compiled with ``nvcc`` alone (no PyTorch headers) and bound with
``ctypes``. The build runs at first use, into ``build/tpumcia_torch/`` beside
the package, and is keyed by a hash of the sources and the flags: an
unchanged checkout reuses its library, an edited one rebuilds. A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tpumcia_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_Q = ctypes.c_longlong
# name -> (restype, argtypes) of every C entry the library exports
_SIGNATURES = {
    "tpumcia_glcm_stats": (
        _I,
        # img, mask, mask_channels, lut, batch, channels, H, W, L,
        # offsets (host ints), num_offsets, need_diff, cheap, table_bits,
        # hist, count, vmax, marg_l, marg_r, dout, sumsq, pairs, stream
        [_P, _P, _I, _P, _I, _I, _I, _I, _I,
         ctypes.POINTER(_I), _I, _I, _I, _I,
         _P, _P, _P, _P, _P, _P, _P, _P, _P],
    ),
    # H, W, L, masked, need_diff, table_bits, info (5 host ints)
    "tpumcia_glcm_launch_info": (_I, [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]),
    "tpumcia_glcm_stats_workspace": (
        _I,
        # img, mask, mask_channels, batch, channels, H, W, L, offsets (host
        # ints), num_offsets, table_bits, workspace, workspace_bytes, hist,
        # count, vmax, marg_l, marg_r, dout, sumsq, pairs, stream
        [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I, _I, _P, _Q,
         _P, _P, _P, _P, _P, _P, _P, _P, _P],
    ),
    # H, W, L, masked, table_bits, num_offsets, items, info (10 host long longs)
    "tpumcia_glcm_workspace_info": (_I, [_I, _I, _I, _I, _I, _I, _Q, ctypes.POINTER(_Q)]),
    "tpumcia_forest_apply": (
        _I,
        # X, N, F, perm, mask, repeats, D, nodes, num_nodes, roots, trees,
        # values, num_values, classes, out, stream
        [_P, _I, _I, _P, _P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    ),
    # num_nodes, num_values, classes, trees, lanes, info (5 host ints)
    "tpumcia_forest_launch_info": (_I, [_I, _I, _I, _I, _Q, ctypes.POINTER(_I)]),
    "tpumcia_cuda_error_string": (ctypes.c_char_p, [_I]),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "tpumcia_torch CUDA kernels are built from source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, float]:
    """Compile the sources if no library for their hash exists yet.
    Returns (library path, build seconds; 0.0 when it was already built).
    ``nvcc``'s output, ptxas resource lines included, is kept in
    ``build.log`` beside the library."""
    lib = BUILD_DIR / f"libtpumcia_torch_{_digest()}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library(path: Path | None = None) -> ctypes.CDLL:
    """The library built from this checkout's sources, or the one at
    ``path`` (built from another source), with the argtypes of each entry
    of :data:`_SIGNATURES` it exports set (each pointer and the stream as
    ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = ctypes.CDLL(str(path or build_library()[0]))
    for name, (restype, argtypes) in _SIGNATURES.items():
        if path is None or hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code:
        msg = load_library().tpumcia_cuda_error_string(code)
        raise RuntimeError(
            f"{what} failed: CUDA error {code} ({msg.decode() if msg else '?'})"
        )
