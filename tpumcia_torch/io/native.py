"""ctypes bindings for the native host-side packer (``native/packer.cpp``,
the source the JAX package builds too; counterpart of ``tpumcia.io.native``).

The library is built at first use with g++ (-O3 -shared) into
``build/tpumcia_torch/`` beside the package, keyed by a hash of the source,
the flags and the CPU's features (``-march=native``), as the CUDA kernels
are keyed by theirs. It packs and quantizes on the host,
so every entry point keeps its pure-numpy path for a machine without a
toolchain (:func:`pack_objects_numpy`, :func:`quantize_u16_numpy`, which
the native paths are held against); :func:`get_lib` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from tpumcia_torch._build import BUILD_DIR, PACKAGE_DIR

PACKER_SOURCE = PACKAGE_DIR.parent / "native" / "packer.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_features() -> str:
    """What ``-march=native`` compiled for: the CPU's feature flags, so that
    a build directory copied to another machine is not reused there."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.machine() + platform.processor()


def library_path():
    """Where the packer built from this checkout's source for this CPU
    lives."""
    h = hashlib.sha256(
        PACKER_SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode() + _cpu_features().encode())
    return BUILD_DIR / f"libtpumcia_packer_{h.hexdigest()[:16]}.so"


def _build(path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(PACKER_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return True


def get_lib():
    """The loaded native library, built if needed; None where the source or
    the compiler is missing."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not PACKER_SOURCE.exists():
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        c_long_p = ctypes.POINTER(ctypes.c_long)
        pp = ctypes.POINTER(ctypes.c_void_p)
        for name in ("tpumcia_pack_u8", "tpumcia_pack_u16"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [pp, c_long_p, c_long_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_int]
        q = lib.tpumcia_quantize_u16_to_u8
        q.restype = None
        q.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                      ctypes.c_long, ctypes.c_int]
        _lib = lib
        return _lib


def pack_objects(
    arrays: list[np.ndarray],
    target_hw: tuple[int, int],
    *,
    num_threads: int = 0,
) -> np.ndarray:
    """Center crop/pad a list of (h, w, c) arrays (uint8 or uint16, shared c
    and dtype) into one (B, H, W, c) batch: the native packer when it is
    available, else :func:`pack_objects_numpy`."""
    c, dtype = _check_objects(arrays)
    lib = get_lib()
    if lib is not None and dtype in (np.uint8, np.uint16):
        H, W = target_hw
        out = np.empty((len(arrays), H, W, c), dtype=dtype)
        arrays = [np.ascontiguousarray(a) for a in arrays]
        n = len(arrays)
        ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
        )
        hs = (ctypes.c_long * n)(*[a.shape[0] for a in arrays])
        ws = (ctypes.c_long * n)(*[a.shape[1] for a in arrays])
        fn = lib.tpumcia_pack_u8 if dtype == np.uint8 else lib.tpumcia_pack_u16
        fn(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(hs, ctypes.POINTER(ctypes.c_long)),
            ctypes.cast(ws, ctypes.POINTER(ctypes.c_long)),
            n, c, out.ctypes.data_as(ctypes.c_void_p), H, W, num_threads,
        )
        return out
    return pack_objects_numpy(arrays, target_hw)


def _check_objects(arrays):
    if not arrays:
        raise ValueError("empty object list")
    c = arrays[0].shape[2]
    dtype = arrays[0].dtype
    if any(a.ndim != 3 or a.shape[2] != c or a.dtype != dtype for a in arrays):
        raise ValueError("objects must share channel count and dtype")
    return c, dtype


def pack_objects_numpy(arrays: list[np.ndarray], target_hw: tuple[int, int]) -> np.ndarray:
    """:func:`pack_objects` in numpy, for any dtype."""
    c, dtype = _check_objects(arrays)
    H, W = target_hw
    out = np.empty((len(arrays), H, W, c), dtype=dtype)
    for i, a in enumerate(arrays):
        h, w = a.shape[0], a.shape[1]
        # centered crop (the floor-division offsets of the C++ packer and of
        # preprocess.center_crop_or_pad)
        if h > H:
            top = (h - H) // 2
            a = a[top : top + H]
        if w > W:
            left = (w - W) // 2
            a = a[:, left : left + W]
        h2, w2 = a.shape[0], a.shape[1]
        pt = (H - h2) // 2
        pl = (W - w2) // 2
        out[i] = 0
        out[i, pt : pt + h2, pl : pl + w2] = a
    return out


def quantize_u16(
    src: np.ndarray, *, levels: int = 256, num_threads: int = 0
) -> np.ndarray:
    """uint16 -> uint8 level quantisation (v * levels / 65536): the native
    library when it is available, else :func:`quantize_u16_numpy`."""
    src = np.ascontiguousarray(src, dtype=np.uint16)
    lib = get_lib()
    if lib is not None:
        out = np.empty(src.shape, np.uint8)
        lib.tpumcia_quantize_u16_to_u8(
            src.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
            src.size, levels, num_threads,
        )
        return out
    return quantize_u16_numpy(src, levels=levels)


def quantize_u16_numpy(src: np.ndarray, *, levels: int = 256) -> np.ndarray:
    """:func:`quantize_u16` in numpy."""
    src = np.asarray(src, dtype=np.uint16)
    return np.minimum(
        (src.astype(np.int64) * levels) >> 16, levels - 1
    ).astype(np.uint8)
