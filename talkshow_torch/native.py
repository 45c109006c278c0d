"""ctypes binding of the native (C++/OpenMP) mesh rasterizer (port of
talkshow_tpu/native.py's loader).

The source is the port's byte-equal copy of native/talkshow_native.cpp,
`csrc/talkshow_native.cpp`.  On first use it is built with

    g++ -O3 -fPIC -shared -fopenmp -std=c++17 -o talkshow_torch/_build/talkshow_native-<hash>.so

keyed by a hash of the source and the flags (`kernels/_build.build_shared`),
and loaded once per process.  A failed build or load raises: rendering has no
numpy fallback (`render._rasterize_numpy` is the plain version the tests
hold the rasterizer to).

Only `ts_rasterize` and `ts_num_threads` are bound.  The library's MFCC and
sinc resampler (`ts_mfcc`, `ts_resample_sinc`) are not: the port computes
the MFCC and the resampling in PyTorch on the pipeline's device
(`ops/audio.py`, the SHOW loader since it was ported).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from talkshow_torch.kernels import _build

SOURCE = _build.CSRC / "talkshow_native.cpp"
GXX = ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17"]

_lock = threading.Lock()
_lib: list = []


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library with its signatures set."""
    with _lock:
        if not _lib:
            lib = ctypes.CDLL(str(_build.build_shared(SOURCE, GXX)))
            f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
            lib.ts_num_threads.restype = ctypes.c_int32
            lib.ts_num_threads.argtypes = []
            lib.ts_rasterize.restype = ctypes.c_int32
            lib.ts_rasterize.argtypes = [
                f32p, ctypes.c_int64, i32p, ctypes.c_int64,     # verts, faces
                ctypes.c_float, ctypes.c_float,                 # xmag, ymag
                ctypes.c_float, ctypes.c_float,                 # cam_y, cam_z
                f32p, ctypes.c_int32, ctypes.c_float,           # lights, n, ambient
                f32p, ctypes.c_int32, ctypes.c_int32,           # color, w, h
                ctypes.POINTER(ctypes.c_uint8)]                 # out
            _lib.append(lib)
        return _lib[0]


def num_threads() -> int:
    """OpenMP threads the rasterizer uses."""
    return int(load_library().ts_num_threads())


def native_rasterize(verts: np.ndarray, faces: np.ndarray, xmag: float, ymag: float,
                     cam_y: float, cam_z: float, lights: np.ndarray, ambient: float,
                     base_color: np.ndarray, width: int, height: int) -> np.ndarray:
    """Z-buffered two-sided Lambert rasterization of (V, 3) vertices and
    (F, 3) faces -> (height, width, 3) uint8 RGB on white."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    lights = np.ascontiguousarray(lights, np.float32)
    base_color = np.ascontiguousarray(base_color, np.float32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"verts (V, 3) and faces (F, 3), got {verts.shape} and {faces.shape}")
    if lights.ndim != 2 or lights.shape[1] != 4 or base_color.shape != (3,):
        raise ValueError(f"lights (n, 4) and base_color (3,), got {lights.shape} and "
                         f"{base_color.shape}")
    out = np.empty((height, width, 3), np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = load_library().ts_rasterize(
        verts.ctypes.data_as(f32p), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        xmag, ymag, cam_y, cam_z, lights.ctypes.data_as(f32p), len(lights), ambient,
        base_color.ctypes.data_as(f32p), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"ts_rasterize failed with rc={rc} (-1: empty input, -2: a face "
                           f"index out of range)")
    return out
