"""ctypes binding of the native (C++) data layer, native/colmap_io.cpp, as
in tpugs/data/native.py: the COLMAP binary parsers and the gaussian PLY
writer.

The library is built with g++ from the repository's source at first use,
into tpugs_torch/_build/native-<hash>/ (a hash of the source and the
flags; never into native/), and reused while they stay the same:

    g++ -O3 -fPIC -shared -std=c++17 -o <build>/libtpugs_native.so \\
        native/colmap_io.cpp

Unlike the reference, which falls back to numpy in silence, every entry
point raises NativeUnavailable when the library cannot be built or loaded,
and OSError when the native code cannot parse or write a file. The callers
that ask for it: data/colmap.py (unless TPUGS_NATIVE=0) and
io/ply.py::write_gaussian_ply.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "colmap_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libtpugs_native.so"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    """The native library was asked for and cannot be built or loaded."""


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build(source: Path) -> Path:
    """Compile `source` unless this hash is already built; returns the
    library's path. Raises NativeUnavailable with g++'s message."""
    if not source.is_file():
        raise NativeUnavailable(f"native source {source} not found")
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{LIB_NAME}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeUnavailable(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise NativeUnavailable(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeUnavailable(f"cannot load {path}: {e}") from e
    dp, u8p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8)
    lib.tpugs_free.argtypes = [ctypes.c_void_p]
    lib.tpugs_free.restype = None
    lib.tpugs_parse_points3d.restype = ctypes.c_int64
    lib.tpugs_parse_points3d.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(dp), ctypes.POINTER(u8p)]
    lib.tpugs_parse_cameras.restype = ctypes.c_int64
    lib.tpugs_parse_cameras.argtypes = [ctypes.c_char_p, ctypes.POINTER(dp)]
    lib.tpugs_parse_images.restype = ctypes.c_int64
    lib.tpugs_parse_images.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(dp), ctypes.POINTER(ctypes.c_char_p)]
    lib.tpugs_write_gaussian_ply.restype = ctypes.c_int
    lib.tpugs_write_gaussian_ply.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ] + [np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")] * 5
    return lib


def lib() -> ctypes.CDLL:
    """The loaded library, built from SOURCE on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build(SOURCE))
        return _lib


def _parsed(n: int, path: str) -> int:
    if n < 0:
        raise OSError(f"native parse of {path} failed: unreadable or "
                      f"malformed")
    return n


def parse_points3d(path: str):
    """-> (xyz [n, 3] float64, rgb [n, 3] uint8); tracks skipped."""
    lb = lib()
    xyz_p = ctypes.POINTER(ctypes.c_double)()
    rgb_p = ctypes.POINTER(ctypes.c_uint8)()
    n = _parsed(lb.tpugs_parse_points3d(os.fsencode(path), ctypes.byref(xyz_p),
                                        ctypes.byref(rgb_p)), path)
    try:
        xyz = np.ctypeslib.as_array(xyz_p, shape=(n, 3)).copy()
        rgb = np.ctypeslib.as_array(rgb_p, shape=(n, 3)).copy()
    finally:
        lb.tpugs_free(xyz_p)
        lb.tpugs_free(rgb_p)
    return xyz, rgb


def parse_cameras(path: str) -> np.ndarray:
    """-> records [n, 12] float64: camera_id, model_id, width, height,
    params[8] (zero-padded)."""
    lb = lib()
    rec_p = ctypes.POINTER(ctypes.c_double)()
    n = _parsed(lb.tpugs_parse_cameras(os.fsencode(path),
                                       ctypes.byref(rec_p)), path)
    try:
        return np.ctypeslib.as_array(rec_p, shape=(n, 12)).copy()
    finally:
        lb.tpugs_free(rec_p)


def parse_images(path: str):
    """-> (records [n, 9] float64: image_id, qvec, tvec, camera_id; names)."""
    lb = lib()
    rec_p = ctypes.POINTER(ctypes.c_double)()
    names_p = ctypes.c_char_p()
    n = _parsed(lb.tpugs_parse_images(os.fsencode(path), ctypes.byref(rec_p),
                                      ctypes.byref(names_p)), path)
    try:
        rec = np.ctypeslib.as_array(rec_p, shape=(n, 9)).copy()
        names = names_p.value.decode("utf-8").split("\n")[:n]
    finally:
        lb.tpugs_free(rec_p)
        lb.tpugs_free(ctypes.cast(names_p, ctypes.c_void_p))
    return rec, names


def write_gaussian_ply(path: str, means, sh, opacity_logits, log_scales,
                       quats) -> None:
    """The gaussian PLY, byte for byte io/ply.py::write_gaussian_ply_numpy's."""
    lb = lib()
    means = np.ascontiguousarray(means, np.float32)
    sh = np.ascontiguousarray(sh, np.float32)
    op = np.ascontiguousarray(opacity_logits, np.float32).reshape(-1)
    scales = np.ascontiguousarray(log_scales, np.float32)
    quats = np.ascontiguousarray(quats, np.float32)
    n, _, c = sh.shape
    for name, a, shape in (("means", means, (n, 3)), ("opacity_logits", op, (n,)),
                           ("log_scales", scales, (n, 3)),
                           ("quats", quats, (n, 4))):
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
    rc = lb.tpugs_write_gaussian_ply(os.fsencode(path), n, c, means,
                                     sh.reshape(n, -1), op, scales, quats)
    if rc != 0:
        raise OSError(f"native PLY write to {path} failed")
