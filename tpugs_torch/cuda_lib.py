"""Build and load the port's one kernel library, `libtpugs_kernels.so`.

The CUDA sources in `tpugs_torch/csrc/*.cu` export plain C functions and
include no PyTorch header, so one `nvcc` call builds them in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v \\
         -o tpugs_torch/_build/<hash>/libtpugs_kernels.so tpugs_torch/csrc/*.cu

The build runs at first use, into a directory keyed by a hash of the
sources and flags, and is reused while they stay the same. The library is
loaded with `ctypes`: every pointer and the CUDA stream go over as
`c_void_p`, every count as `c_int` or `c_longlong`. Each exported function
launches on the stream it is given and returns `cudaGetLastError()`;
`check` turns a nonzero code into an exception.

Guard words: a kernel that checks its inputs' contract on the device (the
align-copy, the interval segment sum, the two compositors) stores a
nonzero value into its word of mapped pinned host memory
(csrc/guard_words.cu, one word per entry of GUARDED) when they break it,
and never reads or writes outside its buffers. `check_guards` reads the words on the host, which does not
synchronise the device, and raises on a set one. `lib()`, which every
wrapper calls before its launch, calls it, so a violation raises at the
first launch after the stream has passed the kernel that found it, never
inside the launching call itself. A caller whose unit of work ends in a
synchronising host read calls it there too, so that the last launch of a
run is covered: the offline renderer after each frame, the Trainer after
each block of steps.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libtpugs_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argtypes; every function returns a cudaError_t as int.
SIGNATURES = {
    "tpugs_expand": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
    "tpugs_align_copy": [_I, _P, _L, _P, _P, _P, _I, _P, _L, _P, _P],
    "tpugs_composite_fwd": [_I, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P, _P, _P],
    "tpugs_composite_bwd": [_I, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P, _P, _I, _P, _P],
    "tpugs_composite_bwd_clusters": [_I, _I, _I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)],
    "tpugs_segreduce_sorted": [_I, _P, _L, _P, _I, _P, _P],
    "tpugs_segreduce_interval": [_I, _P, _P, _P, _I, _L, _P, _P, _P],
    "tpugs_guard_words": [_I, ctypes.POINTER(_P), ctypes.POINTER(_P)],
}
# The kernels with a guard word, in the order of the words, and what a set
# word (item + 1) says.
GUARDED = {
    "tpugs_align_copy": "tile {} has a segment that reads past attr_c, "
                        "writes past p_aligned or into the next tile's, or "
                        "does not start on a 128-column boundary",
    "tpugs_segreduce_interval": "gaussian {} has an interval outside "
                                "[0, exp_end)",
    "tpugs_composite_fwd": "tile {} has a segment [astart, astop) that is "
                           "reversed or lies outside [0, P_al)",
    "tpugs_composite_bwd": "tile {} has a segment [astart, astop) that is "
                           "reversed or lies outside [0, P_al)",
}

_lib = None
_guard_host = None  # the guard words, read on the host
_guard_device = 0  # their device address
build_seconds: float | None = None  # wall time of this process's build
build_log: str = ""  # nvcc's stderr (ptxas register and spill report)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):  # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless this hash is already built; returns its
    path. Raises with nvcc's stderr when the build fails."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources()]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    (out.parent / "nvcc.log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call, with its guard words;
    raises first if an earlier launch set one (check_guards)."""
    global _lib, _guard_host, _guard_device
    check_guards()
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        host, device = _P(), _P()
        check("tpugs_guard_words", handle.tpugs_guard_words(
            len(GUARDED), ctypes.byref(host), ctypes.byref(device)))
        _guard_host = (ctypes.c_int * len(GUARDED)).from_address(host.value)
        _guard_device = device.value
        _lib = handle
    return _lib


def guard_word(name: str) -> int:
    """Device address of kernel `name`'s guard word (after lib())."""
    return _guard_device + 4 * list(GUARDED).index(name)


def check_guards() -> None:
    """Raise ValueError if a kernel has set its guard word, and clear it.
    Reads host memory only: a launch still running has not set it yet."""
    if _guard_host is None:
        return
    for i, (name, what) in enumerate(GUARDED.items()):
        item = _guard_host[i]
        if item:
            _guard_host[i] = 0
            raise ValueError(f"{name}: inputs out of contract in an earlier "
                             f"launch: {what.format(item - 1)}")


def cluster_occupancy(device: int, tile_w: int, tile_h: int) -> tuple[int, int]:
    """(sub-tiles per tile, clusters of that many the card holds at once)
    for the backward compositor at tile_w x tile_h
    (cudaOccupancyMaxActiveClusters)."""
    g, n = ctypes.c_int(), ctypes.c_int()
    check("tpugs_composite_bwd_clusters", lib().tpugs_composite_bwd_clusters(
        device, tile_w, tile_h, ctypes.byref(g), ctypes.byref(n)))
    return g.value, n.value


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device,
            ndim: int | None = None) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
