"""Build and load the CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

The sources are compiled at first use into one shared library with a
plain C interface under ``multiz_tpu_torch/_build/`` and rebuilt when a
source is newer than the library. A failed build raises: there is no
fallback, so a caller on a CUDA tensor either runs the kernels or fails.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB = os.path.join(BUILD_DIR, "libmz_kernels.so")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every entry point returns cudaGetLastError())
_SIGNATURES = {
    # lb, rb, mnkl, astat, bstat, flags, last, B, mp1, nb, fw, go, ge, stream
    "yama_dp_launch": (_P,) * 7 + (_I,) * 6 + (_P,),
    # flags, lb, mnkl, last, payload, B, mp1, fw, pw, stream
    "yama_tb_launch": (_P,) * 5 + (_I,) * 4 + (_P,),
}

_lib = None
build_seconds = None  # wall time of the last compile in this process


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(force: bool = False, extra_flags=()) -> str:
    """Compile every ``csrc/*.cu`` into ``LIB``; returns nvcc's output.

    Raises RuntimeError if nvcc is not on PATH or the compile fails."""
    global build_seconds
    srcs = sources()
    deps = srcs + glob.glob(os.path.join(CSRC, "*.cuh"))
    if (
        not force
        and os.path.exists(LIB)
        and os.path.getmtime(LIB) >= max(os.path.getmtime(p) for p in deps)
    ):
        return ""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH: cannot build the kernels")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    return res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every argtype set."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
