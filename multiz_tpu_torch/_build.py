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
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB = os.path.join(BUILD_DIR, "libmz_kernels.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every entry point returns cudaGetLastError())
_SIGNATURES = {
    # lb, rb, mnkl, astat, bstat, flags, last, B, mp1, nb, fw, go, ge,
    # per_thread, per_block, stream
    "yama_dp_launch": (_P,) * 7 + (_I,) * 8 + (_P,),
    # flags, lb, mnkl, last, payload, B, mp1, fw, pw, rows, per_block,
    # smem_bytes, stream
    "yama_tb_launch": (_P,) * 5 + (_I,) * 7 + (_P,),
    # atex, btex, mnkl, ss_cat, astat, bstat, B, m_pad, n_pad, kp2, lp2,
    # go, ge, path, cpl, warps, cluster, grid, stream
    "yama_prep_launch": (_P,) * 6 + (_I,) * 13 + (_P,),
    # histA, a0, a1, pa, histB, b0, b1, pb, LB, RB, M, N, K, L, ss_cat,
    # flags, last, scratch, B, m_pad, n_pad, go, ge, per_thread,
    # per_block, stream
    "yama_full_dp_launch": (_P,) * 18 + (_I,) * 7 + (_P,),
    # flags, LB, RB, M, N, lastC, lastD, lastI, script, nedit, B, m_pad,
    # n_pad, per_block, stream
    "yama_full_tb_launch": (_P,) * 10 + (_I,) * 4 + (_P,),
}

_lib = None
build_seconds = None  # wall time of the last compile in this process
# concurrent tree merges (tba_run(parallel=N)) launch from several
# threads: one lock for the first load and one for the launch counters
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(force: bool = False, extra_flags=()) -> str:
    """Compile every ``csrc/*.cu`` into ``LIB``, one nvcc per source, all
    started together, then link them; returns nvcc's output.

    Raises RuntimeError if nvcc is not on PATH or a step fails."""
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
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = []
    try:
        for s, o in zip(srcs, objs):
            cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", o, s]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        out = []
        for cmd, p in procs:
            so, se = p.communicate()
            out.append(so + se)
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{se}")
        cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
            )
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    return "".join(out) + res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every argtype set."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                build()
                lib = ctypes.CDLL(LIB)
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def count_launch(wrapper, path: str | None = None) -> None:
    """Add one to ``wrapper.launches``, and to ``wrapper.paths[path]``
    where the kernel has paths; every kernel wrapper counts under the
    same lock, so counts over concurrent merges are exact."""
    with _count_lock:
        wrapper.launches += 1
        if path is not None:
            wrapper.paths[path] += 1


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
