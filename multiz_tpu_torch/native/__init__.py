"""Build/load the native host runtime (_mzcore C++ extension).

The extension is compiled on demand with g++ against the running
Python's headers (no numpy C API, buffer protocol only), cached in the
package's build directory (``multiz_tpu_torch/_build/``), rebuilt when
``mzcore.cpp`` is newer than it, and loaded via importlib as
``multiz_tpu_torch._mzcore``. A failed build raises: there is no
fallback, as there is none for the CUDA kernels (``_build.py``).
"""

from __future__ import annotations

import functools
import importlib.util
import os
import subprocess
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mzcore.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")


def _so_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_BUILD, "_mzcore" + suffix)


def build(force: bool = False) -> str:
    """Compile mzcore.cpp -> _mzcore.*.so; returns the path.

    Raises RuntimeError with g++'s message where the compile fails."""
    so = _so_path()
    if (
        not force
        and os.path.exists(so)
        and os.path.getmtime(so) >= os.path.getmtime(_SRC)
    ):
        return so
    include = sysconfig.get_paths()["include"]
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-funroll-loops", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}", _SRC, "-o", tmp,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build the native host runtime: {e}") from e
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            "cannot build the native host runtime: g++ exited with "
            f"{res.returncode}:\n{res.stderr.decode(errors='replace')}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.cache
def load():
    """Return the _mzcore module, building it if needed; raises where it
    cannot be built or loaded."""
    spec = importlib.util.spec_from_file_location(
        "multiz_tpu_torch._mzcore", build())
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
