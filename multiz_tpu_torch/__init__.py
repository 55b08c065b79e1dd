"""multiz_tpu_torch — the multiz/TBA aligner on PyTorch and hand-written CUDA.

A port of ``multiz_tpu``'s device path to one NVIDIA GPU. Only the
modules of ``multiz_tpu`` that import JAX are ported: the packed DP
stream (``ops/yama_pack.py``) with its device prep (``ops/prep.py``),
the banded DP forward kernel (``ops/yama_dp.py``, ``csrc/yama_dp.cu``),
the traceback kernel (``ops/yama_tb.py``, ``csrc/yama_tb.cu``), the
backend dispatch and the three CLIs that pick a backend. Everything
framework-free (MAF I/O, scoring, pre_yama, the merge scan, tba/roast,
the native C++ host runtime) is imported from ``multiz_tpu`` as it is.

Importing this package never imports jax.
"""

__version__ = "0.1.0"
