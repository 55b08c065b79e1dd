"""Select the DP execution backend of the port's pipeline.

Modes, from MULTIZ_TPU_TORCH_DEVICE (default ``auto``):

  * ``packed`` — the packed DP stream (ops/yama_pack.py) on CUDA: every
                 device bucket runs the hand-written CUDA kernels;
  * ``packed-cpu`` — the same stream on the CPU, running the kernels'
                 plain versions (tests only);
  * ``host``   — per-problem host oracle loop (multiz_tpu.yama);
  * ``none``   — no batching: the merge scan calls the oracle inline.

``auto`` picks ``packed`` iff ``torch.cuda.is_available()``, else
``none``, as the JAX package picks nothing on a machine without a TPU.
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def host_batch(jobs, sp=None):
    """Per-problem host loop with the batch_fn signature."""
    from multiz_tpu.yama import yama_numpy

    return [yama_numpy(A, B, LB, RB, sp=sp) for (A, B, LB, RB) in jobs]


def default_batch_fn() -> Optional[Callable]:
    """Resolve the batch DP backend from MULTIZ_TPU_TORCH_DEVICE."""
    mode = os.environ.get("MULTIZ_TPU_TORCH_DEVICE", "auto").lower()
    if mode in ("0", "off", "none"):
        return None
    if mode == "host":
        return host_batch
    import torch

    from .yama_pack import batch_fn_for

    if mode == "packed":
        return batch_fn_for("cuda")
    if mode == "packed-cpu":
        return batch_fn_for("cpu")
    if mode != "auto":
        raise ValueError(f"MULTIZ_TPU_TORCH_DEVICE={mode!r}: unknown mode")
    return batch_fn_for("cuda") if torch.cuda.is_available() else None
