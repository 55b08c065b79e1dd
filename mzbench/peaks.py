"""The card's peaks, for roofline shares.

int32: SMs x 64 INT32 lanes an SM a cycle (Hopper) x the card's maximum
SM clock, both read in the run. HBM: the data sheet's rate for the card
named (NVIDIA H100 SXM5 80 GB: 3.35 TB/s). The power limit is kept
beside them: a card set below its maximum runs slower under load.
"""

from __future__ import annotations

import subprocess

INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def smi(fields: str) -> list:
    """One card's ``nvidia-smi --query-gpu`` fields, as strings."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits",
         "-i", "0"], capture_output=True, text=True, timeout=30, check=True)
    return [f.strip() for f in out.stdout.strip().splitlines()[0].split(",")]


def read() -> dict:
    """{"name", "power_limit_w", "sm_clock_max_hz", "sms", "int32_per_s",
    "hbm_bytes_per_s" (None for a card not in the table)}."""
    import torch

    name, limit, clock = smi("name,power.limit,clocks.max.sm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = float(clock) * 1e6
    return {"name": name, "power_limit_w": float(limit),
            "sm_clock_max_hz": hz, "sms": sms,
            "int32_per_s": sms * INT32_LANES_PER_SM * hz,
            "hbm_bytes_per_s": HBM_BYTES_PER_S.get(name)}
