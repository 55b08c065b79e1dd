"""Device prep: the packed wire buffer -> the DP kernel's operands.

Port of ``multiz_tpu/ops/yama_pack.py``'s ``_cats`` / ``_col_stats`` /
``_prep_one`` and the wire decode of ``_device_batch``, as batched torch
ops (the JAX package runs them as XLA, not Pallas). The operands are
laid out for the GPU kernel rather than the TPU one:

* ``astat`` (B, m_pad+1, 12): the A-side per-row scalars, row r using A
  column r (1-based; row 0 is zero);
* ``bstat`` (B, 14, n_pad+2): the B-side per-column statistics,
  stat-major so that neighbouring kernel lanes read neighbouring words,
  indexed by the 1-based dp column (column 0 and n_pad+1 are zero);
  the last two rows are the column prefix sums that rebase the I-chain
  offsets (the JAX kernel's per-chunk ``S1``/``S2``), taken over whole
  rows instead of 128-aligned chunk windows;
* ``lb``/``rb`` (B, m_pad+1) int32, padded beyond M with LB[M]/RB[M].

All arithmetic is int32 and wraps like the JAX code's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scores import ScoreTensors

# astat slots (per row)
(AS_A0, AS_A1, AS_PA0, AS_PA1, AS_PA2, AS_PA3,
 AS_H0, AS_H1, AS_H2, AS_H3, AS_H4, AS_H5) = range(12)
NASTAT = 12

# bstat rows (per column); mirrored in csrc/yama_dp.cu
(BS_B0, BS_B1, BS_PB0, BS_PB1, BS_PB2, BS_PB3,
 BS_SR0, BS_SR1, BS_SR2, BS_SR3, BS_SR4, BS_SR5, BS_S1, BS_S2) = range(14)
NBSTAT = 14

I32 = torch.int32


class DPOperands(NamedTuple):
    lb: torch.Tensor  # (B, m_pad+1) int32
    rb: torch.Tensor  # (B, m_pad+1) int32
    mnkl: torch.Tensor  # (B, 4) int32: M, N, K, L
    astat: torch.Tensor  # (B, m_pad+1, NASTAT) int32
    bstat: torch.Tensor  # (B, NBSTAT, n_pad+2) int32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wire_layout(nb: int, m_pad: int, n_pad: int, Kp: int, Lp: int) -> dict:
    """Byte offsets of one bucket's wire buffer.

    Category nibbles of A (nb, Kp/2, m_pad) and B (nb, Lp/2, n_pad),
    then LB, RB (nb, m_pad+1) and M/N/K/L (nb, 4) as int32 at 4-byte
    aligned offsets (so the device side views them without a copy)."""
    mp1 = m_pad + 1
    o = {"A": 0, "B": nb * -(-Kp // 2) * m_pad}
    o["LB"] = _round_up(o["B"] + nb * -(-Lp // 2) * n_pad, 4)
    o["RB"] = o["LB"] + nb * mp1 * 4
    o["MNKL"] = o["RB"] + nb * mp1 * 4
    o["end"] = o["MNKL"] + nb * 16
    return o


def decode_wire(buf: torch.Tensor, nb, m_pad, n_pad, Kp, Lp):
    """(uint8 wire buffer) -> Atex, Btex, LB, RB, MNKL views."""
    o = wire_layout(nb, m_pad, n_pad, Kp, Lp)
    mp1 = m_pad + 1
    Atex = buf[o["A"]:o["B"]].view(nb, -(-Kp // 2), m_pad)
    Btex = buf[o["B"]:o["B"] + nb * -(-Lp // 2) * n_pad].view(
        nb, -(-Lp // 2), n_pad
    )
    LB = buf[o["LB"]:o["RB"]].view(I32).view(nb, mp1)
    RB = buf[o["RB"]:o["MNKL"]].view(I32).view(nb, mp1)
    MNKL = buf[o["MNKL"]:o["end"]].view(I32).view(nb, 4)
    return Atex, Btex, LB, RB, MNKL


def col_stats(packed: torch.Tensor, nrows: torch.Tensor):
    """Per-column stats of packed category nibbles (B, rp2, cols).

    The low nibble of packed row p is alignment row p, the high nibble
    row p + rp2 (see ``multiz_tpu/ops/yama_pack.py:_cats``); rows at or
    beyond ``nrows`` (B,) are padding. Returns hist (B, 6, cols), nond,
    ndash (B, cols) and the four dash-pair counts (B, cols) with the
    first-column quirk (``multiz_tpu/yama.py:104-107``)."""
    cat = torch.cat([packed & 0x0F, packed >> 4], dim=1).to(I32)
    rows = torch.arange(cat.shape[1], device=cat.device, dtype=I32)
    rmask = rows[None, :, None] < nrows[:, None, None]  # (B, R, 1)
    hist = torch.stack(
        [((cat == c) & rmask).sum(1, dtype=I32) for c in range(6)], dim=1
    )
    dash = (cat == 4) & rmask
    ndash = hist[:, 4]
    nond = rmask.sum(1, dtype=I32) - ndash
    f = torch.cat([dash[:, :, :1], dash[:, :, :-1]], dim=2)  # previous column
    s = dash
    p00 = (~f & ~s & rmask).sum(1, dtype=I32)
    p01 = (~f & s & rmask).sum(1, dtype=I32)
    p10 = (f & ~s & rmask).sum(1, dtype=I32)
    p11 = (f & s & rmask).sum(1, dtype=I32)
    # first column: first-bit forced 0 (mz_yama.c:128-129)
    zero = torch.zeros_like(nond[:, :1])
    p00 = torch.cat([nond[:, :1], p00[:, 1:]], dim=1)
    p01 = torch.cat([ndash[:, :1], p01[:, 1:]], dim=1)
    p10 = torch.cat([zero, p10[:, 1:]], dim=1)
    p11 = torch.cat([zero, p11[:, 1:]], dim=1)
    return hist, nond, ndash, (p00, p01, p10, p11)


def prep(Atex, Btex, LB, RB, MNKL, st: ScoreTensors) -> DPOperands:
    """Kernel operands for one bucket (every tensor on one device)."""
    B = Atex.shape[0]
    dev = Atex.device
    K = MNKL[:, 2]
    L = MNKL[:, 3]
    go, ge = st.gap_open, st.gap_extend

    histA, a0, a1, paA = col_stats(Atex, K)  # (B, ., m_pad)
    astat = torch.stack(
        [a0, a1, *paA, *histA.unbind(1)], dim=2
    )  # (B, m_pad, NASTAT)
    astat = torch.cat(
        [torch.zeros((B, 1, NASTAT), dtype=I32, device=dev), astat], dim=1
    )

    histB, b0, b1, pbB = col_stats(Btex, L)  # (B, ., n_pad)
    # ss_cat @ histB as six broadcast multiply-adds: CUDA matmul takes
    # no int32
    ss = st.ss_cat
    sub_right = [
        sum(ss[k, j] * histB[:, j] for j in range(6)) for k in range(6)
    ]
    Kc = K[:, None]
    e = b0 * Kc * ge
    zIe = go * Kc * pbB[2] + e
    cols = torch.stack(
        [b0, b1, *pbB, *sub_right, zIe, e], dim=1
    ).to(I32)  # (B, NBSTAT, n_pad); dp column c at index c-1
    zero = torch.zeros((B, NBSTAT, 1), dtype=I32, device=dev)
    bstat = torch.cat([zero, cols, zero], dim=2)  # column c at index c
    bstat[:, BS_S1] = torch.cumsum(bstat[:, BS_S1], dim=1, dtype=I32)
    bstat[:, BS_S2] = torch.cumsum(bstat[:, BS_S2], dim=1, dtype=I32)
    return DPOperands(
        lb=LB.contiguous(), rb=RB.contiguous(), mnkl=MNKL.contiguous(),
        astat=astat.contiguous(), bstat=bstat.contiguous(),
    )
