"""Banded yama DP forward: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel ``multiz_tpu/ops/yama_pack.py:_kernel``
(launched by ``_pallas_dp``): the same int32 recurrence, the same
C>=D>I tie-breaking (mz_yama.c:138-154) and the same prefix-max
derivation of the in-row I chain, bit for bit.

Flag layout (the contract with ``ops/yama_tb.py``): ``flags`` (B,
m_pad+1, fw) uint8, row r band-local from LB[r] (lane j is dp column
LB[r]+j), ``fw`` lanes = the launch's widest band. Every in-band flag
``c | d<<2 | i<<4`` is stored, row 0 included; every other byte is 0.
``last`` (B, 3) int32 holds C, D, I at (M, N).

``dp_forward`` runs ``csrc/yama_dp.cu`` on CUDA tensors and the plain
version ``dp_forward_reference`` only on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .prep import (
    AS_A0, AS_A1, AS_H0, AS_PA0, AS_PA1, AS_PA2, AS_PA3, BS_B0, BS_B1,
    BS_PB0, BS_PB1, BS_PB2, BS_PB3, BS_S1, BS_S2, BS_SR0, NASTAT, NBSTAT,
    DPOperands,
)

MININT = -(2**30)  # multiz_tpu/yama.py:41
NEG_HUGE = -(2**30) - (2**29)  # multiz_tpu/ops/yama_jax.py:59
FLAG_C, FLAG_I, FLAG_D = 0, 1, 2
MAX_LANES = 1024  # one thread block per problem, one thread per lane

I32 = torch.int32


def _pick(x, y, z):
    """C>=D>I preference over three candidates -> (value, 2-bit flag)."""
    pick_c = (x >= y) & (x >= z)
    pick_d = ~pick_c & (y > z)
    val = torch.where(pick_c, x, torch.where(pick_d, y, z))
    flag = torch.where(
        pick_c, FLAG_C, torch.where(pick_d, FLAG_D, FLAG_I)
    ).to(I32)
    return val, flag


def _shift1(v, fill):
    """v[:, j-1] with ``fill`` at lane 0."""
    return torch.cat([torch.full_like(v[:, :1], fill), v[:, :-1]], dim=1)


def dp_forward_reference(ops: DPOperands, go: int, ge: int, fw: int):
    """The kernel's computation in torch on whole tensors, one row at a
    time; returns (flags, last) in the layout of the module doc."""
    lb, rb, mnkl, astat, bstat = ops
    B, mp1 = lb.shape
    dev = lb.device
    nb = bstat.shape[2]
    j = torch.arange(fw, device=dev, dtype=I32)[None, :]  # (1, fw)
    M, N, K, L = (mnkl[:, i:i + 1] for i in range(4))  # (B, 1) each
    minint = torch.tensor(MININT, dtype=I32, device=dev)

    def gather(row, idx):  # bstat row at columns idx (clamped)
        return torch.gather(bstat[:, row], 1, idx.clamp(0, nb - 1))

    def prev_at(buf, idx):  # band-local read of the previous row
        ok = (idx >= 0) & (idx < fw)
        return torch.where(
            ok, torch.gather(buf, 1, idx.clamp(0, fw - 1)), minint
        )

    # ---- row 0 (mz_yama.c:82-94): the I chain is -S2 ----
    rb0 = rb[:, :1]
    in0 = j <= rb0
    pC = torch.where(j == 0, 0, minint).to(I32).expand(B, fw).clone()
    pD = pC.clone()
    pI = torch.where(
        j == 0, 0, torch.where(in0, -gather(BS_S2, j.expand(B, fw)), minint)
    ).to(I32)
    flags = torch.zeros((B, mp1, fw), dtype=torch.uint8, device=dev)
    flags[:, 0] = torch.where((j >= 1) & in0, FLAG_I << 4, 0).to(torch.uint8)
    atN = j == N  # M == 0: (M, N) lies on row 0
    last = torch.stack(
        [(torch.where(atN, v, 0)).sum(1, dtype=I32) for v in (pC, pD, pI)],
        dim=1,
    )

    for r in range(1, int(M.max()) + 1 if B else 1):
        act = r <= M
        lbr, rbr = lb[:, r:r + 1], rb[:, r:r + 1]
        lbm1 = lb[:, r - 1:r]
        lbm2 = lb[:, r - 2:r - 1] if r >= 2 else lb[:, :1]
        a = [astat[:, r, k:k + 1] for k in range(NASTAT)]
        a0, a1 = a[AS_A0], a[AS_A1]
        pa0, pa1, pa2, pa3 = a[AS_PA0], a[AS_PA1], a[AS_PA2], a[AS_PA3]
        col = lbr + j
        in_band = col <= rbr
        bw = [gather(k, col) for k in range(NBSTAT)]
        b0w, b1w = bw[BS_B0], bw[BS_B1]
        pb0w, pb1w, pb2w, pb3w = bw[BS_PB0], bw[BS_PB1], bw[BS_PB2], bw[BS_PB3]
        not1 = r > 1
        live = r < M
        inner = (col > 0) & (col < N)
        gt1 = col > 1

        s = lbr - lbm1  # previous row's band starts s lanes further left
        upC, upD, upI = (prev_at(p, j + s) for p in (pC, pD, pI))
        dgC, dgD, dgI = (prev_at(p, j + s - 1) for p in (pC, pD, pI))

        # ---- D node ----
        eD = a0 * L * ge
        zero = torch.zeros_like(col)
        xD = torch.where(inner & (col > lbm2) & not1,
                         go * (pa0 * b0w + pa2 * L), zero) + eD
        yD = torch.where(inner & not1, go * pa2 * L, zero) + eD
        zD = torch.where(inner & (col > lbm1), go * a0 * L, zero) + eD
        D_new, flag_d = _pick(upC - xD, upD - yD, upI - zD)
        D_row = torch.where(in_band, D_new, minint)

        # ---- C node ----
        subw = sum(a[AS_H0 + k] * bw[BS_SR0 + k] for k in range(6))
        xC = torch.where(gt1 & (col > lbm2 + 1) & not1,
                         go * (pa0 * pb1w + pa1 * (pb0w + pb2w)
                               + pa2 * (pb1w + pb3w) + pa3 * pb2w), zero)
        yC = torch.where(gt1 & not1, go * ((pa1 + pa3) * b0w + pa2 * b1w),
                         zero)
        zC = torch.where(gt1 & (col > lbm1 + 1),
                         go * (a0 * (pb1w + pb3w) + a1 * pb2w), zero)
        C_new, flag_c = _pick(dgC - xC, dgD - yC, dgI - zC)
        maskC = in_band & (col > lbm1)
        C_row = torch.where(maskC, C_new + subw, minint)
        flag_c = torch.where(maskC, flag_c, 0)

        # ---- I node: prefix-max chain rebased at lb+1 ----
        xI = torch.where(live & (col > lbm1 + 1),
                         go * (a0 * (pb0w + pb2w) + a1 * pb2w), zero)
        yI = torch.where(live, go * K * b0w, zero)
        e = b0w * K * ge
        xv = _shift1(C_row, MININT) - xI
        yv = _shift1(D_row, MININT) - yI
        lb1 = lbr + 1
        base = torch.where(live, gather(BS_S1, lb1), gather(BS_S2, lb1))
        e_lb1 = gather(BS_B0, lb1) * K * ge
        run = torch.where(live, bw[BS_S1], bw[BS_S2])
        Pofs = torch.where(j >= 1, run - base + e_lb1, zero)
        from_y = xv < yv
        V = torch.maximum(xv, yv) - e + Pofs
        Vp = torch.where((j == 0) | ~in_band, minint, V)
        R = torch.cummax(Vp, dim=1).values
        Wprev = _shift1(R, NEG_HUGE)
        zwin = (Wprev > V) | ((Wprev == V) & from_y)
        flag_i = torch.where(
            j == 0, 0,
            torch.where(zwin, FLAG_I, torch.where(from_y, FLAG_D, FLAG_C)),
        )
        I_row = torch.where(in_band & (j >= 1), R - Pofs, minint)

        frow = torch.where(
            in_band, flag_c | (flag_d << 2) | (flag_i << 4), 0
        )
        flags[:, r] = torch.where(act, frow, 0).to(torch.uint8)
        pC = torch.where(act, C_row, pC)
        pD = torch.where(act, D_row, pD)
        pI = torch.where(act, I_row, pI)
        atN = (r == M) & (col == N)
        if bool(atN.any()):
            got = torch.stack(
                [torch.where(atN, v, 0).sum(1, dtype=I32)
                 for v in (C_row, D_row, I_row)], dim=1,
            )
            last = torch.where(atN.any(1, keepdim=True), got, last)
    return flags, last


def _check(ops: DPOperands, fw: int) -> None:
    lb, rb, mnkl, astat, bstat = ops
    B, mp1 = lb.shape
    dev = lb.device
    for name, t, shape in (
        ("lb", lb, (B, mp1)), ("rb", rb, (B, mp1)), ("mnkl", mnkl, (B, 4)),
        ("astat", astat, (B, mp1, NASTAT)),
        ("bstat", bstat, (B, NBSTAT, bstat.shape[2])),
    ):
        if t.dtype != I32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"dp_forward: {name} must be contiguous int32 "
                             f"on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"dp_forward: {name} shape {tuple(t.shape)}")
    if not 1 <= fw <= MAX_LANES:
        raise ValueError(f"dp_forward: band of {fw} lanes exceeds {MAX_LANES}")


def dp_forward(ops: DPOperands, go: int, ge: int, fw: int):
    """(flags, last) for one bucket: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. ``dp_forward.launches`` counts kernel
    launches."""
    _check(ops, fw)
    dev = ops.lb.device
    if dev.type == "cpu":
        return dp_forward_reference(ops, go, ge, fw)
    if dev.type != "cuda":
        raise ValueError(f"dp_forward: no kernel for device {dev}")
    lib = _build.load()
    B, mp1 = ops.lb.shape
    flags = torch.zeros((B, mp1, fw), dtype=torch.uint8, device=dev)
    last = torch.empty((B, 3), dtype=I32, device=dev)
    if B == 0:
        return flags, last
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.yama_dp_launch(
        ops.lb.data_ptr(), ops.rb.data_ptr(), ops.mnkl.data_ptr(),
        ops.astat.data_ptr(), ops.bstat.data_ptr(), flags.data_ptr(),
        last.data_ptr(), B, mp1, ops.bstat.shape[2], fw, go, ge, stream,
    )
    _build.check(rc, "yama_dp_launch")
    dp_forward.launches += 1
    return flags, last


dp_forward.launches = 0
