"""Traceback: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas kernel ``multiz_tpu/ops/yama_pack.py:_tb_kernel``
(launched by ``_pallas_traceback``): each walk starts at (M, N) on the
node that the last row's C/D/I pick (C, then D, preferred), follows
the 2-bit pointers of the flag store written by ``ops/yama_dp.py`` back
to (0, 0), and emits its edit ops newest-first.

Output: the payload contract of ``multiz_tpu/ops/yama_pack.py:_db_core``,
byte for byte: per problem ``[nedit LE32]`` then the ops packed 4 per
byte (op k in bits 2*(k&3) of byte k>>2), zero beyond. The payload is
``payload_width(m_pad, n_pad)`` bytes wide, room for M+N ops.

``traceback`` runs ``csrc/yama_tb.cu`` on CUDA tensors and the plain
version ``traceback_reference`` only on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .yama_dp import FLAG_C, FLAG_D, FLAG_I

I32 = torch.int32


def payload_width(m_pad: int, n_pad: int) -> int:
    """Bytes per problem: 4 (nedit) + m_pad+n_pad ops, 4-byte rows."""
    return 4 + -(-(m_pad + n_pad) // 16) * 4


def traceback_reference(flags, lb, mnkl, last, pw: int):
    """All walks of a bucket advanced together in torch, one step at a
    time; returns the (B, pw) uint8 payload."""
    B, mp1, fw = flags.shape
    dev = flags.device
    cap = 4 * (pw - 4)
    row = mnkl[:, 0].clone()
    col = mnkl[:, 1].clone()
    lc, ld, li = last.unbind(1)
    node = torch.where(
        (lc >= ld) & (lc >= li), FLAG_C, torch.where(ld >= li, FLAG_D, FLAG_I)
    ).to(I32)
    k = torch.zeros(B, dtype=I32, device=dev)
    ops = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    b = torch.arange(B, device=dev)
    flat = flags.reshape(B, mp1 * fw)
    for _ in range(cap):
        alive = (row >= 0) & ((row > 0) | (col > 0))
        if not bool(alive.any()):
            break
        rowc = row.clamp(0, mp1 - 1)
        jj = col - lb[b, rowc]
        ok = alive & (jj >= 0) & (jj < fw)
        idx = (rowc * fw + jj.clamp(0, fw - 1)).long()
        st = torch.where(ok, flat[b, idx].to(I32), 0)
        ops[b[alive], k[alive].long()] = node[alive].to(torch.uint8)
        is_i = node == FLAG_I
        is_d = node == FLAG_D
        nnode = torch.where(is_i, st >> 4,
                            torch.where(is_d, (st >> 2) & 3, st & 3))
        row = torch.where(alive & ~is_i, row - 1, row)
        col = torch.where(alive & ~is_d, col - 1, col)
        node = torch.where(alive, nnode, node)
        k = torch.where(alive, k + 1, k)
    shifts = torch.arange(4, device=dev, dtype=I32) * 2
    packed = (ops.view(B, cap // 4, 4).to(I32) << shifts).sum(2, dtype=I32)
    ne = torch.stack([(k >> s) & 0xFF for s in (0, 8, 16, 24)], dim=1)
    return torch.cat([ne, packed], dim=1).to(torch.uint8)


def traceback(flags, lb, mnkl, last, pw: int):
    """(B, pw) uint8 payload for one bucket: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. ``traceback.launches``
    counts kernel launches."""
    B, mp1, fw = flags.shape
    dev = flags.device
    for name, t, dtype, shape in (
        ("flags", flags, torch.uint8, (B, mp1, fw)),
        ("lb", lb, I32, (B, mp1)), ("mnkl", mnkl, I32, (B, 4)),
        ("last", last, I32, (B, 3)),
    ):
        if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"traceback: bad {name} {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if pw < 4 or pw % 4:
        raise ValueError(f"traceback: payload width {pw} not a multiple of 4")
    if dev.type == "cpu":
        return traceback_reference(flags, lb, mnkl, last, pw)
    if dev.type != "cuda":
        raise ValueError(f"traceback: no kernel for device {dev}")
    lib = _build.load()
    payload = torch.zeros((B, pw), dtype=torch.uint8, device=dev)
    if B == 0:
        return payload
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.yama_tb_launch(
        flags.data_ptr(), lb.data_ptr(), mnkl.data_ptr(), last.data_ptr(),
        payload.data_ptr(), B, mp1, fw, pw, stream,
    )
    _build.check(rc, "yama_tb_launch")
    traceback.launches += 1
    return payload


traceback.launches = 0
