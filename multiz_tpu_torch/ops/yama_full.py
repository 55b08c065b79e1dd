"""The full-row batched yama DP: two CUDA kernels, their plain versions,
and the batch entry points.

Port of ``multiz_tpu/ops/yama_jax.py``: ``stack_jobs``, ``_yama_core``,
``_traceback_core``, ``yama_batch`` and ``yama_jax``. The recurrence is
the same, bit for bit: whole dp rows in absolute column coordinates
(n_pad+1 lanes, MININT outside the band), the in-row I chain solved by a
prefix max, C>=D>I tie-breaking (mz_yama.c:138-154), and int32
arithmetic that wraps as XLA's does.

The JAX module is plain XLA: ``vmap`` over a bucket and ``lax.scan``
over rows, one jitted program per bucket. Here ``yama_core`` and
``traceback_core`` run the two hand-written kernels of
``csrc/yama_full.cu`` on CUDA tensors, one launch each per bucket, and
their plain versions ``yama_core_reference`` and ``traceback_reference``
(a Python loop of torch ops over rows and over walk steps) only on CPU
tensors. The forward kernel has two paths, ``warp`` and ``block``;
``full_plan`` picks one per bucket from its bands on the host.
``full_dp_bound``, ``full_dp_chain_bound``, ``full_tb_bound`` and
``full_tb_chain_bound`` are the least times the card could take for one
launch. It is the counterpart of ``MULTIZ_TPU_DEVICE=jax``
(``ops/dispatch.py`` mode ``full``), not the production path, which is
``ops/yama_pack.py``.

On a ``(blocks, band)`` mesh (``parallel/sharding.py``) the dp columns
of each blocks row are cut over its band devices (``yama_core_cols``),
with the in-row chains carried from shard to shard. That forward stays
torch ops on every device (the JAX package runs it as XLA collectives
across chips); its joined flags go through ``traceback_core``.

Only CUDA and CPU tensors are taken; a CUDA device that is missing
raises (``parallel.sharding.require_device``), it is never replaced by
the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .. import scores as sc
from .. import yama as Y
from ..yama import _check_band

from ..parallel.sharding import pad_batch, require_device, shard_stacked
from ..scores import from_score_params
from .yama_dp import (
    CLOCK_HZ, DP_ROW_OPS, DP_ROW_SHUFFLES, FLAG_C, FLAG_D, FLAG_I,
    HBM_BYTES_PER_S, INT32_OPS_PER_S, MININT, NEG_HUGE, OP_CYCLES,
    OPS_PER_CELL, SHUFFLE_CYCLES, SMS, _pick, _shift1,
)
from .yama_pack import _pad_to, replay_script

I32 = torch.int32
U8 = torch.uint8

# csrc/yama_full.cu. The forward's block path: its threads (one column
# each in a tile of a row) and the ints of its column record (the loop
# invariants and the stored dp row), kept per problem in a global
# scratch buffer. Its warp path: windows up to FULL_WARP_LANES lanes, at
# most FULL_MAX_PER_BLOCK problems (warps) a block, operands loaded
# FULL_CHUNK rows ahead, flags staged FULL_FLUSH rows at a time. The
# traceback: one warp a walk, as many a block as the warp path; windows
# of TB_ROWS rows staged, TB_SLOT bytes of each row's band, the script
# staged TB_SCRIPT bytes at a time.
FULL_THREADS = 128
FULL_NREC = 15
FULL_WARP_LANES = 128
FULL_MAX_PER_BLOCK = 4
FULL_CHUNK = 32
FULL_FLUSH = 32
TB_ROWS = 32
TB_SLOT = 144
TB_SCRIPT = 1024
# Bound terms. The operations term counts the function's work, not the
# kernel's: the int32 operations of one band cell of row_step
# (multiz_tpu/ops/yama_jax.py:93-201: the D and C nodes' candidates,
# picks and flags, the sub_right @ ha product, the I chain's terms and
# its sum and max scan steps, the flag packing), the same recurrence as
# the packed DP's and so its count, yama_dp.OPS_PER_CELL. A row's
# dependent step is the packed DP's too (yama_dp.dp_chain_bound: the
# previous row's shifted read, the D and C nodes, this row's shift by a
# column, the max scan and I's rebase); the sum scan does not wait on
# the previous row. A traceback step: one read of its flag byte at the
# least latency of an L1 hit or a shared-memory read (GLOBAL_CYCLES) and
# FULL_TB_STEP_OPS operations (the row's normalisation and clamp, the
# address, the band test's select, the pointer's bit field, the row or
# column step).
GLOBAL_CYCLES = 32
FULL_TB_STEP_OPS = 8

STACK_KEYS = (
    "histA", "a0", "a1", "pa", "histB", "b0", "b1", "pb",
    "LB", "RB", "M", "N", "K", "L",
)


def _stack_shapes(m_pad: int, n_pad: int) -> dict:
    """Each stacked operand's shape past the batch dimension."""
    mp, np1 = m_pad + 1, n_pad + 1
    return {
        "histA": (mp, 6), "a0": (mp,), "a1": (mp,), "pa": (mp, 4),
        "histB": (np1, 6), "b0": (np1,), "b1": (np1,), "pb": (np1, 4),
        "LB": (mp,), "RB": (mp,), "M": (), "N": (), "K": (), "L": (),
    }


def stack_jobs(jobs, m_pad: int, n_pad: int, device="cpu") -> dict:
    """Stack same-bucket (A, B, LB, RB) problems into the batched
    operands, keyed by ``STACK_KEYS``: ``stack_host``'s arrays as int32
    tensors on ``device``."""
    return upload(stack_host(jobs, m_pad, n_pad), device)


def upload(host: dict, device) -> dict:
    """``stack_host``'s arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def stack_host(jobs, m_pad: int, n_pad: int) -> dict:
    """The batched operands of ``stack_jobs`` as int32 numpy arrays, keyed
    by ``STACK_KEYS``.

    Built as ``yama_jax.stack_jobs`` builds them: the column statistics
    are written straight into the batch buffers
    (``mzcore.colstats_into``)."""
    shapes = _stack_shapes(m_pad, n_pad)
    out = {k: np.zeros((len(jobs), *shapes[k]), np.int32)
           for k in STACK_KEYS}

    def fill(i, side, X):
        s = side.lower()
        ncol, nrow = X.shape
        Y._mzcore.colstats_into(
            np.ascontiguousarray(X), ncol, nrow, sc.BYTE2CAT,
            out["hist" + side][i], out[s + "0"][i], out[s + "1"][i],
            out["p" + s][i])

    for i, (A, B, LB, RB) in enumerate(jobs):
        M, K = A.shape
        N, L = B.shape
        fill(i, "A", A)
        fill(i, "B", B)
        out["LB"][i, : M + 1] = LB[: M + 1]
        out["RB"][i, : M + 1] = RB[: M + 1]
        out["LB"][i, M + 1 :] = LB[M]
        out["RB"][i, M + 1 :] = RB[M]
        out["M"][i], out["N"][i], out["K"][i], out["L"][i] = M, N, K, L
    return out


class FullPlan(NamedTuple):
    path: str  # "warp" or "block"
    per_thread: int  # band lanes a thread on the warp path, else 0
    per_block: int  # problems a block
    grid: int  # blocks
    threads: int  # threads a block
    window: int  # the bucket's widest window, lanes


def full_window(LB, RB, M, m_pad: int, n_pad: int) -> tuple:
    """(lanes, monotone) of a bucket's host band arrays (LB, RB (B,
    m_pad+1) and M (B,), numpy): its widest window, over each problem's
    rows r = 1..M, max(RB[r], RB[r-1]) - min(LB[r], LB[r-1]) + 1 lanes,
    and over row 0 min(RB[0], n_pad) + 1; and whether every band is a
    yama band the warp path takes: 0 <= M <= m_pad, LB[0] = 0, LB and RB
    nondecreasing over rows 0..M, 0 <= LB[r] <= RB[r] <= n_pad on rows
    1..M, in rows of at least 16 bytes (n_pad >= 15, every real pad)."""
    LB = np.asarray(LB, dtype=np.int64)
    RB = np.asarray(RB, dtype=np.int64)
    M = np.asarray(M, dtype=np.int64)
    if M.shape[0] == 0:
        return 0, True
    rows = np.arange(1, m_pad + 1)[None, :]
    live = rows <= M[:, None]  # rows 1..M
    lb, rb, lbp, rbp = LB[:, 1:], RB[:, 1:], LB[:, :-1], RB[:, :-1]
    w = np.maximum(rb, rbp) - np.minimum(lb, lbp) + 1
    window = int(np.where(live, w, 0).max()) if m_pad else 0
    window = max(window, int(np.clip(RB[:, 0], 0, n_pad).max()) + 1)
    ok = ((lb >= lbp) & (rb >= rbp) & (lb >= 0) & (lb <= rb)
          & (rb <= n_pad)) | ~live
    monotone = bool(ok.all() and (LB[:, 0] == 0).all() and n_pad >= 15
                    and ((M >= 0) & (M <= m_pad)).all())
    return window, monotone


def full_plan(LB, RB, M, m_pad: int, n_pad: int, path: str | None = None,
              B: int | None = None) -> FullPlan:
    """The forward kernel's path and launch shape for a bucket, from its
    band arrays on the host (``stack_host``'s, never read back from the
    card): the warp path where every window is at most FULL_WARP_LANES
    lanes and every band monotone (``full_window``), P = ceil(window/32)
    band lanes a thread and ``per_block_for(B)`` problems a block; the
    block path otherwise. ``path`` forces one ("warp" raises where the
    bucket is not eligible); ``B`` launches a part of the bucket (a mesh
    row: its window is at most the bucket's)."""
    window, monotone = full_window(LB, RB, M, m_pad, n_pad)
    B = len(M) if B is None else B
    warp = monotone and window <= FULL_WARP_LANES
    if path is None:
        path = "warp" if warp else "block"
    if path == "block":
        return FullPlan("block", 0, 1, B, FULL_THREADS, window)
    if path != "warp":
        raise ValueError(f"full_plan: no path {path!r}")
    if not warp:
        raise ValueError(f"full_plan: the warp path takes monotone bands in "
                         f"windows up to {FULL_WARP_LANES} lanes, not "
                         f"{window} lanes (monotone: {monotone})")
    per_block = per_block_for(B)
    return FullPlan("warp", max(1, -(-window // 32)), per_block,
                    -(-B // per_block), 32 * per_block, window)


def per_block_for(B: int) -> int:
    """Warps a block of the warp-path forward and of the traceback, one
    a problem: 2 where that still leaves a block for every SM, else 1
    (``tools/full_sweep.py`` times 1, 2 and 4 at the bench bucket; 4
    leaves 160 blocks for its 637 problems on 132 SMs, 28 of them with
    two)."""
    return 2 if B >= 2 * SMS else 1


def yama_core(histA, a0, a1, pa, histB, b0, b1, pb, LB, RB, M, N, K, L,
              ss_cat, go: int, ge: int, m_pad: int, n_pad: int,
              plan: FullPlan | None = None):
    """Forward DP of one bucket: ``yama_jax._yama_core`` with its
    ``vmap`` written out as the leading dimension B.

    Operands as ``stack_jobs`` returns them; ``ss_cat`` is the (6, 6)
    int32 substitution matrix. Returns ``flags`` (B, m_pad+1, n_pad+1)
    uint8, ``flags[b, r, c] = c | d<<2 | i<<4`` in band and 0 elsewhere,
    and the last row's C, D, I at column N, each (B,) int32.

    Replaces the jitted ``lax.scan`` of ``multiz_tpu/ops/yama_jax.py:66``
    with a kernel of ``csrc/yama_full.cu`` on CUDA tensors, on the path
    of ``plan`` (``full_plan``; without one it is made from LB, RB and M
    read back to the host): ``yama_full_dp_warp`` (one warp per problem,
    its row in registers) or ``yama_full_dp_block`` (one block per
    problem, the row's columns in tiles of FULL_THREADS). Both are bound
    by the flag matrix's bytes or its band cells' operations
    (``full_dp_bound``) and by the longest problem's chain of rows
    (``full_dp_chain_bound``). On CPU tensors it runs the plain version
    ``yama_core_reference``. ``yama_core.launches`` counts kernel
    launches, ``yama_core.paths`` them by path."""
    ops = (histA, a0, a1, pa, histB, b0, b1, pb, LB, RB, M, N, K, L)
    dev = M.device
    if dev.type == "cpu":
        return yama_core_reference(*ops, ss_cat, go, ge, m_pad, n_pad)
    if dev.type != "cuda":
        raise ValueError(f"yama_core: no kernel for device {dev}")
    B = M.shape[0]
    mp1, np1 = m_pad + 1, n_pad + 1
    shapes = _stack_shapes(m_pad, n_pad)
    _check("yama_core", dev,
           [(k, t, (B, *shapes[k])) for k, t in zip(STACK_KEYS, ops)]
           + [("ss_cat", ss_cat, (6, 6))])
    flags = torch.empty((B, mp1, np1), dtype=U8, device=dev)
    last = torch.empty((3, B), dtype=I32, device=dev)
    if B:
        if plan is None:
            plan = full_plan(*(t.cpu().numpy() for t in (LB, RB, M)),
                             m_pad, n_pad)
        if plan.grid != -(-B // plan.per_block):
            raise ValueError(f"yama_core: a plan of {plan.grid} blocks for "
                             f"{B} problems")
        scratch = (torch.empty(B * FULL_NREC * np1, dtype=I32, device=dev)
                   if plan.path == "block" else None)
        lib = _build.load()
        with torch.cuda.device(dev):
            rc = lib.yama_full_dp_launch(
                *(t.data_ptr() for t in ops), ss_cat.data_ptr(),
                flags.data_ptr(), last.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                B, m_pad, n_pad, go, ge, plan.per_thread, plan.per_block,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(rc, "yama_full_dp_launch")
        _build.count_launch(yama_core, plan.path)
    return (flags, *last.unbind(0))


yama_core.launches = 0
yama_core.paths = {"warp": 0, "block": 0}


def _check(what, dev, pairs):
    """Raise unless every (name, tensor, shape) is a contiguous int32 (or
    uint8 for ``flags``) tensor of that shape on ``dev``."""
    for name, t, shape in pairs:
        dtype = U8 if name == "flags" else I32
        if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: bad {name} {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def yama_core_reference(histA, a0, a1, pa, histB, b0, b1, pb, LB, RB, M, N,
                        K, L, ss_cat, go: int, ge: int, m_pad: int,
                        n_pad: int):
    """The plain version of ``yama_core``: a loop of torch ops over rows
    1..max(M) of the bucket, not 1..m_pad. Past a problem's M the JAX
    scan keeps its dp row and writes zero flags, so the rows past the
    bucket's largest M change nothing and their flags stay zero, as
    here.

    This is ``yama_core_cols`` over one shard holding every column."""
    ops = dict(zip(STACK_KEYS, (histA, a0, a1, pa, histB, b0, b1, pb, LB,
                                RB, M, N, K, L)))
    (flags,), *last = yama_core_cols([ops], ss_cat, go, ge, m_pad, n_pad)
    return (flags, *last)


def yama_core_cols(shards, ss_cat, go: int, ge: int, m_pad: int,
                   n_pad: int):
    """Forward DP of one bucket with its dp columns cut into contiguous
    ranges, one per entry of ``shards``: the operand dicts of one blocks
    row, as ``parallel.sharding.shard_stacked`` gives them (the
    ``BAND_KEYS`` operands hold the shard's columns, the others are
    whole), each on its own device.

    Returns (flags, lastC, lastD, lastI): ``flags[j]`` (B, m_pad+1, w_j)
    uint8 holds shard j's columns on its device; the last cells (B,)
    int32, each contiguous, are on shard 0's device.

    Each dp row runs as one generator per shard (``_Cols.row``) that
    pauses at the row's four in-row dependencies on the shards to its
    left, which XLA turns into collective scans in the JAX program:
      1. the diagonal read of the previous row: C, D and I at the left
         shard's last column, one (B, 3) copy per boundary;
      2. the I chain's x and y: this row's C and D at the left shard's
         last column, one (B, 2) copy per boundary;
      3. the carried prefix sum ``P``: the sum of the left shards' chain
         totals;
      4. the carried prefix max ``R``: the max of the left shards' R,
         which is also the first lane of ``Wprev``.
    Each carry is one scan over a (B, band-1) tensor of the shards'
    totals on shard 0's device (``_sums``, ``_maxes``). The first shard
    shifts in the unsharded row's constants and the last sends nothing,
    so a single shard runs exactly the ops of the unsharded row. The
    int32 sums wrap as the single cumsum does, so the carried sum equals
    it bit for bit."""
    widths = [s["b0"].shape[1] for s in shards]
    if sum(widths) != n_pad + 1:
        raise ValueError(f"yama_core_cols: shards hold {sum(widths)} columns, "
                         f"not n_pad+1 = {n_pad + 1}")
    devs = [s["M"].device for s in shards]
    ss = ss_cat.tolist()
    cols = [_Cols(s, sum(widths[:j]), j + 1 < len(shards), ss, go, ge, m_pad)
            for j, s in enumerate(shards)]
    _exchange([c.row0() for c in cols], devs, (_sums,))
    M = shards[0]["M"]
    for r in range(1, int(M.max()) + 1 if M.shape[0] else 1):
        _exchange([c.row(r) for c in cols], devs,
                  (_halos, _halos, _sums, _maxes))
    last = sum(c.last_cells().to(devs[0]) for c in cols)
    # three contiguous (B,) rows, as the traceback kernel takes them
    return ([c.flags for c in cols], *last.T.contiguous())


def _shift_in(v, fill, halo, k):
    """v[:, j-1]: lane 0 takes column k of ``halo`` (B, .), the left
    shard's last column, or ``fill`` where there is no shard to the
    left."""
    if halo is None:
        return _shift1(v, fill)
    return torch.cat([halo[:, k:k + 1], v[:, :-1]], dim=1)


def _exchange(steps, devs, exchanges):
    """Run one generator per shard to its end; after the i-th yield,
    ``exchanges[i](yielded, devs)`` gives what each shard is sent."""
    sent = [next(g) for g in steps]
    for ex in exchanges:
        sent = [_send(g, v) for g, v in zip(steps, ex(sent, devs))]


def _send(g, v):
    try:
        return g.send(v)
    except StopIteration:
        return None


def _halos(sent, devs):
    """Shard j gets shard j-1's block, copied to its device in one
    piece; shard 0 gets None."""
    return [None] + [s.to(d) for s, d in zip(sent[:-1], devs[1:])]


def _carried(sent, devs, scan):
    """Shard j gets column j-1 of ``scan`` over the (B, band-1) tensor
    of the (B, 1) totals of shards 0..band-2, taken on shard 0's device;
    shard 0 gets None."""
    if len(sent) == 1:
        return [None]
    t = scan(torch.cat([s.to(devs[0]) for s in sent[:-1]], dim=1))
    return [None] + [t[:, j:j + 1].to(d) for j, d in enumerate(devs[1:])]


def _sums(sent, devs):
    return _carried(sent, devs, lambda t: torch.cumsum(t, dim=1, dtype=I32))


def _maxes(sent, devs):
    return _carried(sent, devs, lambda t: torch.cummax(t, dim=1).values)


class _Cols:
    """One column shard [c0, c0+w) of a bucket's dp: its operands, loop
    invariants, flag store and current dp row, on the shard's device.
    ``right``: a shard lies to its right, so this one sends halos and
    totals."""

    def __init__(self, ops, c0: int, right: bool, ss, go: int, ge: int,
                 m_pad: int):
        self.ops, self.c0, self.right, self.go, self.ge = ops, c0, right, go, ge
        dev = ops["M"].device
        B, w = ops["b0"].shape
        self.js = js = torch.arange(c0, c0 + w, dtype=I32, device=dev)[None, :]
        self.minint = torch.tensor(MININT, dtype=I32, device=dev)
        self.Mc, self.Nc, self.Kc, self.Lc = (ops[k][:, None] for k in "MNKL")
        self.flags = torch.zeros((B, m_pad + 1, w), dtype=U8, device=dev)

        # loop invariants; histB @ ss_cat.T and (.) @ ha as broadcast
        # multiply-adds, since CUDA matmul takes no int32
        histB, b0, Kc = ops["histB"], ops["b0"], self.Kc
        self.sub_right = [sum(histB[:, :, j] * ss[k][j] for j in range(6))
                          for k in range(6)]
        self.pb = pb0, pb1, pb2, pb3 = ops["pb"].unbind(2)
        self.pb02, self.pb13 = pb0 + pb2, pb1 + pb3
        self.e = b0 * Kc * ge
        self.yI_live = go * Kc * b0
        self.zI_live = go * Kc * pb2
        self.inner = (js > 0) & (js < self.Nc)
        self.gt1 = js > 1
        self.zero_col = torch.zeros((B, 1), dtype=I32, device=dev)

    def row0(self):
        """Row 0 (mz_yama.c:82-94); pauses once, for the carried sum."""
        js, minint, o = self.js, self.minint, self.ops
        self.dpC = torch.where(js == 0, 0, minint).to(I32).repeat(
            o["M"].shape[0], 1)
        self.dpD = self.dpC.clone()
        chain0 = (js >= 1) & (js <= o["RB"][:, :1])
        S = torch.cumsum(torch.where(chain0, o["b0"], 0), dim=1, dtype=I32)
        carry = yield S[:, -1:] if self.right else None
        if carry is not None:
            S = S + carry
        i0 = -S * self.Kc * self.ge
        self.dpI = torch.where(chain0, i0,
                               torch.where(js == 0, 0, minint)).to(I32)
        self.flags[:, 0] = torch.where(chain0, FLAG_I << 4, 0).to(U8)

    def row(self, r: int):
        """Row r; pauses at the four exchanges of ``yama_core_cols``."""
        o, js, minint, go, ge = self.ops, self.js, self.minint, self.go, self.ge
        Mc, Lc, inner, gt1 = self.Mc, self.Lc, self.inner, self.gt1
        b0, b1 = o["b0"], o["b1"]
        pb0, pb1, pb2, pb3 = self.pb
        pb02, pb13 = self.pb02, self.pb13
        LB, RB, pa = o["LB"], o["RB"], o["pa"]
        dpC, dpD, dpI = self.dpC, self.dpD, self.dpI
        row_valid = r <= Mc
        lb, rb = LB[:, r:r + 1], RB[:, r:r + 1]
        lbm1 = LB[:, r - 1:r]
        lbm2 = LB[:, r - 2:r - 1] if r >= 2 else self.zero_col
        ha = o["histA"][:, r]
        a0r, a1r = o["a0"][:, r:r + 1], o["a1"][:, r:r + 1]
        p0, p1, p2, p3 = (pa[:, r, k:k + 1] for k in range(4))
        in_band = (js >= lb) & (js <= rb)
        not1 = r > 1  # uniform over the bucket: every problem is at row r

        # 1. the previous row at the left shard's last column
        halo = yield (torch.stack([v[:, -1] for v in (dpC, dpD, dpI)], 1)
                      if self.right else None)

        # ---------- D node (previous row, same column) ----------
        xs = dpC
        ys = dpD
        if not1:
            xs = xs - torch.where(inner & (js > lbm2),
                                  go * (p0 * b0 + p2 * Lc), 0)
            ys = ys - torch.where(inner, go * p2 * Lc, 0)
        zs = dpI - torch.where(inner & (js > lbm1), go * a0r * Lc, 0)
        D_new, flag_d = _pick(xs, ys, zs)
        D_row = torch.where(in_band, D_new - a0r * Lc * ge, minint)

        # ---------- C node (previous row's diagonal) ----------
        xs = _shift_in(dpC, MININT, halo, 0)
        ys = _shift_in(dpD, MININT, halo, 1)
        if not1:
            xC = go * (p0 * pb1 + p1 * pb02 + p2 * pb13 + p3 * pb2)
            yC = go * (p1 * b0 + p2 * b1 + p3 * b0)
            xs = xs - torch.where(gt1 & (js > lbm2 + 1), xC, 0)
            ys = ys - torch.where(gt1, yC, 0)
        zC = go * (a0r * pb13 + a1r * pb2)
        zs = (_shift_in(dpI, MININT, halo, 2)
              - torch.where(gt1 & (js > lbm1 + 1), zC, 0))
        C_val, flag_c = _pick(xs, ys, zs)
        sub = sum(self.sub_right[k] * ha[:, k:k + 1] for k in range(6))
        reach = js > lbm1
        C_row = torch.where(in_band & reach, C_val + sub, minint)
        flag_c = torch.where(reach, flag_c, 0)

        # ---------- I node: parallel prefix-max chain ----------
        # 2. this row's C and D at the left shard's last column
        halo = yield (torch.stack([C_row[:, -1], D_row[:, -1]], 1)
                      if self.right else None)
        live = r != Mc
        xI = torch.where(live, go * (a0r * pb02 + a1r * pb2), 0)
        yI = torch.where(live, self.yI_live, 0)
        zI = torch.where(live, self.zI_live, 0)
        xv = (_shift_in(C_row, MININT, halo, 0)
              - torch.where(js > lbm1 + 1, xI, 0))
        yv = _shift_in(D_row, MININT, halo, 1) - yI
        chain = (js >= lb + 1) & (js <= rb)
        sz = torch.where(js > lb + 1, zI, 0) + self.e
        P = torch.cumsum(torch.where(chain, sz, 0), dim=1, dtype=I32)
        # 3. the left shards' chain sum
        carry = yield P[:, -1:] if self.right else None
        if carry is not None:
            P = P + carry
        from_y = xv < yv
        V = torch.maximum(xv, yv) - self.e + P
        left = js <= lb  # never a real I candidate
        R = torch.cummax(torch.where(left, minint, V), dim=1).values
        # 4. the left shards' max of R: R one column left of this shard
        carry = yield R[:, -1:] if self.right else None
        if carry is None:
            Wprev = _shift1(R, NEG_HUGE)
        else:
            R = torch.maximum(R, carry)
            Wprev = torch.cat([carry, R[:, :-1]], dim=1)
        zwin = (Wprev > V) | ((Wprev == V) & from_y)
        flag_i = torch.where(
            left, 0,
            torch.where(zwin, FLAG_I, torch.where(from_y, FLAG_D, FLAG_C)),
        )
        I_row = torch.where(in_band & ~left, R - P, minint)

        frow = torch.where(in_band & row_valid,
                           flag_c | (flag_d << 2) | (flag_i << 4), 0)
        self.flags[:, r] = frow.to(U8)
        self.dpC = torch.where(row_valid, C_row, dpC)
        self.dpD = torch.where(row_valid, D_row, dpD)
        self.dpI = torch.where(row_valid, I_row, dpI)

    def last_cells(self):
        """(B, 3): the last row's C, D, I at column N where this shard
        holds column N, else 0."""
        N = self.ops["N"]
        w = self.js.shape[1]
        own = (N >= self.c0) & (N < self.c0 + w)
        at = (N - self.c0).clamp(0, w - 1)[:, None].long()
        return torch.stack([torch.where(own, v.gather(1, at)[:, 0], 0)
                            for v in (self.dpC, self.dpD, self.dpI)], dim=1)


def traceback_core(flags, LB, RB, M, N, lastC, lastD, lastI,
                   m_pad: int, n_pad: int):
    """Edit-script extraction (mz_yama.c:257-291): ``yama_jax.
    _traceback_core`` over a bucket.

    Returns (script, nedit): script (B, m_pad+n_pad) uint8, script[b, k]
    the k-th op walking back from (M, N), 255 past nedit; nedit (B,)
    int32.

    Replaces the jitted fixed-trip ``lax.scan`` of
    ``multiz_tpu/ops/yama_jax.py:225`` with the kernel
    ``yama_full_tb_kernel`` of ``csrc/yama_full.cu`` on CUDA tensors (one
    warp per walk, its rows' bands staged in shared memory; bound by the
    longest walk's chain of dependent flag reads,
    ``full_tb_chain_bound``; its bytes, ``full_tb_bound``, take far
    less). On CPU tensors it runs the plain version
    ``traceback_reference``. ``traceback_core.launches`` counts kernel
    launches."""
    dev = M.device
    if dev.type == "cpu":
        return traceback_reference(flags, LB, RB, M, N, lastC, lastD, lastI,
                                   m_pad, n_pad)
    if dev.type != "cuda":
        raise ValueError(f"traceback_core: no kernel for device {dev}")
    B = M.shape[0]
    mp1 = m_pad + 1
    _check("traceback_core", dev, [
        ("flags", flags, (B, mp1, n_pad + 1)), ("LB", LB, (B, mp1)),
        ("RB", RB, (B, mp1)), ("M", M, (B,)), ("N", N, (B,)),
        ("lastC", lastC, (B,)), ("lastD", lastD, (B,)),
        ("lastI", lastI, (B,)),
    ])
    if flags.data_ptr() % 16:
        raise ValueError("traceback_core: flags are not 16-byte aligned")
    script = torch.empty((B, m_pad + n_pad), dtype=U8, device=dev)
    nedit = torch.empty(B, dtype=I32, device=dev)
    if B:
        lib = _build.load()
        with torch.cuda.device(dev):
            rc = lib.yama_full_tb_launch(
                *(t.data_ptr() for t in (flags, LB, RB, M, N, lastC, lastD,
                                         lastI, script, nedit)),
                B, m_pad, n_pad, per_block_for(B),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(rc, "yama_full_tb_launch")
        _build.count_launch(traceback_core)
    return script, nedit


traceback_core.launches = 0


def traceback_reference(flags, LB, RB, M, N, lastC, lastD, lastI,
                        m_pad: int, n_pad: int):
    """The plain version of ``traceback_core``, every walk of the bucket
    advanced together in torch. The JAX scan makes a fixed m_pad+n_pad
    steps; this loop ends when every walk is done. A walk that ends at
    (0, 0) takes at most M+N steps (each lowers the row, the column or
    both), so the loop checks once, after max(M+N) steps over the bucket,
    and stops if all are done; the steps it skips would only write 255.
    A walk that leaves the matrix (its job is invalid; the oracle raises)
    keeps the loop to the JAX scan's m_pad+n_pad steps."""
    B = M.shape[0]
    dev = M.device
    mp1, np1 = m_pad + 1, n_pad + 1
    node = torch.where(
        (lastC >= lastD) & (lastC >= lastI), FLAG_C,
        torch.where(lastD >= lastI, FLAG_D, FLAG_I),
    ).to(I32)
    row, col = M.clone(), N.clone()
    k = torch.zeros(B, dtype=I32, device=dev)
    script = torch.full((B, m_pad + n_pad), 255, dtype=U8, device=dev)
    flat = flags.reshape(B, mp1 * np1)
    lim = int((M + N).max()) if B else 0
    for t in range(m_pad + n_pad if B else 0):
        done = (row <= 0) & (col <= 0)
        if t == lim and bool(done.all()):
            break
        # a negative row indexes from the end, then clamps, as jnp does
        ri = torch.where(row < 0, row + mp1, row).clamp(0, m_pad)[:, None]
        ri = ri.long()
        lb = LB.gather(1, ri)[:, 0]
        rb = RB.gather(1, ri)[:, 0]
        jc = col.clamp(0, n_pad)[:, None].long()
        st = flat.gather(1, ri * np1 + jc)[:, 0].to(I32)
        st = torch.where((col >= lb) & (col <= rb), st, 0)
        script[:, t] = torch.where(done, 255, node).to(U8)
        is_i = node == FLAG_I
        is_d = node == FLAG_D
        nnode = torch.where(is_i, st >> 4,
                            torch.where(is_d, (st >> 2) & 3, st & 3))
        row = torch.where(done | is_i, row, row - 1)
        col = torch.where(done | is_d, col, col - 1)
        node = torch.where(done, node, nnode)
        k = torch.where(done, k, k + 1)
    return script, k


def _rows(stacked: dict, m_pad: int):
    """(LB, RB, live): the (B, m_pad+1) int64 bands on the CPU, and
    whether each row is one of its problem's rows 0..M."""
    LB, RB = (stacked[k].cpu().long() for k in ("LB", "RB"))
    rows = torch.arange(m_pad + 1)[None, :]
    return LB, RB, rows <= stacked["M"].cpu().long()[:, None]


def full_dp_bound(stacked: dict, m_pad: int, n_pad: int) -> tuple:
    """(seconds, "operations" or "bytes"): the least time the card could
    take for one forward launch over the operands ``stacked`` (as
    ``stack_jobs`` returns them), the larger of OPS_PER_CELL int32
    operations for each band cell of rows 0..M (RB - LB + 1 a row) over
    the int32 rate, and the bytes (every operand and ss_cat read once,
    the flag matrix and the last cells written once) over HBM's rate."""
    LB, RB, live = _rows(stacked, m_pad)
    cells = int(torch.where(live, (RB - LB + 1).clamp(min=0), 0).sum())
    B = LB.shape[0]
    nbytes = (sum(t.numel() * t.element_size() for t in stacked.values())
              + 36 * 4 + B * (m_pad + 1) * (n_pad + 1) + 12 * B)
    t_ops = OPS_PER_CELL * cells / INT32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def full_dp_chain_bound(stacked: dict, m_pad: int, n_pad: int) -> float:
    """Seconds: the least time of the launch's longest chain, one
    problem's rows 1..M in order, each the recurrence's dependent step
    as ``yama_dp.dp_chain_bound`` counts it (DP_ROW_SHUFFLES shuffles
    and DP_ROW_OPS operations, plus P - 1 maxima of an in-thread scan
    over P = ceil(window/32) lanes a thread, at most 4: a wider window
    needs no fewer steps). A problem's rows run in order, so no launch
    is shorter, whatever the card's throughput."""
    LB, RB, M = (stacked[k].cpu().numpy() for k in ("LB", "RB", "M"))
    if M.shape[0] == 0:
        return 0.0
    rows = int(np.clip(M, 0, m_pad).max())
    window, _ = full_window(LB, RB, M, m_pad, n_pad)
    per = min(max(1, -(-window // 32)), FULL_WARP_LANES // 32)
    cycles = (DP_ROW_SHUFFLES * SHUFFLE_CYCLES
              + (DP_ROW_OPS + per - 1) * OP_CYCLES)
    return rows * cycles / CLOCK_HZ


def full_tb_bound(nedit, stacked: dict, m_pad: int, n_pad: int) -> tuple:
    """(seconds, "bytes"): the bytes the walks of one launch need (one
    flag byte a step, LB and RB once a row, M, N and the last cells once,
    the scripts and ``nedit`` written once) over HBM's rate. Their
    operations (FULL_TB_STEP_OPS a step) take less."""
    steps = int(nedit.long().sum())
    rows = int((stacked["M"].long() + 1).clamp(min=0).sum())
    B = nedit.shape[0]
    nbytes = steps + 8 * rows + B * (m_pad + n_pad) + B * (4 + 20)
    return nbytes / HBM_BYTES_PER_S, "bytes"


def full_tb_chain_bound(nedit) -> float:
    """Seconds: the least time of the launch's longest walk, its steps
    times the least latency of one dependent step (GLOBAL_CYCLES and
    FULL_TB_STEP_OPS operations at CLOCK_HZ). A walk's steps run in
    order on one lane, so no launch is shorter."""
    steps = int(nedit.max()) if nedit.shape[0] else 0
    return steps * (GLOBAL_CYCLES + FULL_TB_STEP_OPS * OP_CYCLES) / CLOCK_HZ


def _run_bucket(stacked: dict, st, m_pad: int, n_pad: int,
                plan: FullPlan | None = None):
    """(scripts, nedits) of one stacked bucket, on its tensors' device;
    ``plan`` as ``yama_core`` takes it."""
    flags, lc, ld, li = yama_core(
        *(stacked[k] for k in STACK_KEYS), st.ss_cat, st.gap_open,
        st.gap_extend, m_pad, n_pad, plan,
    )
    return traceback_core(flags, stacked["LB"], stacked["RB"], stacked["M"],
                          stacked["N"], lc, ld, li, m_pad, n_pad)


def _run_cols(shards, st, m_pad: int, n_pad: int):
    """(scripts, nedits) of one blocks row's column shards
    (``yama_core_cols``), on the row's first band device."""
    flags, lc, ld, li = yama_core_cols(shards, st.ss_cat, st.gap_open,
                                       st.gap_extend, m_pad, n_pad)
    s0 = shards[0]
    # The walk reads the flags at data-dependent columns, as the JAX
    # program reads its flag matrix whole, so the shards are joined on
    # the first band device. Peak there while they are joined: the
    # whole (B, m_pad+1, n_pad+1) uint8 matrix plus the shards that
    # live on that device, i.e. twice the matrix when the band shares
    # one card (2 x 669 MB for 637 jobs at 1024 x 1024).
    flags = torch.cat([f.to(s0["M"].device) for f in flags], dim=2)
    return traceback_core(flags, s0["LB"], s0["RB"], s0["M"], s0["N"],
                          lc, ld, li, m_pad, n_pad)


def yama_batch(jobs, sp: sc.ScoreParams | None = None, device="cuda",
               mesh=None):
    """Batched full-row DP over (A, B, LB, RB) problems on ``device``.

    Problems are bucketed by (``_pad_to(M)``, ``_pad_to(N)``); each
    bucket's DP and traceback run on the device, the replay on the host
    (``mzcore.replay_into``). Returns the merged
    column matrices in input order, bit-identical to ``yama_numpy``.

    With ``mesh`` (``parallel.sharding.make_mesh``) in place of
    ``device``, each bucket is padded to a multiple of the mesh's length
    and cut into contiguous equal shares, one per blocks row; with
    ``band`` > 1 each row's columns are cut over its band devices
    (``yama_core_cols``). The scripts come back to the host in mesh
    order."""
    if sp is None:
        sp = sc.current
    dev = None if mesh is not None else require_device(device)
    buckets: dict = {}
    for idx, (A, B, LB, RB) in enumerate(jobs):
        M, N = A.shape[0], B.shape[0]
        _check_band(np.asarray(LB, dtype=np.int64),
                    np.asarray(RB, dtype=np.int64), M, N)
        buckets.setdefault((_pad_to(M), _pad_to(N)), []).append(idx)
    results = [None] * len(jobs)
    for (m_pad, n_pad), idxs in buckets.items():
        if mesh is None:
            host = stack_host([jobs[i] for i in idxs], m_pad, n_pad)
            plan = full_plan(host["LB"], host["RB"], host["M"], m_pad, n_pad)
            scripts, nedits = _run_bucket(
                upload(host, dev), from_score_params(sp, dev), m_pad, n_pad,
                plan)
        else:
            run = idxs + [idxs[-1]] * (pad_batch(len(idxs), mesh) - len(idxs))
            host = stack_host([jobs[i] for i in run], m_pad, n_pad)
            rows = shard_stacked(upload(host, "cpu"), mesh)
            # every row holds len(run) / blocks problems of the bucket
            plan = full_plan(host["LB"], host["RB"], host["M"], m_pad, n_pad,
                             B=rows[0][0]["M"].shape[0])
            outs = []
            for row, devs in zip(rows, mesh.rows):
                st = from_score_params(sp, devs[0])
                outs.append(_run_bucket(row[0], st, m_pad, n_pad, plan)
                            if mesh.band == 1
                            else _run_cols(row, st, m_pad, n_pad))
            scripts = torch.cat([o[0].cpu() for o in outs])
            nedits = torch.cat([o[1].cpu() for o in outs])
        scripts_np = scripts.cpu().numpy()
        nedits_np = nedits.cpu().numpy()
        for slot, idx in enumerate(idxs):
            A, B = jobs[idx][:2]
            results[idx] = replay_script(scripts_np[slot],
                                          int(nedits_np[slot]), A, B)
    return results


def yama_full(A, B, LB, RB, sp: sc.ScoreParams | None = None,
              device="cuda") -> np.ndarray:
    """One problem through ``yama_batch``: a drop-in for ``yama_numpy``
    (``yama_jax.yama_jax``)."""
    return yama_batch([(A, B, LB, RB)], sp=sp, device=device)[0]


def batch_fn_for(device):
    """The ``MultizConfig.batch_fn`` of the full-row path on ``device``
    (no ``stream_cls``: the merge scan hands it one batch per round).
    Raises at once if ``device`` is a CUDA device that is missing."""
    dev = require_device(device)

    def batch_fn(jobs, sp=None):
        return yama_batch(jobs, sp=sp, device=dev)

    batch_fn.device = dev
    return batch_fn
