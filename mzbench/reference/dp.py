"""The benchmark's reference DP: yama (mz_yama.c:50-320) over a batch of
jobs, in plain PyTorch.

Each job is (A, B, LB, RB) as the program takes it: A (M, K) and B (N, L)
uint8 column-major alignment texts, LB and RB the band over B's columns
for rows 0..M. The answer is the merged column matrix (M_new, K + L),
the same bytes as ``frozen/yama.yama_numpy`` gives one job at a time.

The recurrence is worked out row by row for all the batch's jobs at
once, each row over a window of lanes from the job's LB. The vertical
(D) and diagonal (C) states of a row depend only on the row before. The
horizontal (I) chain, I[k] = max(c[k], I[k-1] + d[k]), is a max-plus
scan: with P the prefix sum of d, I[k] = P[k] + max(I[0], max over
j <= k of c[j] - P[j]), a cumulative sum and a cumulative maximum. The
flags that the traceback reads come from the same candidates and the
same tie-breaking as mz_yama.c (C >= D > I). The walks run for all jobs
at once; the merged matrices are rebuilt on the host with numpy.

``dtype`` is the type of the DP's values. The reference runs in int64,
in which nothing the inputs can reach wraps. The control runs the same
code in int16 (``minint`` -2**14), the next integer precision below the
configuration's int32 scores, with ``clamp`` set: its walks can leave
the band, and it finishes them rather than fail, so that it gives an
answer to compare.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frozen import scores as sc
from ..frozen.yama import DASH, YamaError, _check_band

MININT = -(2**30)
FLAG_C, FLAG_I, FLAG_D = 0, 1, 2
PAD = 255  # past the end of a walk
# elements of one chunk's (jobs x columns) DP state
STATE_CAP = 1 << 26


def column_stats(texts) -> dict:
    """Per-column statistics of many column-major texts at once, as
    ``frozen/yama.column_stats`` gives them for one (1-indexed: entry 0
    of each text unused): a dict of int64 arrays over the concatenated
    columns, ``off`` the offset of each text's entry 0."""
    ncols = np.array([t.shape[0] for t in texts], dtype=np.int64)
    nrows = np.array([t.shape[1] for t in texts], dtype=np.int64)
    off = np.zeros(len(texts) + 1, dtype=np.int64)
    off[1:] = np.cumsum(ncols + 1)
    tot = int(off[-1])
    rmax = int(nrows.max()) if len(texts) else 1
    X = np.zeros((tot, rmax), dtype=np.uint8)
    valid = np.zeros((tot, rmax), dtype=bool)
    for t, o in zip(texts, off[:-1]):
        X[o + 1 : o + 1 + t.shape[0], : t.shape[1]] = t
        valid[o + 1 : o + 1 + t.shape[0], : t.shape[1]] = True
    cat = sc.BYTE2CAT[X]
    hist = np.stack([((cat == c) & valid).sum(1) for c in range(sc.NCAT)],
                    axis=1).astype(np.int64)
    dash = (X == DASH) & valid
    ndash = dash.sum(1).astype(np.int64)
    nrow_of = np.repeat(nrows, ncols + 1)
    nond = np.where(valid.any(1), nrow_of - ndash, 0)
    f = np.zeros_like(dash)
    f[1:] = dash[:-1]
    nf, ns = valid & ~f, valid & ~dash
    pair = np.stack([(nf & ns).sum(1), (nf & dash).sum(1),
                     (f & ns).sum(1), (f & dash).sum(1)],
                    axis=1).astype(np.int64)
    # column 1 of each text: the first bit is forced to 0
    first = off[:-1][ncols >= 1] + 1
    pair[first] = 0
    pair[first, 0] = nond[first]
    pair[first, 1] = ndash[first]
    # entry 0 of each text holds nothing
    z = off[:-1]
    hist[z] = 0
    pair[z] = 0
    nond[z] = ndash[z] = 0
    return {"off": off, "hist": hist, "nond": nond, "ndash": ndash,
            "pair": pair}


def _lane_bucket(w: int) -> int:
    p = 32
    while p < w:
        p *= 2
    return p


def yama_batch(jobs, sp=None, device="cpu", dtype=torch.int64,
               minint: int = MININT, clamp: bool = False) -> list:
    """The merged column matrix of every job, in input order. A job
    whose band fails yama's entry checks, or whose walk leaves its band,
    raises YamaError, as yama does; with ``clamp`` (the control) such a
    walk is finished along the diagonal instead (``_walk``)."""
    if sp is None:
        sp = sc.current
    jobs = [(np.asarray(A), np.asarray(B), np.asarray(LB, dtype=np.int64),
             np.asarray(RB, dtype=np.int64)) for A, B, LB, RB in jobs]
    for A, B, LB, RB in jobs:
        _check_band(LB, RB, A.shape[0], B.shape[0])
    out = [None] * len(jobs)
    width = [int((RB[: A.shape[0] + 1] - LB[: A.shape[0] + 1]).max()) + 1
             for A, _, LB, RB in jobs]
    groups: dict = {}
    for i, w in enumerate(width):
        groups.setdefault(_lane_bucket(w), []).append(i)
    for W, idx in sorted(groups.items()):
        idx.sort(key=lambda i: -jobs[i][0].shape[0])  # by M, descending
        lo = 0
        while lo < len(idx):
            nmax = jobs[idx[lo]][1].shape[0]
            hi = lo
            while hi < len(idx):
                nmax = max(nmax, jobs[idx[hi]][1].shape[0])
                if hi > lo and (hi - lo + 1) * (nmax + 2) > STATE_CAP:
                    break
                hi += 1
            part = idx[lo:hi]
            res = _chunk([jobs[i] for i in part], W, sp, device, dtype,
                         minint, clamp)
            for i, r in zip(part, res):
                out[i] = r
            lo = hi
    return out


def _chunk(jobs, W, sp, device, dtype, minint, clamp) -> list:
    """One chunk of jobs sorted by M, descending; W lanes a row."""
    dev = torch.device(device)
    nb = len(jobs)
    Ms = np.array([A.shape[0] for A, _, _, _ in jobs], dtype=np.int64)
    Ns = np.array([B.shape[0] for _, B, _, _ in jobs], dtype=np.int64)
    Ks = np.array([A.shape[1] for A, _, _, _ in jobs], dtype=np.int64)
    Ls = np.array([B.shape[1] for _, B, _, _ in jobs], dtype=np.int64)
    mmax, nmax = int(Ms.max()), int(Ns.max())
    go, ge = int(sp.gap_open), int(sp.gap_extend)

    def T(x):
        return torch.as_tensor(x, device=dev)

    def V(x):
        return torch.as_tensor(x, device=dev).to(dtype)

    # row statistics of A, (mmax + 1, nb), and the band
    sa = column_stats([A for A, _, _, _ in jobs])
    rows = np.zeros((mmax + 1, nb), dtype=np.int64)
    a0 = rows.copy()
    a1 = rows.copy()
    pa = np.zeros((4, mmax + 1, nb), dtype=np.int64)
    ha = np.zeros((sc.NCAT, mmax + 1, nb), dtype=np.int64)
    LBt = rows.copy()
    RBt = rows.copy()
    for j, (A, _, LB, RB) in enumerate(jobs):
        M = A.shape[0]
        o = sa["off"][j]
        a0[: M + 1, j] = sa["nond"][o : o + M + 1]
        a1[: M + 1, j] = sa["ndash"][o : o + M + 1]
        pa[:, : M + 1, j] = sa["pair"][o : o + M + 1].T
        ha[:, : M + 1, j] = sa["hist"][o : o + M + 1].T
        LBt[: M + 1, j] = LB[: M + 1]
        RBt[: M + 1, j] = RB[: M + 1]
        LBt[M + 1 :, j] = LB[M]
        RBt[M + 1 :, j] = RB[M]
    # column statistics of B, (nb, nmax + 2, 12): b0, b1, pb (4), the six
    # category scores of each column; one scratch column past N
    sb = column_stats([B for _, B, _, _ in jobs])
    ncol = nmax + 2
    colt = np.zeros((nb, ncol, 12), dtype=np.int64)
    ss = sp.ss_cat.astype(np.int64)
    for j, (_, B, _, _) in enumerate(jobs):
        N = B.shape[0]
        sl = slice(sb["off"][j], sb["off"][j] + N + 1)
        colt[j, : N + 1, 0] = sb["nond"][sl]
        colt[j, : N + 1, 1] = sb["ndash"][sl]
        colt[j, : N + 1, 2:6] = sb["pair"][sl]
        colt[j, : N + 1, 6:12] = sb["hist"][sl] @ ss.T
    # row statistics of A, (mmax + 1, nb, 12): a0, a1, pa (4), hist (6)
    rowt = np.concatenate([a0[..., None], a1[..., None],
                           pa.transpose(1, 2, 0), ha.transpose(1, 2, 0)], 2)

    rowt, colt = V(rowt), V(colt)
    LBd, RBd = T(LBt), T(RBt)
    Md, Nd = T(Ms)[:, None], T(Ns)[:, None]
    Kv, Lv = V(Ks)[:, None], V(Ls)[:, None]
    lanes = torch.arange(W, device=dev)[None, :]
    zero = torch.zeros((), dtype=dtype, device=dev)
    go, ge = V(go), V(ge)
    perm = torch.tensor([0, 2, 1], device=dev)  # C, I, D: first wins ties

    # the state (nb, ncol, 3): C, D, I of each column as the last row
    # that reached it left them; row 0: 0 at column 0, the I chain
    # charged its extensions up to RB[0], MININT elsewhere
    st = torch.full((nb, ncol, 3), minint, dtype=dtype, device=dev)
    st[:, 0, :] = 0
    cols = torch.arange(ncol, device=dev)[None, :]
    r0 = RBd[0][:, None]
    b0all = torch.where(cols >= 1, colt[..., 0], zero)
    chain = -torch.cumsum(b0all, 1, dtype=dtype) * Kv * ge
    st[..., 2] = torch.where((cols >= 1) & (cols <= r0), chain, st[..., 2])

    # flags: row r holds the first nact(r) jobs' W lanes
    nact = np.array([int((Ms >= r).sum()) for r in range(mmax + 1)])
    nact[0] = nb
    foff = np.zeros(mmax + 2, dtype=np.int64)
    foff[1:] = np.cumsum(nact * W)
    flags = torch.zeros(int(foff[-1]), dtype=torch.uint8, device=dev)
    f0 = torch.where((lanes >= 1) & (lanes <= r0), FLAG_I << 4, 0)
    flags[: nb * W] = f0.to(torch.uint8).reshape(-1)
    last = torch.full((3, nb), minint, dtype=dtype, device=dev)

    for r in range(1, mmax + 1):
        n = int(nact[r])
        lb, rb = LBd[r, :n][:, None], RBd[r, :n][:, None]
        lbm1 = LBd[r - 1, :n][:, None]
        lbm2 = LBd[max(r - 2, 0), :n][:, None]
        N, L, K = Nd[:n], Lv[:n], Kv[:n]
        cs = lb + lanes
        gi = cs.clamp(max=ncol - 1)[..., None]
        ct = torch.gather(colt[:n], 1, gi.expand(n, W, 12))
        b0c, b1c, p0, p1, p2, p3 = (ct[..., q] for q in range(6))
        R = rowt[r, :n]
        ra0, ra1, q0, q1, q2, q3 = (R[:, q : q + 1] for q in range(6))
        same = torch.gather(st[:n], 1, gi.expand(n, W, 3))
        gm = (cs - 1).clamp(0, ncol - 1)[..., None]
        diag = torch.gather(st[:n], 1, gm.expand(n, W, 3))
        first = (lanes == 0) & ((lb == 0) | (lbm1 >= lb))
        diag = diag.masked_fill(first[..., None], minint)
        inner = (cs > 0) & (cs < N)
        gt1 = cs > 1
        if r > 1:
            dx = torch.where(inner & (cs > lbm2), go * (q0 * b0c + q2 * L), zero)
            dy = torch.where(inner, go * q2 * L, zero).expand(n, W)
            cx = torch.where(gt1 & (cs > lbm2 + 1), go * (
                q0 * p1 + q1 * (p0 + p2) + q2 * (p1 + p3) + q3 * p2), zero)
            cy = torch.where(gt1, go * (q1 * b0c + q2 * b1c + q3 * b0c), zero)
        else:
            dx = dy = cx = cy = torch.zeros((n, W), dtype=dtype, device=dev)
        dz = torch.where(inner & (cs > lbm1), go * ra0 * L, zero)
        cz = torch.where(gt1 & (cs > lbm1 + 1), go * (ra0 * (p1 + p3) + ra1 * p2),
                         zero)
        # D: from the row above, same column; C: the column before
        corr = torch.stack([torch.stack([dx, dz, dy], -1),
                            torch.stack([cx, cz, cy], -1)], 2)
        cand = torch.stack([same, diag], 2).index_select(3, perm) - corr
        best, pick = cand.max(-1)
        Dv = best[..., 0] - ra0 * L * ge
        reach = cs > lbm1
        score = (ct[..., 6:] * R[:, None, 6:]).sum(-1, dtype=dtype)
        Cv = torch.where(reach, best[..., 1] + score, minint)
        fD = pick[..., 0]
        fC = torch.where(reach, pick[..., 1], 0)

        # I: the same row, the column before (a max-plus scan)
        inside = r < Md[:n]
        xI = torch.where(inside & (cs > lbm1 + 1),
                         go * (ra0 * (p0 + p2) + ra1 * p2), zero)
        yI = torch.where(inside, go * K * b0c, zero)
        zz = torch.where(inside & (lanes >= 2), go * K * p2, zero)
        ext = b0c * K * ge
        x = torch.roll(Cv, 1, 1) - xI
        y = torch.roll(Dv, 1, 1) - yI
        c = torch.maximum(x, y) - ext
        d = torch.where(lanes >= 1, -(zz + ext), zero)
        P = torch.cumsum(d, 1, dtype=dtype)
        e = torch.where(lanes >= 1, c - P, minint)
        Iv = torch.where(lanes >= 1, P + torch.cummax(e, 1).values, minint)
        z = torch.roll(Iv, 1, 1) - zz
        fI = torch.where(lanes >= 1, torch.stack([x, z, y], -1).max(-1)[1], 0)

        fl = (fC | (fD << 2) | (fI << 4)).to(torch.uint8)
        flags[foff[r] : foff[r] + n * W] = fl.reshape(-1)
        new = torch.stack([Cv, Dv, Iv], -1)
        si = torch.where(cs <= rb, cs, ncol - 1)[..., None].expand(n, W, 3)
        st[:n].scatter_(1, si, new)
        # the jobs whose last row this is: their values at (M, N)
        n_next = int(nact[r + 1]) if r < mmax else 0
        if n_next < n:
            k = (N[n_next:] - lb[n_next:])[..., None].expand(n - n_next, 1, 3)
            last[:, n_next:n] = torch.gather(new[n_next:], 1, k)[:, 0].T

    scripts, bad = _walk(flags, foff, W, LBd, RBd, Md[:, 0], Nd[:, 0], last,
                         dev, clamp)
    scripts, bad = scripts.cpu().numpy(), bad.cpu().numpy()
    nedit = (scripts != PAD).sum(1)
    res = []
    for j, (A, B, _, _) in enumerate(jobs):
        if bad[j]:
            raise YamaError("Error generating edit script.")
        res.append(_replay(scripts[j, : nedit[j]][::-1], A, B))
    return res


def _walk(flags, foff, W, LBd, RBd, Md, Nd, last, dev, clamp):
    """Every job's walk from (M, N) back to (0, 0): (ops newest first,
    PAD past each walk's end; which walks left their band). With
    ``clamp``, a step outside the band, or one that would leave the
    matrix, takes the diagonal (the edge at row or column 0) instead,
    so every walk ends at (0, 0)."""
    nb = Md.shape[0]
    C, D, I = last[0], last[1], last[2]
    node = torch.where((C >= D) & (C >= I), FLAG_C,
                       torch.where(D >= I, FLAG_D, FLAG_I))
    row, col = Md.clone(), Nd.clone()
    steps = int((Md + Nd).max())
    script = torch.full((nb, steps), PAD, dtype=torch.uint8, device=dev)
    bad = torch.zeros(nb, dtype=torch.bool, device=dev)
    jobs = torch.arange(nb, device=dev)
    jW = jobs * W
    LBf, RBf = LBd.reshape(-1), RBd.reshape(-1)
    foff_d = torch.as_tensor(foff, device=dev)
    top = flags.numel() - 1
    for s in range(steps):
        live = (row > 0) | (col > 0)
        rr = row.clamp(min=0)
        fi = rr * nb + jobs
        lbr = LBf[fi]
        out = live & ((row < 0) | (col < lbr) | (col > RBf[fi]))
        if clamp:
            stuck = torch.where(node == FLAG_I, col == 0, torch.where(
                node == FLAG_D, row == 0, (row == 0) | (col == 0)))
            forced = live & (out | stuck)
            edge = torch.where((row > 0) & (col > 0), FLAG_C,
                               torch.where(row > 0, FLAG_D, FLAG_I))
            node = torch.where(forced, edge, node)
        else:
            bad = bad | out
            live = live & ~out
        st = flags[(foff_d[rr] + jW + col - lbr).clamp(0, top)].to(torch.int64)
        script[:, s] = torch.where(live, node, PAD).to(torch.uint8)
        nxt = torch.where(node == FLAG_I, st >> 4,
                          torch.where(node == FLAG_D, (st >> 2) & 3, st & 3))
        if clamp:
            nxt = torch.where(forced, node, nxt)
        row = row - (live & (node != FLAG_I)).to(row.dtype)
        col = col - (live & (node != FLAG_D)).to(col.dtype)
        node = torch.where(live, nxt, node)
    return script, bad | (row != 0) | (col != 0)


def _replay(script: np.ndarray, A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """The merged column matrix of one job from its ops, oldest first
    (mz_yama.c:294-309)."""
    M, K = A.shape
    N, L = B.shape
    useA = script != FLAG_I
    useB = script != FLAG_D
    if int(useA.sum()) != M or int(useB.sum()) != N:
        raise YamaError("new_align: script does not consume A and B exactly")
    out = np.full((script.shape[0], K + L), DASH, dtype=np.uint8)
    out[useA, :K] = A
    out[useB, K:] = B
    return out
