"""The packed DP stream: the merge scan's DP jobs, batched onto the GPU.

Port of ``multiz_tpu/ops/yama_pack.py``'s host driver. The merge scan
submits each DP job as it plans it (``multiz._DeferredDP``). Small jobs
go to the native host lane (``mzcore.yama_many`` on worker threads);
the rest collect in shape buckets, and a bucket that holds
``MZ_FLUSH_CELLS`` band cells is packed into one wire buffer and
launched asynchronously: H2D copy, prep (``ops/prep.py``), the DP
forward kernel (``ops/yama_dp.py``), the traceback kernel
(``ops/yama_tb.py``) and a D2H copy of the edit-script payload.
``finish()`` launches or host-routes the leftovers, waits for the
copies and replays the scripts (``mzcore.replay_into``). Results are
bit-identical to ``multiz_tpu.yama.yama_numpy``.

Routing matches the JAX stream at its defaults: the same window-ladder
admission (``pick_cw``), the same bucket keys, the same
``MZ_HOST_JOB_CELLS`` / ``MZ_HOST_ROUTE_CELLS`` / ``MZ_FLUSH_CELLS``.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch

from multiz_tpu import scores as sc
from multiz_tpu.yama import _check_band

from ..scores import from_score_params
from .prep import _round_up, decode_wire, prep, wire_layout
from .yama_dp import MAX_LANES, dp_forward
from .yama_tb import payload_width, traceback

# Admission rule of the JAX stream (multiz_tpu/ops/yama_pack.py:894-916):
# a job goes to the device iff, for every chunk of ROW_CHUNK rows, its
# band fits a window of the smallest width on the CWS ladder whose base
# is the 128-aligned lane under LB at the chunk's first row.
ROW_CHUNK = 32
CWS = (256, 512, 1024)
# flag bytes of one launch (B x (m_pad+1) x band lanes, uint8); a bucket
# above it is launched in parts
LAUNCH_FLAG_BYTES = 1 << 30

# jobs and band cells by route, summed over every stream of the process
route_stats: dict = {}
_stats_lock = threading.Lock()


def reset_route_stats() -> None:
    with _stats_lock:
        route_stats.clear()
        for r in ("device", "host", "fallback"):
            route_stats[f"{r}_jobs"] = route_stats[f"{r}_cells"] = 0


reset_route_stats()


def _pad_to(n: int) -> int:
    """Bucket size: the next power of two, at least 16
    (multiz_tpu/ops/yama_jax.py:311)."""
    p = 16
    while p < n:
        p *= 2
    return p


def _pad8(n: int) -> int:
    return _round_up(max(n, 1), 8)


def _pack_cat_rows(dst, X, nrow, rp2):
    """Pack BYTE2CAT categories of X (ncol, nrow) into dst (rp2, >=ncol)
    uint8 nibbles: low nibble of packed row p = row p, high nibble =
    row p + rp2 (the device unpack is a plain concat, see prep.col_stats)."""
    cat = sc.BYTE2CAT[X].astype(np.uint8).T  # (nrow, ncol)
    ncol = cat.shape[1]
    lo = min(nrow, rp2)
    dst[:lo, :ncol] = cat[:lo]
    if nrow > rp2:
        hi = nrow - rp2
        dst[:hi, :ncol] |= cat[rp2:] << 4


def fits_packed(LB, RB, M, N, cw: int = CWS[0]) -> bool:
    """True iff every chunk window fits in ``cw`` lanes."""
    mp1 = M + 1
    nchunks = -(-mp1 // ROW_CHUNK)
    for t in range(nchunks):
        r0 = min(max(t * ROW_CHUNK, 1), M)
        w0 = (int(LB[r0]) // 128) * 128
        hi = min(t * ROW_CHUNK + ROW_CHUNK - 1, M)
        lo = max(t * ROW_CHUNK, 1)
        if lo > hi:
            continue
        if int(np.max(RB[lo : hi + 1])) + 1 - w0 > cw - 1:
            return False
    return True


def pick_cw(LB, RB, M, N) -> int | None:
    """Smallest window width on the CWS ladder that fits this problem's
    band, or None (-> host oracle fallback)."""
    for cw in CWS:
        if fits_packed(LB, RB, M, N, cw):
            return cw
    return None


def bucket_of(jobs) -> tuple:
    """(m_pad, n_pad, Kp, Lp, fw) of one launch holding ``jobs``: the
    stream's square bucket padding and the widest band in lanes."""
    p = max(max(_pad_to(A.shape[0]), _pad_to(B.shape[0]))
            for A, B, _, _ in jobs)
    Kp = max(_pad8(A.shape[1]) for A, _, _, _ in jobs)
    Lp = max(_pad8(B.shape[1]) for _, B, _, _ in jobs)
    fw = max(int((np.asarray(RB)[: A.shape[0] + 1]
                  - np.asarray(LB)[: A.shape[0] + 1]).max())
             for A, _, LB, RB in jobs) + 1
    return p, p, Kp, Lp, fw


def pack_wire(jobs, m_pad, n_pad, Kp, Lp, pin=False) -> torch.Tensor:
    """(A, B, LB, RB) jobs -> one bucket's uint8 wire buffer on the host
    (``prep.wire_layout``), in pinned memory if ``pin``."""
    nb = len(jobs)
    mp1 = m_pad + 1
    o = wire_layout(nb, m_pad, n_pad, Kp, Lp)
    host = torch.zeros(o["end"], dtype=torch.uint8, pin_memory=pin)
    hb = host.numpy()
    Kp2, Lp2 = -(-Kp // 2), -(-Lp // 2)
    Atex = hb[o["A"]:o["B"]].reshape(nb, Kp2, m_pad)
    Btex = hb[o["B"]:o["B"] + nb * Lp2 * n_pad].reshape(nb, Lp2, n_pad)
    LBs = hb[o["LB"]:o["RB"]].view(np.int32).reshape(nb, mp1)
    RBs = hb[o["RB"]:o["MNKL"]].view(np.int32).reshape(nb, mp1)
    MNKL = hb[o["MNKL"]:o["end"]].view(np.int32).reshape(nb, 4)
    for i, (A, B, LB, RB) in enumerate(jobs):
        M, K = A.shape
        N, L = B.shape
        _pack_cat_rows(Atex[i], A, K, Kp2)
        _pack_cat_rows(Btex[i], B, L, Lp2)
        LBs[i, : M + 1] = LB[: M + 1]
        RBs[i, : M + 1] = RB[: M + 1]
        LBs[i, M + 1 :] = LB[M]
        RBs[i, M + 1 :] = RB[M]
        MNKL[i] = (M, N, K, L)
    return host


def device_batch(buf, nb, m_pad, n_pad, Kp, Lp, fw, st):
    """One bucket on the device: wire buffer in, (nb, payload_width)
    uint8 payload out (``ops/yama_tb.py``). ``fw`` is the widest band
    of the bucket in lanes; ``st`` the ScoreTensors."""
    Atex, Btex, LB, RB, MNKL = decode_wire(buf, nb, m_pad, n_pad, Kp, Lp)
    ops = prep(Atex, Btex, LB, RB, MNKL, st)
    flags, last = dp_forward(ops, st.gap_open, st.gap_extend, fw)
    return traceback(flags, ops.lb, ops.mnkl, last,
                     payload_width(m_pad, n_pad))


class PackedDPStream:
    """Streaming batched DP over (A, B, LB, RB) jobs on ``device``.

    ``submit`` routes each job (host lane, device bucket, or the exact
    oracle for bands that fit no window) and launches a bucket once it
    holds ``flush_cells`` band cells. ``finish()`` returns the merged
    column matrices in submission order and shuts the host lane down.
    On a CUDA device every launch is asynchronous and the payloads are
    copied back in ``finish()``; on the CPU the kernels' plain versions
    run synchronously (tests only)."""

    def __init__(
        self,
        sp: sc.ScoreParams | None = None,
        host_lane_cells: int | None = None,
        autoflush: bool = True,
        device="cuda",
    ):
        from multiz_tpu.yama import _mzcore

        self.device = torch.device(device)
        self.sp = sp if sp is not None else sc.current
        self.st = from_score_params(self.sp, self.device)
        env = os.environ.get
        self.flush_cells = int(env("MZ_FLUSH_CELLS", "4000000"))
        self.host_route = int(env("MZ_HOST_ROUTE_CELLS", "1000000"))
        self._binfo = getattr(_mzcore, "band_info", None) if _mzcore else None
        self._cws = np.asarray(CWS, dtype=np.int64)
        self.n = 0
        self.jobs: dict = {}  # slot -> (A, B, LB, RB); dropped after replay
        self.results: dict = {}  # slot -> merged matrix
        self.job_cells: dict = {}
        self.job_w: dict = {}  # slot -> widest band row (RB - LB)
        self.buckets: dict = {}  # key -> [slot, ...]
        self.bucket_cells: dict = {}
        self.dispatched: set = set()  # keys that had a device launch
        self.pending: list = []  # (slots, payload, copy-done event)
        self.stats = {f"{r}_{u}": 0 for r in ("device", "host", "fallback")
                      for u in ("jobs", "cells")}
        self.autoflush = autoflush
        # ---- host DP lane ----
        # Jobs of at most MZ_HOST_JOB_CELLS cells run on the native host
        # DP, which releases the GIL, on worker threads beside the
        # planning main thread; MZ_HOST_LANE_CELLS bounds the lane's
        # backlog. The backlog and the lane's counters are shared with
        # the workers, so they change only under _lock.
        self.host_job_cells = int(env("MZ_HOST_JOB_CELLS", "65536"))
        self.host_lane_cells = (
            host_lane_cells if host_lane_cells is not None
            else int(env("MZ_HOST_LANE_CELLS", str(1 << 60)))
        )
        nthreads = int(env("MZ_HOST_DP_THREADS", "2"))
        self._lock = threading.Lock()
        self._host_pool = None
        self._host_futs: list = []
        self._host_backlog = 0  # cells submitted to the lane, not yet done
        self._host_chunk: list = []
        self._host_chunk_jobs = int(env("MZ_HOST_CHUNK", "96"))
        self._lane_busy_s = 0.0
        self._lane_jobs = 0
        self._lane_cells = 0
        if nthreads > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._host_pool = ThreadPoolExecutor(
                max_workers=nthreads, thread_name_prefix="mz-hostdp"
            )

    # ---- host lane ----
    def _host_submit(self, slot, A, B, LBa, RBa, cells) -> None:
        # chunked: a worker runs a whole chunk under one GIL release
        with self._lock:
            self._host_backlog += cells
        self.stats["host_jobs"] += 1
        self.stats["host_cells"] += cells
        self._host_chunk.append((slot, A, B, LBa, RBa, cells))
        if len(self._host_chunk) >= self._host_chunk_jobs:
            self._host_flush()

    def _host_flush(self) -> None:
        from multiz_tpu.yama import _mzcore, yama_numpy

        chunk, self._host_chunk = self._host_chunk, []
        if not chunk:
            return
        total = sum(c[5] for c in chunk)
        many = getattr(_mzcore, "yama_many", None) if _mzcore else None
        if many is None:
            for slot, A, B, LB, RB, _ in chunk:
                self.results[slot] = yama_numpy(A, B, LB, RB, sp=self.sp)
            with self._lock:
                self._host_backlog -= total
            return
        # all Python/numpy prep on this thread; the worker runs only the
        # GIL-free native batch call
        probs = []
        outs = []
        for slot, A, B, LB, RB, _ in chunk:
            M, K = A.shape
            N, L = B.shape
            out = np.empty((M + N, K + L), dtype=np.uint8)
            probs.append((
                np.ascontiguousarray(A), M, K,
                np.ascontiguousarray(B), N, L,
                np.ascontiguousarray(LB[: M + 1]),
                np.ascontiguousarray(RB[: M + 1]), out,
            ))
            outs.append(out)
        ss_cat, cat = self.sp.ss_cat, sc.BYTE2CAT
        go, ge = int(self.sp.gap_open), int(self.sp.gap_extend)

        def work():
            t0 = time.perf_counter()
            try:
                return many(probs, ss_cat, cat, go, ge)
            finally:
                with self._lock:
                    self._host_backlog -= total
                    self._lane_busy_s += time.perf_counter() - t0
                    self._lane_jobs += len(chunk)
                    self._lane_cells += total

        self._host_futs.append((chunk, outs, self._host_pool.submit(work)))

    # ---- device buckets ----
    def submit(self, job) -> int:
        from multiz_tpu.yama import YamaError, yama_numpy

        A, B, LB, RB = job
        slot = self.n
        self.n += 1
        M, K = A.shape
        N, L = B.shape
        LBa = np.asarray(LB, dtype=np.int64)
        RBa = np.asarray(RB, dtype=np.int64)
        if self._binfo is not None:
            # one native pass: validation + window ladder + cell count
            try:
                cw, w, cells = self._binfo(
                    np.ascontiguousarray(LBa[: M + 1]),
                    np.ascontiguousarray(RBa[: M + 1]),
                    M, N, ROW_CHUNK, self._cws,
                )
            except ValueError as e:
                raise YamaError(str(e))
            cw = cw or None
        else:
            _check_band(LBa, RBa, M, N)
            cells = int((np.minimum(RBa[: M + 1], N) - LBa[: M + 1]).sum()) + M
            cw = pick_cw(LBa, RBa, M, N)
            w = int((RBa[: M + 1] - LBa[: M + 1]).max())
        self.job_cells[slot] = cells
        self.job_w[slot] = w
        # the window ladder admits rows 1..M; row 0's band must fit the
        # kernel's lanes too
        if cw is None or N > 65535 or w + 1 > MAX_LANES:
            self.stats["fallback_jobs"] += 1
            self.stats["fallback_cells"] += cells
            self.results[slot] = yama_numpy(A, B, LBa, RBa, sp=self.sp)
            return slot
        if (
            self._host_pool is not None
            and cells <= self.host_job_cells
            and self._host_backlog < self.host_lane_cells
        ):
            self._host_submit(slot, A, B, LBa, RBa, cells)
            return slot
        self.jobs[slot] = (A, B, LBa, RBa)
        p = max(_pad_to(M), _pad_to(N))  # square buckets
        key = (p, p, _pad8(K), _pad8(L), cw)
        self.buckets.setdefault(key, []).append(slot)
        c = self.bucket_cells.get(key, 0) + cells
        self.bucket_cells[key] = c
        if self.autoflush and c >= self.flush_cells:
            self._flush(key)
        return slot

    def _flush(self, key) -> None:
        """Pack and launch one bucket's jobs (asynchronously on CUDA)."""
        slots = self.buckets.pop(key)
        self.bucket_cells.pop(key, None)
        self.dispatched.add(key)
        m_pad, n_pad, Kp, Lp, _ = key
        # largest first: a warp's traceback walks then have like lengths
        slots.sort(
            key=lambda s: self.jobs[s][0].shape[0] + self.jobs[s][1].shape[0],
            reverse=True,
        )
        per_job = (m_pad + 1) * MAX_LANES
        cap = max(1, LAUNCH_FLAG_BYTES // per_job)
        for lo in range(0, len(slots), cap):
            self._launch(slots[lo : lo + cap], m_pad, n_pad, Kp, Lp)

    def _launch(self, part, m_pad, n_pad, Kp, Lp) -> None:
        cuda = self.device.type == "cuda"
        host = pack_wire([self.jobs[s] for s in part], m_pad, n_pad, Kp, Lp,
                         pin=cuda)
        for slot in part:
            self.stats["device_jobs"] += 1
            self.stats["device_cells"] += self.job_cells[slot]
        fw = max(self.job_w[s] for s in part) + 1
        payload = device_batch(
            host.to(self.device, non_blocking=True), len(part), m_pad, n_pad,
            Kp, Lp, fw, self.st,
        )
        done = None
        if cuda:
            out = torch.empty(payload.shape, dtype=torch.uint8,
                              pin_memory=True)
            out.copy_(payload, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            payload = out
        self.pending.append((part, payload, done))

    def finish(self) -> list:
        """Launch or host-route the leftovers, wait, replay; returns the
        results in submission order and shuts the host lane down."""
        try:
            return self._finish()
        finally:
            if self._host_pool is not None:
                self._host_pool.shutdown(wait=True)
            with _stats_lock:
                for k, v in self.stats.items():
                    route_stats[k] += v

    def _finish(self) -> list:
        from multiz_tpu.yama import YamaError, yama_numpy

        # Buckets that never launched and stay below host_route cells go
        # to the host lane; the others launch now.
        for key in list(self.buckets.keys()):
            if (
                key not in self.dispatched
                and self.bucket_cells.get(key, 0) < self.host_route
            ):
                for slot in self.buckets.pop(key):
                    A, B, LB, RB = self.jobs.pop(slot)
                    if self._host_pool is not None:
                        self._host_submit(slot, A, B, LB, RB,
                                          self.job_cells[slot])
                    else:
                        self.stats["host_jobs"] += 1
                        self.stats["host_cells"] += self.job_cells[slot]
                        self.results[slot] = yama_numpy(A, B, LB, RB,
                                                        sp=self.sp)
                self.bucket_cells.pop(key, None)
            else:
                self._flush(key)
        if self._host_pool is not None:
            self._host_flush()  # partial chunk
        for slots, payload, done in self.pending:
            if done is not None:
                done.synchronize()
            _replay_payload_slots(payload.numpy(), slots, self.jobs,
                                  self.results)
        self.pending = []
        futs, self._host_futs = self._host_futs, []
        for chunk, outs, f in futs:
            try:
                nedits = f.result()  # re-raises worker exceptions
            except ValueError as e:
                raise YamaError(str(e))
            for (slot, *_), out, ne in zip(chunk, outs, nedits):
                self.results[slot] = out[:ne]
        return [self.results[i] for i in range(self.n)]


def yama_batch_packed(jobs, sp: sc.ScoreParams | None = None, device="cuda"):
    """One-shot batched DP over (A, B, LB, RB) jobs on ``device``.

    Results are merged column matrices in input order, bit-identical to
    yama_numpy. The one-shot lane cap keeps the host lane to what it can
    drain in the shadow of the device tail."""
    st = PackedDPStream(
        sp=sp,
        host_lane_cells=int(os.environ.get("MZ_HOST_LANE_CELLS", "8000000")),
        autoflush=False,
        device=device,
    )
    for j in jobs:
        st.submit(j)
    return st.finish()


def batch_fn_for(device):
    """The ``MultizConfig.batch_fn`` of one device: ``yama_batch_packed``
    bound to it, with its streaming class (``multiz._DeferredDP``
    constructs ``stream_cls(sp=sp)``)."""
    dev = torch.device(device)

    def batch_fn(jobs, sp=None):
        return yama_batch_packed(jobs, sp=sp, device=dev)

    batch_fn.stream_cls = functools.partial(PackedDPStream, device=dev)
    batch_fn.device = dev
    return batch_fn


def _replay_payload_slots(out_np, slots, jobs: dict, results: dict):
    """Replay one launch's payload ([nedit LE32] + 2-bit ops, newest
    first) into merged column matrices at results[slot]; pops each job
    after replay so a long stream does not hold every operand alive."""
    from multiz_tpu.yama import YamaError, _mzcore, _replay

    for i, slot in enumerate(slots):
        A, B, _, _ = jobs.pop(slot)
        ne = int(out_np[i, :4].view(np.uint32)[0])
        pk = out_np[i, 4 : 4 + (ne + 3) // 4]
        script_rev = (
            (pk[:, None] >> (np.arange(4, dtype=np.uint8) * 2)) & 3
        ).astype(np.uint8).reshape(-1)[:ne]
        M, K = A.shape
        N, L = B.shape
        if _mzcore is not None:
            merged = np.empty((ne, K + L), dtype=np.uint8)
            try:
                _mzcore.replay_into(
                    np.ascontiguousarray(script_rev), ne, True,
                    np.ascontiguousarray(A), M, K,
                    np.ascontiguousarray(B), N, L, merged,
                )
            except ValueError as e:
                raise YamaError(str(e))
            results[slot] = merged
        else:
            results[slot] = _replay(script_rev[::-1].copy(), A, B)
