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
copies and replays the scripts (``mzcore.replay_payload``). Results are
bit-identical to ``yama.yama_numpy``.

Routing keeps the JAX stream's window-ladder admission (``route_band``)
and bucket keys. Its thresholds (``MZ_HOST_JOB_CELLS`` /
``MZ_HOST_ROUTE_CELLS`` / ``MZ_FLUSH_CELLS``) default by device type
(``ROUTING_DEFAULTS``): on the CPU to the JAX stream's, set on the TPU;
on CUDA to the point that ``tools/route_sweep.py`` timed fastest on an
H100 among those at which both kernels launch.

Diagnostics, as the JAX stream prints them (``multiz_tpu/ops/yama_pack.py``
``PackedDPStream.finish``): with ``MZ_COUNT_FALLBACK`` set, ``finish()``
prints the oracle-fallback share as ``[MZ_FALLBACK] jobs=... cells=...``;
with ``MZ_TIME`` set, it prints the stage split as ``[MZ_TIME] key=value``
lines with the JAX stream's keys, in seconds: ``pack`` (building the wire
buffers), ``dispatch`` (enqueueing H2D, prep, both kernels and the D2H
copy), ``device-sync`` (the wait on the launches' copy events), ``d2h``
(the device time of the payload copies, from CUDA events; 0 on the
CPU, where the payload is already on the host), ``replay``, and for the
host lane ``lane-wait`` and ``lane-busy``. The same switch records them
in memory as the stream's counters (``multiz_tpu_torch/trace.py``), from
which the lines are printed: ``stream.pack``, ``stream.dispatch``,
``stream.device-sync``, ``stream.d2h``, ``stream.replay``,
``stream.lane-wait`` and ``lane.busy`` (the host lane's workers: seconds,
jobs, cells), each in ``PackedDPStream.counters`` and in the process's
``trace.counters()``; besides, the timed counter ``stream.submit`` (a
job's ``submit``, ``trace.counters()`` only) and the span
``stream.finish`` (``trace.spans()``). With ``MZ_TIME`` unset no timer
runs and nothing is recorded.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch

from .. import scores as sc
from .. import trace
from .. import yama as Y
from ..parallel.sharding import require_device
from ..scores import from_score_params
from ..yama import YamaError, yama_numpy
from .prep import _round_up, decode_wire, prep, wire_layout
from .yama_dp import MAX_LANES, dp_forward
from .yama_tb import payload_width, traceback

# Admission rule of the JAX stream (multiz_tpu/ops/yama_pack.py:894-916):
# a job goes to the device iff, for every chunk of ROW_CHUNK rows, its
# band fits a window of the smallest width on the CWS ladder whose base
# is the 128-aligned lane under LB at the chunk's first row.
ROW_CHUNK = 32
CWS = (256, 512, 1024)
_CWS = np.asarray(CWS, dtype=np.int64)
# flag bytes of one launch (B x (m_pad+1) x band lanes, uint8); a bucket
# above it is launched in parts
LAUNCH_FLAG_BYTES = 1 << 30

# Routing by device type, in band cells: a job of at most host_job_cells
# goes to the native host lane; at the end, a bucket that never launched
# and holds fewer than host_route_cells goes there too; a bucket launches
# once it holds flush_cells; the one-shot yama_batch_packed stops feeding
# the lane at a backlog of lane_cells. Each value yields to its variable
# in ROUTING_ENV where that is set. "cpu" keeps the JAX stream's values
# (the plain versions; tests only). "cuda" is the fastest point of
# tools/route_sweep.py on the 2 Mb x 5-species tba at which both kernels
# launch: 6.485 s against 12.433 s inline and 7.257-9.035 s with every
# job on the host lane (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md). Its
# lane_cells was not swept.
ROUTING_DEFAULTS = {
    "cpu": {"host_job_cells": 65536, "host_route_cells": 1_000_000,
            "flush_cells": 4_000_000, "lane_cells": 8_000_000},
    "cuda": {"host_job_cells": 0, "host_route_cells": 1_000_000,
             "flush_cells": 16_000_000, "lane_cells": 8_000_000},
}
ROUTING_ENV = {"host_job_cells": "MZ_HOST_JOB_CELLS",
               "host_route_cells": "MZ_HOST_ROUTE_CELLS",
               "flush_cells": "MZ_FLUSH_CELLS",
               "lane_cells": "MZ_HOST_LANE_CELLS"}

# jobs and band cells by route, summed over every stream of the process
route_stats: dict = {}
_stats_lock = threading.Lock()


def reset_route_stats() -> None:
    with _stats_lock:
        route_stats.clear()
        for r in ("device", "host", "fallback"):
            route_stats[f"{r}_jobs"] = route_stats[f"{r}_cells"] = 0


reset_route_stats()


def routing_defaults(device) -> dict:
    """The routing of a stream on ``device``: its device type's row of
    ROUTING_DEFAULTS, each value replaced by its variable's where set."""
    row = ROUTING_DEFAULTS[torch.device(device).type]
    return {k: int(os.environ.get(ROUTING_ENV[k], v)) for k, v in row.items()}


def host_lane_threads() -> int:
    """Worker threads of a stream's host lane (``MZ_HOST_DP_THREADS``,
    2 by default; 0 turns the lane off)."""
    return int(os.environ.get("MZ_HOST_DP_THREADS", "2"))


def _pad_to(n: int) -> int:
    """Bucket size: the next power of two, at least 16
    (multiz_tpu/ops/yama_jax.py:311)."""
    p = 16
    while p < n:
        p *= 2
    return p


def _pad8(n: int) -> int:
    return _round_up(max(n, 1), 8)


def route_band(LB, RB, M: int, N: int) -> tuple:
    """(cw, w, cells) of one job's band (int LB, RB): the window width
    on the CWS ladder, or None when the job goes to the exact oracle;
    the widest band row RB - LB; the band cells. Validates the band
    (YamaError). One native pass (``mzcore.band_info``).

    The window ladder admits rows 1..M; row 0's band must fit the
    kernel's lanes too, and band bounds stay below 65536 columns."""
    try:
        cw, w, cells = Y._mzcore.band_info(
            np.ascontiguousarray(LB[: M + 1], dtype=np.int64),
            np.ascontiguousarray(RB[: M + 1], dtype=np.int64),
            M, N, ROW_CHUNK, _CWS,
        )
    except ValueError as e:
        raise YamaError(str(e))
    if cw == 0 or N > 65535 or w + 1 > MAX_LANES:
        cw = None
    return cw, w, cells


def bucket_key(M: int, N: int, K: int, L: int, cw: int) -> tuple:
    """(m_pad, n_pad, Kp, Lp, cw): the stream's square shape bucket."""
    p = max(_pad_to(M), _pad_to(N))
    return p, p, _pad8(K), _pad8(L), cw


def bucket_jobs(jobs) -> tuple:
    """A whole job list routed as the stream routes each job, with no
    host lane: ({bucket_key: job indices, in input order}, {job index:
    its widest band row w}, indices of the jobs for the exact oracle)."""
    buckets: dict = {}
    width: dict = {}
    oracle = []
    for idx, (A, B, LB, RB) in enumerate(jobs):
        (M, K), (N, L) = A.shape, B.shape
        cw, width[idx], _ = route_band(np.asarray(LB, dtype=np.int64),
                                       np.asarray(RB, dtype=np.int64), M, N)
        if cw is None:
            oracle.append(idx)
        else:
            buckets.setdefault(bucket_key(M, N, K, L, cw), []).append(idx)
    return buckets, width, oracle


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


def launch_cap(m_pad: int) -> int:
    """Jobs per launch of a bucket with ``m_pad`` rows: the flag store
    of a launch stays within LAUNCH_FLAG_BYTES at the widest band."""
    return max(1, LAUNCH_FLAG_BYTES // ((m_pad + 1) * MAX_LANES))


def pack_wire(jobs, m_pad, n_pad, Kp, Lp, pin=False) -> torch.Tensor:
    """(A, B, LB, RB) jobs -> one bucket's uint8 wire buffer on the host
    (``prep.wire_layout``), in pinned memory if ``pin``: one native pass
    over the jobs (``mzcore.pack_wire_into``), which writes every byte."""
    o = wire_layout(len(jobs), m_pad, n_pad, Kp, Lp)
    host = torch.empty(o["end"], dtype=torch.uint8, pin_memory=pin)
    Y._mzcore.pack_wire_into(
        jobs, host.numpy(), m_pad, n_pad, Kp, Lp,
        (o["A"], o["B"], o["LB"], o["RB"], o["MNKL"], o["end"]),
        sc.BYTE2CAT,
    )
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
        self.device = require_device(device)
        self.sp = sp if sp is not None else sc.current
        self.st = from_score_params(self.sp, self.device)
        env = os.environ.get
        routing = routing_defaults(self.device)
        self.flush_cells = routing["flush_cells"]
        self.host_route = routing["host_route_cells"]
        self.n = 0
        self.jobs: dict = {}  # slot -> (A, B, LB, RB); dropped after replay
        self.results: dict = {}  # slot -> merged matrix
        self.job_cells: dict = {}
        self.job_w: dict = {}  # slot -> widest band row (RB - LB)
        self.buckets: dict = {}  # key -> [slot, ...]
        self.bucket_cells: dict = {}
        self.dispatched: set = set()  # keys that had a device launch
        # (slots, payload, copy-done event, copy-start event or None)
        self.pending: list = []
        self.stats = {f"{r}_{u}": 0 for r in ("device", "host", "fallback")
                      for u in ("jobs", "cells")}
        self.autoflush = autoflush
        self.timing = bool(env("MZ_TIME"))
        self.counters = trace.Counters()
        # ---- host DP lane ----
        # Jobs of at most host_job_cells cells run on the native host
        # DP, which releases the GIL, on worker threads beside the
        # planning main thread; MZ_HOST_LANE_CELLS bounds the lane's
        # backlog. The backlog and the lane's counters are shared with
        # the workers, so they change only under _lock.
        self.host_job_cells = routing["host_job_cells"]
        self.host_lane_cells = (
            host_lane_cells if host_lane_cells is not None
            else int(env("MZ_HOST_LANE_CELLS", str(1 << 60)))
        )
        nthreads = host_lane_threads()
        self._lock = threading.Lock()
        self._host_pool = None
        self._host_futs: list = []
        self._host_backlog = 0  # cells submitted to the lane, not yet done
        self._host_chunk: list = []
        self._host_chunk_jobs = int(env("MZ_HOST_CHUNK", "96"))
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
        chunk, self._host_chunk = self._host_chunk, []
        if not chunk:
            return
        total = sum(c[5] for c in chunk)
        many = Y._mzcore.yama_many
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
        timing = self.timing

        def work():
            if timing:
                t0 = time.perf_counter()
            try:
                return many(probs, ss_cat, cat, go, ge)
            finally:
                with self._lock:
                    self._host_backlog -= total
                if timing:
                    self.counters.add("lane.busy", time.perf_counter() - t0,
                                      count=len(chunk), cells=total,
                                      charge=False)

        self._host_futs.append((chunk, outs, self._host_pool.submit(work)))

    # ---- device buckets ----
    def submit(self, job) -> int:
        timing = self.timing
        if timing:
            t0 = time.perf_counter()
        A, B, LB, RB = job
        slot = self.n
        self.n += 1
        M, K = A.shape
        N, L = B.shape
        LBa = np.asarray(LB, dtype=np.int64)
        RBa = np.asarray(RB, dtype=np.int64)
        cw, w, cells = route_band(LBa, RBa, M, N)
        self.job_cells[slot] = cells
        self.job_w[slot] = w
        if cw is None:
            self.stats["fallback_jobs"] += 1
            self.stats["fallback_cells"] += cells
            self.results[slot] = yama_numpy(A, B, LBa, RBa, sp=self.sp)
        elif (
            self._host_pool is not None
            and cells <= self.host_job_cells
            and self._host_backlog < self.host_lane_cells
        ):
            self._host_submit(slot, A, B, LBa, RBa, cells)
        else:
            self.jobs[slot] = (A, B, LBa, RBa)
            key = bucket_key(M, N, K, L, cw)
            self.buckets.setdefault(key, []).append(slot)
            c = self.bucket_cells.get(key, 0) + cells
            self.bucket_cells[key] = c
            if self.autoflush and c >= self.flush_cells:
                self._flush(key, charge=False)
        if timing:
            trace.tick("stream.submit", time.perf_counter() - t0)
        return slot

    def _flush(self, key, charge: bool = True) -> None:
        """Pack and launch one bucket's jobs (asynchronously on CUDA).
        ``charge``: charge the pack and dispatch counters to the open
        span (False inside ``submit``, whose own counter holds them)."""
        slots = self.buckets.pop(key)
        self.bucket_cells.pop(key, None)
        self.dispatched.add(key)
        m_pad, n_pad, Kp, Lp, _ = key
        # largest first: a warp's traceback walks then have like lengths
        slots.sort(
            key=lambda s: self.jobs[s][0].shape[0] + self.jobs[s][1].shape[0],
            reverse=True,
        )
        cap = launch_cap(m_pad)
        for lo in range(0, len(slots), cap):
            self._launch(slots[lo : lo + cap], m_pad, n_pad, Kp, Lp, charge)

    def _launch(self, part, m_pad, n_pad, Kp, Lp, charge) -> None:
        cuda = self.device.type == "cuda"
        timing = self.timing
        if timing:
            t0 = time.perf_counter()
        host = pack_wire([self.jobs[s] for s in part], m_pad, n_pad, Kp, Lp,
                         pin=cuda)
        if timing:
            t1 = time.perf_counter()
            self.counters.add("stream.pack", t1 - t0, charge=charge)
        for slot in part:
            self.stats["device_jobs"] += 1
            self.stats["device_cells"] += self.job_cells[slot]
        fw = max(self.job_w[s] for s in part) + 1
        payload = device_batch(
            host.to(self.device, non_blocking=True), len(part), m_pad, n_pad,
            Kp, Lp, fw, self.st,
        )
        done = start = None
        if cuda:
            out = torch.empty(payload.shape, dtype=torch.uint8,
                              pin_memory=True)
            if timing:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            out.copy_(payload, non_blocking=True)
            done = torch.cuda.Event(enable_timing=timing)
            done.record()
            payload = out
        self.pending.append((part, payload, done, start))
        if timing:
            self.counters.add("stream.dispatch", time.perf_counter() - t1,
                              charge=charge)

    def finish(self) -> list:
        """Launch or host-route the leftovers, wait, replay; returns the
        results in submission order and shuts the host lane down."""
        span = trace.begin("stream.finish") if self.timing else None
        try:
            return self._finish()
        finally:
            if self._host_pool is not None:
                self._host_pool.shutdown(wait=True)
            with _stats_lock:
                for k, v in self.stats.items():
                    route_stats[k] += v
            if span is not None:
                trace.end(span)

    def _finish(self) -> list:
        fb_jobs = self.stats["fallback_jobs"]
        if fb_jobs and os.environ.get("MZ_COUNT_FALLBACK"):
            fb_cells = self.stats["fallback_cells"]
            tot_cells = sum(self.job_cells.values())
            print(f"[MZ_FALLBACK] jobs={fb_jobs}/{self.n} "
                  f"cells={fb_cells}/{tot_cells} "
                  f"({100.0 * fb_cells / max(tot_cells, 1):.2f}%)", flush=True)
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
        timing, ctr = self.timing, self.counters
        # launch by launch: replaying one overlaps the device's work on
        # the next
        for slots, payload, done, _ in self.pending:
            if timing:
                t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            if timing:
                t1 = time.perf_counter()
                ctr.add("stream.device-sync", t1 - t0)
            _replay_payload_slots(payload.numpy(), slots, self.jobs,
                                  self.results)
            if timing:
                ctr.add("stream.replay", time.perf_counter() - t1)
        if timing:
            # device time, charged to no host span
            ctr.add("stream.d2h", sum(
                start.elapsed_time(done) for _, _, done, start
                in self.pending if start is not None) / 1000.0,
                count=len(self.pending), charge=False)
            sec = {k: ctr.get("stream." + k).seconds for k in (
                "pack", "dispatch", "device-sync", "d2h", "replay")}
            print(f"[MZ_TIME] pack={sec['pack']:.4f} "
                  f"dispatch={sec['dispatch']:.4f}", flush=True)
            print(f"[MZ_TIME] device-sync={sec['device-sync']:.4f} "
                  f"d2h={sec['d2h']:.4f} "
                  f"launches={[len(p) for p, *_ in self.pending]}",
                  flush=True)
            print(f"[MZ_TIME] replay={sec['replay']:.4f}", flush=True)
        self.pending = []
        futs, self._host_futs = self._host_futs, []
        if timing and futs:
            t0 = time.perf_counter()
        for chunk, outs, f in futs:
            try:
                nedits = f.result()  # re-raises worker exceptions
            except ValueError as e:
                raise YamaError(str(e))
            for (slot, *_), out, ne in zip(chunk, outs, nedits):
                self.results[slot] = out[:ne]
        if timing and futs:
            ctr.add("stream.lane-wait", time.perf_counter() - t0)
            busy = ctr.get("lane.busy")
            print(f"[MZ_TIME] lane-wait="
                  f"{ctr.get('stream.lane-wait').seconds:.4f} "
                  f"lane-busy={busy.seconds:.4f} jobs={busy.count} "
                  f"cells={busy.cells}", flush=True)
        return [self.results[i] for i in range(self.n)]


def yama_batch_packed(jobs, sp: sc.ScoreParams | None = None, device="cuda"):
    """One-shot batched DP over (A, B, LB, RB) jobs on ``device``.

    Results are merged column matrices in input order, bit-identical to
    yama_numpy. The one-shot lane cap (``routing_defaults``'
    ``lane_cells``) keeps the host lane to what it can drain in the
    shadow of the device tail."""
    st = PackedDPStream(
        sp=sp,
        host_lane_cells=routing_defaults(device)["lane_cells"],
        autoflush=False,
        device=device,
    )
    for j in jobs:
        st.submit(j)
    return st.finish()


def batch_fn_for(device):
    """The ``MultizConfig.batch_fn`` of one device: ``yama_batch_packed``
    bound to it, with its streaming class (``multiz._DeferredDP``
    constructs ``stream_cls(sp=sp)``). Raises at once if ``device`` is a
    CUDA device that is missing."""
    dev = require_device(device)

    def batch_fn(jobs, sp=None):
        return yama_batch_packed(jobs, sp=sp, device=dev)

    batch_fn.stream_cls = functools.partial(PackedDPStream, device=dev)
    batch_fn.device = dev
    return batch_fn


def replay_script(script, ne: int, A, B) -> np.ndarray:
    """Merged column matrix of one job from its edit script, newest op
    first (``ne`` ops): ``mzcore.replay_into``."""
    M, K = A.shape
    N, L = B.shape
    merged = np.empty((ne, K + L), dtype=np.uint8)
    try:
        Y._mzcore.replay_into(
            np.ascontiguousarray(script), ne, True,
            np.ascontiguousarray(A), M, K,
            np.ascontiguousarray(B), N, L, merged,
        )
    except ValueError as e:
        raise YamaError(str(e))
    return merged


def _replay_payload_slots(out_np, slots, jobs: dict, results: dict):
    """Replay one launch's payload ([nedit LE32] + 2-bit ops, newest
    first) into merged column matrices at results[slot], in one native
    pass (``mzcore.replay_payload``), which pops each job so a long stream
    does not hold every operand alive. YamaError at the first job, in
    slot order, whose payload row or script is wrong."""
    try:
        Y._mzcore.replay_payload(out_np, slots, jobs, results)
    except ValueError as e:
        raise YamaError(str(e))
