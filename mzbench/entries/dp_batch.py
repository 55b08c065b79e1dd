"""Entry ``dp_batch``: one caller in a closed loop on
``ops.yama_pack.yama_batch_packed(jobs, device=...)``, the batched DP that
``tba_run(parallel=N)``'s pooled merges and the multi-process path call.

Set-up makes the job pool and its calls from the seed (traffic kind
``dp_pool``: the same calls, shape for shape, for every seed, in the
seed's order); the window makes the calls in that order and wraps, and a
call's work is its jobs' band cells. Warm-up makes every call once, so
every launch shape the window uses has run; the window then starts over
at the first call.

The check runs the reference DP (``reference/dp.py``) once over the pool
and compares every merged column matrix of every call of the window
with the pool's answer: ``dp_results_differing`` counts the answers
that differ, limit 0.
"""

from __future__ import annotations

import numpy as np

from .. import work
from ..reference import dp as reference
from ..traffic import dp_pool


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.answers: list = []  # (job indices, results) of each call

    def setup(self) -> None:
        ctx, mix = self.ctx, self.ctx.mix
        self.pool, self.calls = dp_pool.make_calls(mix, ctx.seed)
        self.cells = [work.band_cells(j) for j in self.pool]
        from multiz_tpu_torch.ops import yama_pack

        self.yama_pack = yama_pack
        dev = ctx.device
        if ctx.control is None:
            def call(jobs):
                return yama_pack.yama_batch_packed(jobs, device=dev)
        else:
            def call(jobs):  # the control in the program's place
                return reference.yama_batch(jobs, device=dev, **ctx.control)
        self.call = call
        self.cursor = 0
        for _ in self.calls:
            self.call([self.pool[i] for i in self._next()])
        self.cursor = 0

    def _next(self) -> list:
        idx = self.calls[self.cursor]
        self.cursor = (self.cursor + 1) % len(self.calls)
        return idx

    def op(self) -> int:
        idx = self._next()
        out = self.call([self.pool[i] for i in idx])
        self.answers.append((idx, out))
        return sum(self.cells[i] for i in idx)

    def check(self) -> dict:
        ref = reference.yama_batch(self.pool, device=self.ctx.device)
        bad = 0
        for idx, out in self.answers:
            if len(out) != len(idx):
                bad += len(idx)
                continue
            bad += sum(not np.array_equal(o, ref[i]) for i, o in zip(idx, out))
        return {"dp_results_differing": (bad, 0)}

    def release(self) -> None:
        self.call = None
