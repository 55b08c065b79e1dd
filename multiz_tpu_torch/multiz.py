"""multiz: combine two reference-topped, sorted, single-coverage blocksets.

Port of the merge scan in multiz.c:60-177 plus the per-chromosome driver
(multiz.c:259-285). Output interleaving (merged blocks to ``out``, unused
pieces to ``out1``/``out2`` which may alias ``out``) is preserved exactly
for byte-equality with the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from . import scores as sc
from . import trace
from .blocks import keep_ali, make_part_ali_col, nd_col, separate_by_src
from .maf import Ali, write_ali
from .preyama import pre_yama, pre_yama_gen
from .yama import yama_numpy


@dataclass
class MultizConfig:
    radius: int = 30  # R=, multi_util.c:13
    min_output_wid: int = 1  # M=, multi_util.c:14
    lrg_break_wid: int = 20  # L=, accepted but unused (multiz.c:100-115 dead)
    sml_break_wid: int = 2  # S=, accepted but unused
    row2: int = 0  # always 0 in v11.2 (multi_util.c:24; 'all' also sets 0)
    dp_fn: Callable = yama_numpy
    # When set, multiz runs two-phase (SURVEY.md §7 step 4): the merge
    # scan plans every overlap DP, ``batch_fn(jobs, sp=...)`` executes
    # them as batched device launches (e.g. ops.yama_pack.
    # yama_batch_packed), and outputs are stitched back in scan order.
    batch_fn: Optional[Callable] = None


class _Writer:
    """Emission helper honoring the row2 / MIN_OUTPUT_WID rules.

    ``sink`` is a callable receiving Ali blocks (or None when the output is
    discarded, the C's fpw == NULL)."""

    def __init__(self, sink, cfg: MultizConfig):
        self.fh = sink  # truthiness stands in for `fpw != NULL`
        self.cfg = cfg

    def write_block(self, a: Optional[Ali], min_wid_check: bool = True):
        """mafWrite gated as in multiz.c:70-77 (flush path)."""
        if a is None or self.fh is None:
            return
        if min_wid_check and a.comps[0].size < self.cfg.min_output_wid:
            return
        if self.cfg.row2 == 0 or len(a.comps) > 1:
            self.fh(a)

    def write_part(self, a: Optional[Ali]):
        """print_part_ali_col's write rule (multi_util.c:620-629): row2
        check only, no MIN_OUTPUT_WID."""
        if a is None or self.fh is None:
            return
        if self.cfg.row2 == 0 or len(a.comps) > 1:
            self.fh(a)


class _DeferredDP:
    """Collects pre_yama coroutines during planning; executes their DP
    jobs in batched rounds (round 1 = every first DP, round 2 = the
    v==0 second DPs, ...), then exposes per-slot results.

    When the batch backend publishes a ``stream_cls`` (e.g.
    ops.yama_pack.yama_batch_packed), round-1 jobs are forwarded to a
    streaming instance AS THE SCAN PLANS THEM, so padded bucket
    launches dispatch asynchronously and the device computes under the
    host's remaining planning work; ``run()`` only pays the tail.

    Where the run's trace is on (``trace.on``, read once here), the
    coroutines' steps are timed counters: ``preyama.plan`` (planning a
    job, ``next(gen)``) and ``preyama.fold`` (folding its result in,
    ``gen.send``), named ``preyama.plan.v0`` and ``preyama.fold.v0`` in
    a v == 0 call; and each round after the first (its DP call: the
    jobs' dispatch, wait and replay) is a span ``multiz.dp.round2`` with
    attrs ``round``, ``jobs`` and ``cells`` (band cells of rows 1..M)."""

    def __init__(self, batch_fn: Callable, sp, v: int):
        self.batch_fn = batch_fn
        self.sp = sp
        self.pending: list = []  # (gen, slot, job-or-stream-handle)
        self.results: dict = {}
        self.n = 0
        self.timing = trace.on
        suffix = ".v0" if v == 0 else ""
        self.plan_name = "preyama.plan" + suffix
        self.fold_name = "preyama.fold" + suffix
        stream_cls = getattr(batch_fn, "stream_cls", None)
        self.stream = stream_cls(sp=sp) if stream_cls is not None else None

    def submit(self, gen) -> int:
        slot = self.n
        self.n += 1
        timing = self.timing
        if timing:
            t0 = time.perf_counter()
        try:
            job = next(gen)
        except StopIteration as e:
            self.results[slot] = e.value
            return slot
        finally:
            if timing:
                trace.tick(self.plan_name, time.perf_counter() - t0)
        if self.stream is not None:
            job = self.stream.submit(job)  # -> stream handle
        self.pending.append((gen, slot, job))
        return slot

    @trace.traced("multiz.dp")
    def run(self) -> None:
        timing = self.timing
        rnd = 1
        while self.pending:
            if self.stream is not None and rnd == 1:
                outs_all = self.stream.finish()
                outs = [outs_all[h] for (_, _, h) in self.pending]
            else:
                jobs = [j for (_, _, j) in self.pending]
                if timing and rnd > 1:
                    with trace.span("multiz.dp.round2", round=rnd,
                                    jobs=len(jobs), cells=_band_cells(jobs)):
                        outs = self.batch_fn(jobs, sp=self.sp)
                else:
                    outs = self.batch_fn(jobs, sp=self.sp)
            rnd += 1
            nxt = []
            for (gen, slot, _), res in zip(self.pending, outs):
                if timing:
                    t0 = time.perf_counter()
                try:
                    job2 = gen.send(res)
                except StopIteration as e:
                    self.results[slot] = e.value
                else:
                    nxt.append((gen, slot, job2))
                if timing:
                    trace.tick(self.fold_name, time.perf_counter() - t0)
            self.pending = nxt


def _band_cells(jobs) -> int:
    """Band cells of rows 1..M of (A, B, LB, RB) jobs."""
    n = 0
    for A, _, LB, RB in jobs:
        M = A.shape[0]
        n += int((RB[1 : M + 1] - LB[1 : M + 1] + 1).sum())
    return n


@trace.traced("multiz.scan")
def multiz_scan(
    wk1: List[Ali],
    wk2: List[Ali],
    out,
    w1: _Writer,
    w2: _Writer,
    v: int,
    cfg: MultizConfig,
    sp: sc.ScoreParams | None = None,
    dp_submit: Optional[Callable] = None,
) -> None:
    """The two-pointer merge scan (multiz.c:60-177)."""
    i1 = i2 = 0

    def pop1():
        nonlocal i1
        if i1 >= len(wk1):
            return None
        a = wk1[i1]
        i1 += 1
        return a

    def pop2():
        nonlocal i2
        if i2 >= len(wk2):
            return None
        a = wk2[i2]
        i2 += 1
        return a

    a1 = pop1()
    a2 = pop2()
    while True:
        while a1 is not None and (
            a2 is None or a1.comps[0].end - 1 < a2.comps[0].start
        ):
            w1.write_block(a1)
            a1 = pop1()
        while a2 is not None and (
            a1 is None or a2.comps[0].end - 1 < a1.comps[0].start
        ):
            w2.write_block(a2)
            a2 = pop2()
        if a1 is None and a2 is None:
            break
        if a1 is None or a2 is None:
            continue
        if a1.comps[0].end - 1 < a2.comps[0].start:
            continue
        if a2.comps[0].end - 1 < a1.comps[0].start:
            continue

        beg1 = a1.comps[0].start
        end1 = a1.comps[0].end - 1
        beg2 = a2.comps[0].start
        end2 = a2.comps[0].end - 1

        # uncovered front flank (multiz.c:117-133): from the row's
        # first column (the dash walk back from its first base ends at
        # 0) to the column before its next base after beg2 - 1
        if beg1 < beg2 and beg2 - beg1 >= cfg.min_output_wid and w1.fh:
            ce = nd_col(a1.comps[0], beg2 - beg1) - 1
            w1.write_part(make_part_ali_col(a1, 0, ce, sp))
        elif beg2 < beg1 and beg1 - beg2 >= cfg.min_output_wid and w2.fh:
            ce = nd_col(a2.comps[0], beg1 - beg2) - 1
            w2.write_part(make_part_ali_col(a2, 0, ce, sp))

        beg = max(beg1, beg2)
        end = min(end1, end2)

        # leading gap columns before the first base (multiz.c:139-148)
        if beg == beg1:
            cb = nd_col(a1.comps[0], 0)
            if cb != 0 and w1.fh:
                w1.write_part(make_part_ali_col(a1, 0, cb - 1, sp))
        if beg == beg2:
            cb = nd_col(a2.comps[0], 0)
            if cb != 0 and w2.fh:
                w2.write_part(make_part_ali_col(a2, 0, cb - 1, sp))

        if dp_submit is not None:
            dp_submit(
                pre_yama_gen(
                    a1, a2, beg, end, cfg.radius, v,
                    unused2_sink=w2.write_part, sp=sp,
                )
            )
        else:
            new_ali = pre_yama(
                a1, a2, beg, end, cfg.radius, v,
                unused2_sink=w2.write_part, sp=sp, dp_fn=cfg.dp_fn,
            )
            if (
                new_ali is not None
                and new_ali.comps[0].size >= cfg.min_output_wid
            ):
                out(new_ali)

        if end1 < end2:
            a2 = keep_ali(a2, end1 + 1, sp)
        if end2 < end1:
            a1 = keep_ali(a1, end2 + 1, sp)

        # trailing gap columns after the last base (end1 is a1's last)
        if end1 <= end2:
            ce = nd_col(a1.comps[0], a1.comps[0].size - 1)
            if ce < a1.text_size - 1 and w1.fh:
                w1.write_part(make_part_ali_col(
                    a1, ce + 1, a1.text_size - 1, sp))
            a1 = pop1()
        if end2 <= end1:
            ce = nd_col(a2.comps[0], a2.comps[0].size - 1)
            if ce < a2.text_size - 1 and w2.fh:
                w2.write_part(make_part_ali_col(
                    a2, ce + 1, a2.text_size - 1, sp))
            a2 = pop2()


@trace.traced("multiz")
def multiz(
    list1: List[Ali],
    list2: List[Ali],
    v: int,
    out,
    out1=None,
    out2=None,
    cfg: MultizConfig | None = None,
    sp: sc.ScoreParams | None = None,
) -> None:
    """Per-chromosome driver (multiz.c:259-285). ``out``/``out1``/``out2``
    are streams or Ali sinks; ``out1``/``out2`` default to ``out`` (the
    argc==4 path where everything interleaves on stdout)."""
    if cfg is None:
        cfg = MultizConfig()
    out = _as_sink(out)
    out1 = _as_sink(out1) if out1 is not None else out
    out2 = _as_sink(out2) if out2 is not None else out

    # ---- two-phase device mode: record every emission in scan order,
    # batch all DP jobs, then replay (SURVEY.md §7 step 4) ----
    defer = events = None
    final_out, final_out1, final_out2 = out, out1, out2
    if cfg.batch_fn is not None:
        defer = _DeferredDP(cfg.batch_fn, sp, v)
        events = []

        def _rec(sink):
            if sink is None:
                return None
            return lambda a: events.append((sink, a))

        out, out1, out2 = _rec(out), _rec(out1), _rec(out2)

    w1 = _Writer(out1, cfg)
    w2 = _Writer(out2, cfg)
    dp_submit = None
    if defer is not None:
        dp_submit = lambda gen: events.append(  # noqa: E731
            (None, defer.submit(gen))
        )
    cp1, cp2 = list(list1), list(list2)
    while cp1 and cp2:
        chrom = cp1[0].comps[0].src
        cp1, wk1 = separate_by_src(cp1, chrom)
        cp2, wk2 = separate_by_src(cp2, chrom)
        multiz_scan(wk1, wk2, out, w1, w2, v, cfg, sp=sp,
                    dp_submit=dp_submit)
    # leftovers when one side ran out of chromosomes (multiz.c:277-285):
    # row2 rule applies but MIN_OUTPUT_WID does not
    for a in cp1:
        if out1 is not None and (cfg.row2 == 0 or len(a.comps) > 1):
            out1(a)
    for a in cp2:
        if out2 is not None and (cfg.row2 == 0 or len(a.comps) > 1):
            out2(a)

    if defer is not None:
        defer.run()
        for sink, a in events:
            if sink is not None:
                sink(a)
                continue
            new_ali = defer.results[a]  # a is the DP slot id
            if (
                new_ali is not None
                and new_ali.comps[0].size >= cfg.min_output_wid
            ):
                final_out(new_ali)


def _as_sink(out):
    """Accept a text stream or an Ali-callable."""
    if out is None or callable(out):
        return out
    return lambda a: write_ali(out, a)
