"""Spans and counters of the host's work, kept in memory.

The switch is ``MZ_TIME``. It is read where a run starts (``run``, once
per ``tree.tba_run`` or ``roast_run``, which sets ``on``) and once per
DP stream (``ops/yama_pack.PackedDPStream``, its own flag). With it
unset nothing is recorded, and the per-job and per-block sites read no
clock: each tests one flag that was read once.

A span has a name, a start and an end on ``time.perf_counter()``, the
index of its parent span and the id of the run (tba or roast) it
belongs to, shared by every span of that run. Its parent is the
innermost span open on its thread; on a worker thread, the span that
``attach`` names (``tba_run(parallel=N)``'s merge threads name the
run's root).

A counter has a name, a count, seconds and cells. A timed counter
also charges its seconds to the innermost span open on its thread, so a
span's self time is its duration less its child spans and the timed
counters inside it (``self_seconds``). ``tick`` counts one timed event
of a per-job or per-block site; each thread keeps its own part of those
counters, so a tick takes no lock. ``count`` adds to a counter from any
thread, under the lock. A ``Counters`` object keeps the counters of one
owner, a DP stream, and adds each one to the process's too.

Everything is process-wide: ``spans()`` and ``counters()`` read it,
``reset()`` clears it (tests, with no span open).
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from contextlib import contextmanager, nullcontext

on = False  # the switch, as the last run read it

_lock = threading.Lock()
_spans: list = []
_run_ids = itertools.count(1)
_OFF = nullcontext()
_ticked: list = []  # each ticking thread's counters


class _Thread(threading.local):
    def __init__(self):
        self.stack: list = []  # indices of the spans open on this thread
        self.counters: dict = {}  # this thread's part of the ticks
        self.listed = False  # its counters are in _ticked


_tls = _Thread()


class Span:
    __slots__ = ("name", "t0", "t1", "parent", "run", "attrs", "charged")

    def __init__(self, name, t0, parent, run, attrs):
        self.name = name
        self.t0 = t0
        self.t1 = None  # None while open
        self.parent = parent  # index in spans(), -1 for a root
        self.run = run  # 0 outside a run
        self.attrs = attrs
        self.charged = 0.0  # seconds of timed counters inside it

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.t0}, {self.t1}, "
                f"parent={self.parent}, run={self.run})")


class Counter:
    __slots__ = ("name", "count", "seconds", "cells")

    def __init__(self, name, count=0, seconds=0.0, cells=0):
        self.name = name
        self.count = count
        self.seconds = seconds
        self.cells = cells

    def __repr__(self) -> str:
        return (f"Counter({self.name!r}, count={self.count}, "
                f"seconds={self.seconds}, cells={self.cells})")


def _bump(table: dict, name, seconds, count, cells) -> None:
    k = table.get(name)
    if k is None:
        k = table[name] = Counter(name)
    k.count += count
    k.seconds += seconds
    k.cells += cells


class Counters:
    """The counters of one owner; each ``add`` also goes to the
    process's (``counters()``)."""

    def __init__(self):
        self._c: dict = {}

    def add(self, name: str, seconds: float = 0.0, count: int = 1,
            cells: int = 0, charge: bool = True) -> None:
        """Count ``count`` events of ``seconds`` and ``cells``; with
        ``charge``, a timed counter, charge the seconds to the innermost
        span open on this thread."""
        st = _tls.stack
        with _lock:
            _bump(self._c, name, seconds, count, cells)
            if self is not _process:
                _bump(_process._c, name, seconds, count, cells)
            if charge and st:
                _spans[st[-1]].charged += seconds

    def get(self, name: str) -> Counter:
        """A copy of counter ``name`` (zero where nothing was counted)."""
        with _lock:
            k = self._c.get(name)
            return Counter(name) if k is None else Counter(
                name, k.count, k.seconds, k.cells)

    def snapshot(self) -> dict:
        with _lock:
            return {n: Counter(n, k.count, k.seconds, k.cells)
                    for n, k in self._c.items()}


_process = Counters()
count = _process.add


def tick(name: str, seconds: float) -> None:
    """One timed event of counter ``name`` on this thread: no lock (the
    thread's own part of the counter), charged to its innermost span."""
    loc = _tls
    k = loc.counters.get(name)
    if k is None:
        with _lock:
            if not loc.listed:
                _ticked.append(loc.counters)
                loc.listed = True
            k = loc.counters[name] = Counter(name)
    k.count += 1
    k.seconds += seconds
    st = loc.stack
    if st:
        _spans[st[-1]].charged += seconds


def begin(name: str, attrs: dict | None = None, root: bool = False) -> int:
    """Open a span on this thread; returns its index for ``end``. A
    root starts a run of its own."""
    st = _tls.stack
    t0 = time.perf_counter()
    with _lock:
        parent = -1 if root or not st else st[-1]
        rid = (next(_run_ids) if root
               else _spans[parent].run if parent >= 0 else 0)
        idx = len(_spans)
        _spans.append(Span(name, t0, parent, rid, attrs))
    st.append(idx)
    return idx


def end(idx: int) -> None:
    t1 = time.perf_counter()
    st = _tls.stack
    if st and st[-1] == idx:
        st.pop()
    else:
        st.remove(idx)
    with _lock:
        _spans[idx].t1 = t1


class _Open:
    __slots__ = ("name", "attrs", "idx")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> int:
        self.idx = begin(self.name, self.attrs)
        return self.idx

    def __exit__(self, *exc) -> bool:
        end(self.idx)
        return False


def span(name: str, **attrs):
    """A span around a ``with`` block; nothing where ``on`` is off."""
    return _Open(name, attrs or None) if on else _OFF


def traced(name: str):
    """Decorator: a span ``name`` around every call, where ``on``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            idx = begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                end(idx)
        return wrapper
    return deco


@contextmanager
def run(name: str):
    """The root span of one tba or roast. Reads the switch
    (``MZ_TIME``) into ``on``; yields the root's index, or None where
    the switch is off. ``on`` stays as read after the run, so that the
    caller's rendering of its blocks (``maf.format_ali``) counts too."""
    global on
    on = bool(os.environ.get("MZ_TIME"))
    if not on:
        yield None
        return
    idx = begin(name, root=True)
    try:
        yield idx
    finally:
        end(idx)


def current() -> int | None:
    """The innermost span open on this thread, or None."""
    st = _tls.stack
    return st[-1] if st else None


@contextmanager
def attach(idx: int | None):
    """Spans opened on this thread inside the block take span ``idx``
    (open on another thread) as their parent; nothing where ``idx`` is
    None."""
    if idx is None:
        yield
        return
    st = _tls.stack
    st.append(idx)
    try:
        yield
    finally:
        st.remove(idx)


def spans() -> list:
    """Every span recorded, in the order opened (a parent's index is
    its place in this list)."""
    with _lock:
        return list(_spans)


def counters() -> dict:
    """{name: Counter}, the process's counters: what ``count`` added and
    every thread's ticks."""
    out = _process.snapshot()
    with _lock:
        for table in _ticked:
            for n, k in table.items():
                c = out.setdefault(n, Counter(n))
                c.count += k.count
                c.seconds += k.seconds
    return out


def self_times(recs: list) -> list:
    """Each closed span's self time in ``recs`` (a ``spans()`` list):
    its duration less its closed children's and its timed counters'
    seconds; None for a span still open. Where children ran at once on
    other threads (``tba_run(parallel=N)``'s merges under the root),
    the parent's self time can be negative."""
    child = [0.0] * len(recs)
    for s in recs:
        if s.parent >= 0 and s.t1 is not None:
            child[s.parent] += s.t1 - s.t0
    return [None if s.t1 is None else s.t1 - s.t0 - child[i] - s.charged
            for i, s in enumerate(recs)]


def self_seconds(name: str) -> float:
    """The self time of every closed span ``name``, summed."""
    recs = spans()
    return sum(t for s, t in zip(recs, self_times(recs))
               if s.name == name and t is not None)


def reset() -> None:
    """Forget every span and counter (tests; no span may be open)."""
    with _lock:
        _spans.clear()
        _process._c.clear()
        for table in _ticked:
            table.clear()
    _tls.stack.clear()
