"""The program's own spans and counters, read for a traced run's metrics.

The program (``multiz_tpu_torch/trace.py``) records them in memory where
``MZ_TIME`` is set, and a traced run sets it over its window alone
(``hooks.py``). They are on ``time.perf_counter``, the clock that
``devtrace.parse`` maps the device's timeline onto, so the window's idle
gaps can be laid beside the program's spans (``idle_by_program_span``).

Every reader returns None where the run has no hooks (``--trace 0``) or
the program has no trace module (a checkout from before it), and counts
only spans that start inside the window. The counters are the process's
totals: the program records none outside the window. "Over the tbas" is
over the root spans ``tba`` of the window.
"""

from __future__ import annotations

import importlib


def program_trace():
    """The program's trace module, or None where it has none."""
    try:
        return importlib.import_module("multiz_tpu_torch.trace")
    except ModuleNotFoundError:
        return None


def _recorded(run):
    """(spans, self seconds, indices of the closed spans that start
    inside the window), or None where there is nothing to read."""
    if run.hooks is None:
        return None
    T = program_trace()
    if T is None:
        return None
    recs = T.spans()
    selfs = T.self_times(recs)
    w0, w1 = run.window
    idx = [i for i, s in enumerate(recs)
           if selfs[i] is not None and w0 <= s.t0 < w1]
    return recs, selfs, idx


def _tbas(recs, idx) -> int:
    return sum(recs[i].name == "tba" and recs[i].parent < 0 for i in idx)


def self_s_per_tba(run, names=(), prefix: str | None = None):
    """The self time of the window's spans named in ``names`` (or whose
    name starts with ``prefix``), over the tbas."""
    got = _recorded(run)
    if got is None:
        return None
    recs, selfs, idx = got
    n = _tbas(recs, idx)
    if not n:
        return None
    return sum(selfs[i] for i in idx if recs[i].name in names or (
        prefix is not None and recs[i].name.startswith(prefix))) / n


def counters(run):
    """The program's counters ({name: Counter}), or None."""
    if run.hooks is None:
        return None
    T = program_trace()
    return None if T is None else T.counters()


def counter_s_per_tba(run, names):
    """The seconds of the counters ``names``, over the tbas."""
    got = _recorded(run)
    if got is None:
        return None
    n = _tbas(got[0], got[2])
    if not n:
        return None
    cs = counters(run)
    return sum(cs[k].seconds for k in names if k in cs) / n


def idle_by_program_span(run):
    """The window's device-idle seconds by the innermost program span
    open at that moment (by its name; where spans of several threads
    overlap, the deepest, then the latest started), as (label, seconds)
    pairs, largest first. Idle time outside every program span is
    ``op.outside_program`` inside an operation (for a tba, the entry's
    rendering of its blocks) and ``between`` operations. None without a
    device trace or the program's spans."""
    if run.trace is None:
        return None
    got = _recorded(run)
    if got is None:
        return None
    recs, _, idx = got
    w0, w1 = run.window
    depth = [0] * len(recs)
    for i, s in enumerate(recs):  # a parent opens before its children
        depth[i] = depth[s.parent] + 1 if s.parent >= 0 else 0
    events = []  # (time, 0 = end / 1 = start, span)
    for i in idx:
        a, b = recs[i].t0, min(recs[i].t1, w1)
        if b > a:
            events += [(a, 1, i), (b, 0, i)]
    events.sort()
    ops = sorted((max(o.t0, w0), min(o.t1, w1)) for o in run.ops
                 if o.t1 > w0 and o.t0 < w1)
    bounds = sorted({w0, w1, *(e[0] for e in events),
                     *(t for o in ops for t in o)})
    gaps = run.trace.gaps()
    out: dict = {}
    active: set = set()
    ei = gi = oi = 0
    for a, b in zip(bounds, bounds[1:]):
        while ei < len(events) and events[ei][0] <= a:
            _, start, i = events[ei]
            (active.add if start else active.discard)(i)
            ei += 1
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        idle, k = 0.0, gi
        while k < len(gaps) and gaps[k][0] < b:
            idle += min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
        if idle <= 0.0:
            continue
        if active:
            label = recs[max(active,
                             key=lambda i: (depth[i], recs[i].t0))].name
        else:
            while oi < len(ops) and ops[oi][1] <= a:
                oi += 1
            inside = oi < len(ops) and ops[oi][0] <= a
            label = "op.outside_program" if inside else "between"
        out[label] = out.get(label, 0.0) + idle
    return sorted(out.items(), key=lambda kv: -kv[1])
