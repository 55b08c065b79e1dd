"""The program's spans and counters over the window's roasts.

``progtrace.py`` reads them over the window's tbas, the root spans
``tba``; a roast's root span is ``roast``, so these readers count those
instead. Each returns None where ``progtrace`` finds nothing to read (an
untraced run, a program without its trace module), where the window
holds no roast, and where the program records none of the spans or
counters named (a program from before they existed).
"""

from __future__ import annotations

from . import progtrace


def _over_roasts(run):
    """(spans, self seconds, indices of the closed spans that start in
    the window, roasts in the window), or None."""
    got = progtrace._recorded(run)
    if got is None:
        return None
    recs, selfs, idx = got
    n = sum(recs[i].name == "roast" and recs[i].parent < 0 for i in idx)
    return (recs, selfs, idx, n) if n else None


def self_s_per_roast(run, names, needs: str):
    """The self time of the window's spans named in ``names``, over the
    roasts; None where no span ``needs`` is in the window."""
    got = _over_roasts(run)
    if got is None:
        return None
    recs, selfs, idx, n = got
    if not any(recs[i].name == needs for i in idx):
        return None
    return sum(selfs[i] for i in idx if recs[i].name in names) / n


def span_s_per_roast(run, name: str):
    """The whole duration of the window's spans ``name`` (their children
    and timed counters included), over the roasts; None where there is
    none."""
    got = _over_roasts(run)
    if got is None:
        return None
    recs, _, idx, n = got
    mine = [recs[i] for i in idx if recs[i].name == name]
    if not mine:
        return None
    return sum(s.t1 - s.t0 for s in mine) / n


def counter_s_per_roast(run, names):
    """The seconds of the counters ``names``, over the roasts; None
    where the program counts none of them."""
    got = _over_roasts(run)
    cs = progtrace.counters(run) if got is not None else None
    if not cs or not any(k in cs for k in names):
        return None
    return sum(cs[k].seconds for k in names if k in cs) / got[3]
