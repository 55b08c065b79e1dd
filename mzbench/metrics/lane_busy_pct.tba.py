"""lane_busy_pct.tba: 100 x the seconds the host lane's workers spent in
the native DP (the program's counter ``lane.busy``) over the workers'
time in the window (``yama_pack.host_lane_threads()`` x the window)."""

from mzbench.progtrace import counters


def read(run):
    cs = counters(run)
    threads = getattr(run.hooks.P, "host_lane_threads", None) if cs else None
    if threads is None or not threads():
        return None
    c = cs.get("lane.busy")
    busy = c.seconds if c is not None else 0.0
    w0, w1 = run.window
    return 100.0 * busy / (threads() * (w1 - w0))
