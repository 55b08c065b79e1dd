"""lane_wait_s_per_tba: seconds a tba waits at the end of its merges for
the host lane (the native DP on worker threads behind the stream), as
the stream times it (``MZ_TIME`` ``lane-wait``), over the tbas."""


def read(run):
    if run.hooks is None or not run.ops:
        return None
    return run.hooks.mz_time["lane-wait"] / len(run.ops)
