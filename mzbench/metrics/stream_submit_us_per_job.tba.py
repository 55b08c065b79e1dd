"""stream_submit_us_per_job.tba: microseconds a DP job takes in
``PackedDPStream.submit`` (routing, the host lane's hand-off, bucketing,
the launches it sets off), as the stream times it: the program's timed
counter ``stream.submit``, its seconds over its jobs."""

from mzbench.progtrace import counters


def read(run):
    cs = counters(run)
    c = cs.get("stream.submit") if cs else None
    if c is None or not c.count:
        return None
    return c.seconds / c.count * 1e6
