"""host_plan_s_per_tba: seconds a tba spends outside the DP stream, in
the tree and merge scan's planning on the host (``tree``, ``multiz``,
``preyama``): the tbas' wall less the benchmark's spans around
``PackedDPStream.submit`` and ``.finish``, over the tbas."""


def read(run):
    if run.hooks is None or not run.ops:
        return None
    wall = sum(o.t1 - o.t0 for o in run.ops)
    stream = run.hooks.span_s("stream.submit") + run.hooks.span_s("stream.finish")
    return (wall - stream) / len(run.ops)
